"""Each configuration's FLOP count, beside its JSON file."""
