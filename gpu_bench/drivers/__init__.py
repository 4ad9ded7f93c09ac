"""One loop driver per kind of traffic (``traffic/<mix>.json`` names it)."""
