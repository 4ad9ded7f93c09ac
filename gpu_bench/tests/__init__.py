"""Tests of the benchmark (CPU, small sizes; ``chip`` tests on the card)."""
