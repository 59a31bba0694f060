"""CPU tests of the benchmark harness (small sizes, no card)."""
