"""Benchmark evaluation: the depth 10-metric harness (five tar datasets,
least-squares alignment) and the DSINE-style surface-normal harness (pooled
angular errors)."""
