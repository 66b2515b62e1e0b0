"""The benchmark's harness: data loading, traffic, weights, the window,
the profiled slice, the yardstick and the check."""
