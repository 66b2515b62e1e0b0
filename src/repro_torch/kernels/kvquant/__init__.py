"""Plain dequantization helpers for the KIVI packed layout."""
