"""Fused KIVI quantize-and-pack (CUDA) with its plain versions and the
dequantization helpers of the KIVI packed layout."""
