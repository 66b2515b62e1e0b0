"""Fused dequantize-and-attend decode kernel over [main store | residual ring]."""
