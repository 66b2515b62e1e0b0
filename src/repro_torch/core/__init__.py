"""Cache data structures, quantization, compression policies, layer budgets."""
