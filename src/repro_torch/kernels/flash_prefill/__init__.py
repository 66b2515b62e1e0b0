"""Causal flash prefill kernel."""
