"""Layers, attention, blocks and the decoder-only LM."""
