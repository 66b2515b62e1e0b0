"""Model configurations (the two attention-only decoders of the main path)."""
