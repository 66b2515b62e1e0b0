"""Stdlib-only tracing for the serving loops."""
