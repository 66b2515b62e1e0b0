"""Serving: samplers, request scheduler, continuous-batching engine."""
