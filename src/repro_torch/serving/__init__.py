"""Serving: greedy sampler, request scheduler, continuous-batching engine."""
