"""Scheduler, where the host sets the pace: ``queue_wait_p90_s`` read in
the cells whose tails are per-layer (there it moves their throughput)."""
from bench.harness import spec

read = spec.layer_reader("queue_wait_p90_s")
