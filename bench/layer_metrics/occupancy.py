"""Scheduler: mean share of the slots holding a request, per decode step,
over the window's batches (the engine's own occupancy, weighted by each
batch's decode steps)."""


def read(rec):
    steps = sum(b.result.decode_steps for b in rec.batches)
    if not steps:
        return None
    return 100.0 * sum(b.result.occupancy * b.result.decode_steps
                       for b in rec.batches) / steps
