"""Engine loop: host milliseconds per decode step over the window (the
engine's decode seconds, admissions taken out, over its decode steps)."""


def read(rec):
    steps = sum(b.result.decode_steps for b in rec.batches)
    if not steps:
        return None
    return 1e3 * sum(b.result.decode_seconds for b in rec.batches) / steps
