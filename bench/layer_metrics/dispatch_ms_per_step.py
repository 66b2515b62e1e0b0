"""Model step: host milliseconds per decode step spent in the engine's
``decode`` spans (the model's dispatch and the sample), over the window's
unprofiled batches. None for a program that does not report them."""


def read(rec):
    steps = sum(b.result.decode_steps for b in rec.batches)
    secs = [getattr(b.result, "dispatch_seconds", None) for b in rec.batches]
    if not steps or None in secs:
        return None
    return 1e3 * sum(secs) / steps
