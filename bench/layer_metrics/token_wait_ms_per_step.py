"""Engine loop: host milliseconds per decode step blocked in the engine's
``token_wait`` spans (the pipelined token reads), over the window's
unprofiled batches. None for a program that does not report them."""


def read(rec):
    steps = sum(b.result.decode_steps for b in rec.batches)
    secs = [getattr(b.result, "token_wait_seconds", None)
            for b in rec.batches]
    if not steps or None in secs:
        return None
    return 1e3 * sum(secs) / steps
