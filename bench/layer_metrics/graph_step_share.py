"""Model step: share of the decode steps, over the window's unprofiled
batches, that replayed a CUDA graph of the step instead of dispatching
it op by op (the engine's ``graph_steps``), in %. None for a program
that does not report it."""


def read(rec):
    steps = sum(b.result.decode_steps for b in rec.batches)
    graphed = [getattr(b.result, "graph_steps", None) for b in rec.batches]
    if not steps or None in graphed:
        return None
    return 100.0 * sum(graphed) / steps
