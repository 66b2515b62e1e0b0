"""Kernels: decode attention's least time over its device time in the
profiled slice. The least time counts, per call (one a layer and a step),
what the emitted tokens' steps needed: q and the output once, and every
row each request attends to once at its stored precision."""

from bench.harness import work


def read(rec):
    sl = rec.slice
    if sl is None or not sl.decode_items:
        return None
    t = sl.seconds_of(rec.kernel_names("decode_attn_roofline"))
    if t <= 0:
        return None
    return 100.0 * work.decode_bound_s(rec.shape, sl.decode_items) / t
