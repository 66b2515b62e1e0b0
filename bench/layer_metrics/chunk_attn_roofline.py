"""Kernels: chunked prefill attention's (B4's) least time over its device
time, for the ``prefill_segment`` spans wholly inside the profiled slice.
A segment [c0, c1) costs, per layer, the offset-causal FLOPs of its rows
against keys [0, c1) and q, k, v and the output once; each layer's call is
bounded on its own (`work.prefill_bound_s`'s convention)."""

from bench.harness import work


def segment_attn(shape, c0: int, c1: int):
    """(FLOPs, bytes) of one layer's attention for rows [c0, c1) of a
    prompt, row r seeing keys [0, r]: q and the output for the segment's
    rows, k and v for every key up to c1, once each."""
    H, Hk, D = shape.heads, shape.kv_heads, shape.head_dim
    flops = 4.0 * H * D * (c1 * (c1 + 1) - c0 * (c0 + 1)) / 2
    nbytes = (2 * H * (c1 - c0) + 2 * Hk * c1) * D * 2.0
    return flops, nbytes


def read(rec):
    sl = rec.slice
    if sl is None:
        return None
    t1 = sl.t0 + sl.wall_s
    segs = [(a["c0"], a["c1"]) for n, s0, s1, a in sl.spans
            if n == "prefill_segment" and s0 >= sl.t0 and s1 <= t1]
    if not segs:
        return None
    t = sl.seconds_of(rec.kernel_names("chunk_attn_roofline"))
    if t <= 0:
        return None
    least = rec.shape.layers * sum(
        work.bound_s(*segment_attn(rec.shape, c0, c1)) for c0, c1 in segs)
    return 100.0 * least / t
