"""Kernels: monolithic prefill attention's least time (causal FLOPs; q, k,
v and the output once) over its device time, for the admissions whose
prefill span lies inside the profiled slice."""

from bench.harness import work


def read(rec):
    sl = rec.slice
    if (sl is None or not sl.prefill_lens
            or rec.cell["engine"].get("chunked_prefill")):
        return None
    t = sl.seconds_of(rec.kernel_names("prefill_attn_roofline"))
    if t <= 0:
        return None
    return 100.0 * work.prefill_bound_s(rec.shape, sl.prefill_lens) / t
