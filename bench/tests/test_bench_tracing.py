"""The readers of the program's own spans and counters, on hand-made
records: the decode step's dispatch and token-wait seconds, the queue
wait's tail, the device idle time under the dispatch, and chunked
prefill's roofline. Each reads None from a program that lacks what it
reads, and the tiny cell's traced run on the CPU gives each a value."""
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

from bench.harness import core, spec, work
from bench.harness.profile import Slice

SHAPE = work.Shape(layers=64, d_model=5120, heads=40, kv_heads=8,
                   head_dim=128, d_ff=27648, vocab=152064, budget=1024,
                   window=128, bits=2)


def _record(batches=(), sl=None, cell=None):
    return core.Record("cell", cell or {"engine": {}, "slots": 4}, SHAPE,
                       list(batches), 1.0, sl)


def _batch(steps, dispatch=None, wait=None, waits=()):
    res = SimpleNamespace(decode_steps=steps, results=[
        SimpleNamespace(queue_s=q, finish_reason="length") for q in waits])
    if dispatch is not None:
        res.dispatch_seconds = dispatch
    if wait is not None:
        res.token_wait_seconds = wait
    return core.Batch(0.0, [], res)


def test_dispatch_and_token_wait_per_step():
    rec = _record([_batch(100, 6.0, 0.5), _batch(300, 18.0, 1.5)])
    assert spec.layer_reader("dispatch_ms_per_step")(rec) == \
        pytest.approx(60.0)
    assert spec.layer_reader("token_wait_ms_per_step")(rec) == \
        pytest.approx(5.0)
    # a program without the counters, or a window with no decode step
    for bad in ([_batch(100)], [_batch(0, 0.0, 0.0)]):
        for name in ("dispatch_ms_per_step", "token_wait_ms_per_step"):
            assert spec.layer_reader(name)(_record(bad)) is None


def test_queue_wait_tail():
    rec = _record([_batch(1, waits=[0.1 * i for i in range(10)]),
                   _batch(1, waits=[0.1 * i for i in range(10, 20)])])
    # 20 waits 0.0 .. 1.9: the 18th is 1.7
    assert spec.layer_reader("queue_wait_p90_s")(rec) == pytest.approx(1.7)
    assert spec.layer_reader("queue_wait_p90_s.host")(rec) == \
        pytest.approx(1.7)
    # failed requests never got a first token: +inf, as the tails count
    for r in rec.batches[1].result.results[-3:]:
        r.finish_reason = "failed"
    assert spec.layer_reader("queue_wait_p90_s")(rec) == math.inf
    parent = _record([_batch(1, waits=[0.5])])
    del parent.batches[0].result.results[0].queue_s
    assert spec.layer_reader("queue_wait_p90_s")(parent) is None
    assert spec.layer_reader("queue_wait_p90_s")(_record([_batch(1)])) \
        is None


def _slice(ops, spans, t0=10.0, wall=1.0):
    return Slice(t0=t0, wall_s=wall, ops=[("k", t0 + a, t0 + b)
                                          for a, b in ops],
                 spans=[(n, t0 + a, t0 + b, args) for n, a, b, args in spans])


def test_idle_under_dispatch():
    read = spec.layer_reader("idle_under_dispatch")
    # device busy [0, .2] and [.5, .6], overlapping ops merged: idle
    # [.2, .5] and [.6, 1] (0.7 s). `decode` spans [.1, .4] and [.55, .7]
    # hold idle .2-.4 and .6-.7 (0.3 s); the `step` span holds it all
    sl = _slice([(0.0, 0.2), (0.1, 0.15), (0.5, 0.6)],
                [("step", 0.0, 1.0, {}), ("decode", 0.1, 0.4, {}),
                 ("decode", 0.55, 0.7, {}), ("attend", 0.2, 0.3, {})])
    assert read(_record(sl=sl)) == pytest.approx(100.0 * 0.3 / 0.7)
    # a span past the slice's edge counts only inside it
    sl = _slice([(0.0, 0.5)], [("decode", 0.8, 1.5, {}),
                               ("decode", -0.5, 0.1, {})])
    assert read(_record(sl=sl)) == pytest.approx(100.0 * 0.2 / 0.5)
    # idle time wholly outside the dispatch
    sl = _slice([(0.0, 0.5)], [("decode", 0.1, 0.4, {})])
    assert read(_record(sl=sl)) == 0.0
    # no decode span (a parent program), no idle time, no slice
    assert read(_record(sl=_slice([(0.0, 0.5)],
                                  [("step", 0.0, 1.0, {})]))) is None
    assert read(_record(sl=_slice([(0.0, 1.0)],
                                  [("decode", 0.1, 0.4, {})]))) is None
    assert read(_record()) is None


def test_chunk_roofline_counts_whole_segments_inside_the_slice():
    read = spec.layer_reader("chunk_attn_roofline")
    assert spec.kernel_names("chunk_attn_roofline")
    seg = [("prefill_segment", 0.1, 0.2, dict(uid=1, c0=0, c1=512)),
           ("prefill_segment", 0.3, 0.4, dict(uid=1, c0=512, c1=1024)),
           # straddles the slice's end: left out
           ("prefill_segment", 0.9, 1.2, dict(uid=2, c0=0, c1=512))]
    sl = Slice(t0=0.0, wall_s=1.0, spans=seg, ops=[
        ("flash_prefill_mma_kernel<...>", 0.1, 0.101),
        ("flash_prefill_mma_kernel<...>", 0.3, 0.302),
        ("decode_attn_kernel", 0.5, 0.6)])
    H, Hk, D = 40, 8, 128
    # rows [0, 512) and [512, 1024) against keys [0, c1), per layer
    f0 = 4.0 * H * D * 512 * 513 / 2
    f1 = 4.0 * H * D * (1024 * 1025 - 512 * 513) / 2
    b0 = (2 * H * 512 + 2 * Hk * 512) * D * 2.0
    b1 = (2 * H * 512 + 2 * Hk * 1024) * D * 2.0
    least = 64 * (work.bound_s(f0, b0) + work.bound_s(f1, b1))
    assert read(_record(sl=sl)) == pytest.approx(100.0 * least / 0.003)
    # segment 0 alone equals a monolithic prefill of 512 rows
    assert work.bound_s(f0, b0) == pytest.approx(
        work.prefill_bound_s(SHAPE, [512]) / 64)
    # no segment inside, no matching kernel time
    sl.spans = seg[2:]
    assert read(_record(sl=sl)) is None
    sl.spans, sl.ops = seg, [("decode_attn_kernel", 0.5, 0.6)]
    assert read(_record(sl=sl)) is None
    assert read(_record()) is None


def test_traced_tiny_run_reads_every_new_metric(tiny):
    """The tiny cell, paged with chunked admission, traced on the CPU: the
    program's spans and counters reach the new readers. (Values from a CPU
    run are not device numbers; only their presence is checked. The CPU
    profiler records no kernel, so the roofline reads None here.)"""
    cell, config, tr, bench = tiny
    cell["engine"] = dict(paged=True, chunked_prefill=True, chunk_len=16)
    cell["profile"] = {"start_step": 1, "steps": 12}
    names = ["dispatch_ms_per_step", "token_wait_ms_per_step",
             "queue_wait_p90_s", "idle_under_dispatch",
             "chunk_attn_roofline"]
    bench["per_layer"] = [{"name": n, "unit": "-"} for n in names]
    out = core.run("tiny", cell, config, tr, seed=2 ** 33 + 5, seconds=0.0,
                   trace=True, device="cpu", t_start=time.perf_counter(),
                   bench=bench, log=lambda s: None)
    assert out["correct"] is True
    assert sorted(out["metrics"]) == sorted(names[:4])
    assert all(np.isfinite(m["value"]) for m in out["metrics"].values())
    assert out["metrics"]["dispatch_ms_per_step"]["value"] > 0
