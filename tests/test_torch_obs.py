"""The port's telemetry (`repro_torch.obs`) against the JAX package's
(`repro.obs`) on the CPU.

  * every unit case of tests/test_obs.py (ring drops, validation, the
    `Span` seam on the null tracer, the Chrome schema, the registry and
    its snapshot, histogram bounds, `write_metrics_json`, the null
    objects), run on both packages' classes;
  * telemetry is invisible to decoding: in both packages trace-on greedy
    streams equal trace-off ones bit for bit, dense and paged, `full`
    and kivi2, plain and speculative (the cases of tests/test_obs.py;
    reduced paper-llama-7b, 2 layers, f32, the same weights through
    `repro_torch.bridge`);
  * one forced-preemption + tiering schedule (kivi2, paged, preemptions
    at dispatch (3, 0) and (5, 1), periodic audits), both schedulers on
    one tick clock: the lifecycle and ladder events (submit, admit,
    first_token, preempt, spill, fetch, restore, request, audit) are the
    JAX engine's, in order, compared as (name, lane, arguments), the
    fetch's host-timed stall left out; the metrics snapshot's counters
    and histogram counts are the JAX engine's; `max_inter_token_s` is
    the JAX result's on every request; and the exported trace shows
    spill <= preempt <= restore <= fetch.
"""
import functools
import itertools
import json
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import numpy as np

import repro.obs as jax_obs
import repro_torch.obs as port_obs
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.obs import metrics as port_metrics
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, Scheduler

OBS = {"jax": jax_obs, "port": port_obs}
PKGS = list(OBS)

# ---------------------------------------------------------------------------
# Tracer units: ring bounds, span seam, Chrome export schema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_drops_oldest_and_counts(pkg):
    tr = OBS[pkg].Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4 and tr.dropped == 6
    assert [e[1] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.to_chrome()["otherData"]["dropped_events"] == 6


@pytest.mark.parametrize("pkg", PKGS)
def test_tracer_validation(pkg):
    with pytest.raises(ValueError):
        OBS[pkg].Tracer(0)


@pytest.mark.parametrize("pkg", PKGS)
def test_span_times_even_on_null_tracer(pkg):
    nt = OBS[pkg].NullTracer()
    with nt.span("phase") as sp:
        time.sleep(0.002)
    assert sp.elapsed >= 0.002
    assert not nt and len(nt) == 0 and nt.events() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_span_emits_complete_event(pkg):
    tr = OBS[pkg].Tracer()
    with tr.span("prefill", tid=3, args=dict(uid=7)) as sp:
        pass
    (ph, name, tid, ts, dur, args), = tr.events()
    assert ph == "X" and name == "prefill" and tid == 3
    assert args == dict(uid=7)
    assert ts == sp.t0 and abs(dur - sp.elapsed) < 1e-9


@pytest.mark.parametrize("pkg", PKGS)
def test_chrome_export_schema(pkg, tmp_path):
    tr = OBS[pkg].Tracer(pid=7, process_name="obs-test")
    tr.instant("tick", tid=2, args=dict(a=1))
    tr.complete("phase", tr.now())
    tr.counter("pool", dict(free=3, active=1))
    path = tr.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    data = [e for e in evs if e["ph"] != "M"]
    named = {(m["name"], m["tid"]): m["args"] for m in meta}
    assert named[("process_name", 0)]["name"] == "obs-test"
    assert named[("thread_name", 0)]["name"] == "engine"
    assert named[("thread_name", 2)]["name"] == "slot 1"
    assert named[("thread_sort_index", 2)]["sort_index"] == 2
    assert [e["ph"] for e in data] == ["i", "X", "C"]
    for e in data:
        assert e["pid"] == 7 and isinstance(e["tid"], int)
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
    inst, comp, ctr = data
    assert inst["s"] == "t" and inst["args"] == dict(a=1)
    assert comp["dur"] >= 0
    assert ctr["args"] == dict(free=3, active=1)


# ---------------------------------------------------------------------------
# Metrics units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_registry_and_snapshot(pkg):
    mx = OBS[pkg].Metrics()
    mx.counter("a").inc()
    mx.counter("a").inc(2)              # get-or-create: same instrument
    mx.gauge("b").set(0.5)
    h = mx.histogram("h", bounds=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = mx.snapshot()
    assert list(snap) == sorted(snap)
    assert snap["a"] == 3 and snap["b"] == 0.5
    hs = snap["h"]
    assert hs["count"] == 3 and hs["min"] == 0.05 and hs["max"] == 5.0
    assert hs["buckets"] == [[0.1, 1], [1.0, 1], ["inf", 1]]
    with pytest.raises(TypeError):      # no silent type shadowing
        mx.gauge("a")


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_bounds_must_ascend(pkg):
    with pytest.raises(ValueError):
        OBS[pkg].Metrics().histogram("h", bounds=(1.0, 0.5))


def test_histogram_defaults_and_schema_match_jax():
    """One layout for either package's --metrics-json: the schema string
    and the default bucket bounds are the JAX module's."""
    from repro.obs import metrics as jax_metrics
    assert port_metrics.SCHEMA == jax_metrics.SCHEMA
    assert port_metrics._DEFAULT_BOUNDS == jax_metrics._DEFAULT_BOUNDS
    assert (port_obs.Metrics().histogram("h").bounds
            == jax_obs.Metrics().histogram("h").bounds)


@pytest.mark.parametrize("pkg", PKGS)
def test_write_metrics_json(pkg, tmp_path):
    mx = OBS[pkg].Metrics()
    mx.counter("x").inc(4)
    p = tmp_path / "m.json"
    payload = OBS[pkg].write_metrics_json(mx, str(p), extra={"run": "t"})
    doc = json.loads(p.read_text())
    assert doc == payload
    assert doc["schema"] == "repro.obs.metrics/1"
    assert doc["metrics"]["x"] == 4 and doc["run"] == "t"


@pytest.mark.parametrize("pkg", PKGS)
def test_null_objects_are_falsy_noops(pkg):
    o = OBS[pkg]
    assert not o.NullTracer() and not o.NullMetrics() and not o.NULL_TRACER
    nm = o.NullMetrics()
    nm.counter("c").inc()
    nm.gauge("g").set(1.0)
    nm.histogram("h").observe(2.0)
    assert nm.snapshot() == {} and len(nm) == 0


# ---------------------------------------------------------------------------
# End to end: telemetry is invisible to decoding, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _requests(R, vocab, n, seed=0, size=32, max_new=10):
    rng = np.random.default_rng(seed)
    return [R(tokens=rng.integers(0, vocab, size=size).astype(np.int32),
              max_new=max_new) for _ in range(n)]


def _tokens(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


def _engine(pkg, model, pname, **kw):
    jcfg, jp, cfg, p = model
    if pkg == "jax":
        return JaxEngine(jcfg, jp, jax_presets(budget=32, window=8)[pname],
                         **kw)
    return Engine(cfg, p, presets(budget=32, window=8)[pname], device="cpu",
                  **kw)


def _run(pkg, eng, n=3):
    R = JaxRequest if pkg == "jax" else Request
    return eng.generate_continuous(_requests(R, eng.cfg.vocab_size, n,
                                             seed=1))


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("pname,paged", [
    ("full", False), ("full", True), ("kivi2", False), ("kivi2", True),
])
def test_trace_on_streams_bit_identical(small_model, pkg, pname, paged):
    kw = dict(prompt_len=32, max_new=10, slots=2, buckets=(32,), seed=0)
    if paged:
        kw.update(paged=True, block_len=8)
    off = _run(pkg, _engine(pkg, small_model, pname, **kw))
    tr, mx = OBS[pkg].Tracer(), OBS[pkg].Metrics()
    on = _run(pkg, _engine(pkg, small_model, pname, tracer=tr, metrics=mx,
                           **kw))
    assert _tokens(on) == _tokens(off)
    names = {e[1] for e in tr.events()}
    assert {"submit", "admit", "first_token", "prefill", "step",
            "request"} <= names
    assert mx.counter("engine.loop_iters").value > 0
    assert mx.histogram("request.ttft_s").count == 3
    snap = mx.snapshot()
    assert snap["requests.completed"] == 3 and snap["requests.failed"] == 0
    assert snap["engine.decode_steps"] == on.decode_steps
    if paged:
        assert "pool" in names          # per-iteration counter track
        assert 0.0 <= snap["pool.free_frac"] <= 1.0


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("pname,paged", [("full", False), ("kivi2", True)])
def test_trace_on_speculative_streams_bit_identical(small_model, pkg, pname,
                                                    paged):
    kw = dict(prompt_len=32, max_new=10, slots=2, buckets=(32,), seed=0,
              block_len=8, speculative=True, gamma=3, draft_policy="same")
    if paged:
        kw.update(paged=True)
    off = _run(pkg, _engine(pkg, small_model, pname, **kw))
    tr, mx = OBS[pkg].Tracer(), OBS[pkg].Metrics()
    on = _run(pkg, _engine(pkg, small_model, pname, tracer=tr, metrics=mx,
                           **kw))
    assert _tokens(on) == _tokens(off)
    names = {e[1] for e in tr.events()}
    assert {"submit", "round", "draft_prefill", "request"} <= names
    assert mx.counter("spec.rounds").value == on.spec.rounds > 0
    assert mx.gauge("spec.accept_rate").value > 0.0


def test_wave_spans_and_cli(small_model, tmp_path):
    """The wave path's `wave_prefill` / `wave_decode` spans, and the CLI's
    --trace / --metrics-json on the CPU: a Chrome trace that loads as
    JSON and a snapshot in the JAX package's schema."""
    tr = port_obs.Tracer()
    jcfg, jp, cfg, p = small_model
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 32))
    Engine(cfg, p, presets(32, 8)["h2o"], prompt_len=32, max_new=4, slots=2,
           device="cpu", tracer=tr).generate(prompts)
    waves = [e for e in tr.events() if e[1].startswith("wave_")]
    assert [(e[1], e[5]["wave"]) for e in waves] == [
        ("wave_prefill", 0), ("wave_decode", 0), ("wave_prefill", 1),
        ("wave_decode", 1)]
    from repro_torch.launch import serve
    t, m = tmp_path / "t.json", tmp_path / "m.json"
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "keyformer",
                "--budget", "16", "--window", "8", "--requests", "3",
                "--prompt-len", "32", "--max-new", "4", "--slots", "2",
                "--continuous", "--paged", "--device", "cpu",
                "--trace", str(t), "--metrics-json", str(m)])
    doc = json.loads(t.read_text())
    assert {"step", "prefill", "request"} <= {e["name"]
                                              for e in doc["traceEvents"]}
    snap = json.loads(m.read_text())
    assert snap["schema"] == "repro.obs.metrics/1"
    assert snap["metrics"]["requests.completed"] == 3


# ---------------------------------------------------------------------------
# One preemption + tiering schedule: the JAX engine's events and metrics
# ---------------------------------------------------------------------------

LADDER_EVENTS = {"submit", "admit", "first_token", "preempt", "spill",
                 "fetch", "restore", "request", "audit"}
TIMING_ARGS = {"stall_ms"}      # host-timed: differs run to run


@pytest.fixture(scope="module")
def ladder_runs(small_model):
    """The schedule of tests/test_obs.py's causal-order case (kivi2,
    paged, tiering, preemptions at dispatch (3, 0) and (5, 1)) with
    audits every 2 dispatches, in both packages, each scheduler on its
    own tick clock (1 ms a call), so latencies are functions of the call
    sequence alone."""
    out = {}
    for pkg, sched_cls in (("jax", JaxScheduler), ("port", Scheduler)):
        tick = itertools.count()
        orig = sched_cls.__init__
        sched_cls.__init__ = functools.partialmethod(
            orig, clock=lambda: next(tick) * 1e-3)
        try:
            tr, mx = OBS[pkg].Tracer(), OBS[pkg].Metrics()
            eng = _engine(pkg, small_model, "kivi2", prompt_len=32,
                          max_new=10, slots=2, buckets=(32,), seed=0,
                          paged=True, block_len=8,
                          preempt_at=((3, 0), (5, 1)), tiering=True,
                          audit_every=2, tracer=tr, metrics=mx)
            res = _run(pkg, eng)
        finally:
            sched_cls.__init__ = orig
        out[pkg] = (tr, mx, res)
    return out


def _ladder(tr, res):
    """(name, lane, arguments) of the ladder events, in order; request
    uids counted from the run's first (each package numbers requests
    from a process-wide counter)."""
    uid0 = min(r.uid for r in res.results)
    out = []
    for ph, name, tid, ts, dur, args in tr.events():
        if name in LADDER_EVENTS:
            args = {k: (v - uid0 if k == "uid" else v)
                    for k, v in (args or {}).items() if k not in TIMING_ARGS}
            out.append((name, tid, args))
    return out


def test_ladder_events_equal_jax(ladder_runs):
    (jtr, _, jres), (ttr, _, tres) = ladder_runs["jax"], ladder_runs["port"]
    assert _tokens(tres) == _tokens(jres)
    want, got = _ladder(jtr, jres), _ladder(ttr, tres)
    names = {e[0] for e in want}
    assert names == LADDER_EVENTS, names          # every kind occurred
    assert got == want
    assert tres.tier["n_spills"] >= 1 and tres.tier["n_fetches"] >= 1


def test_ladder_metrics_equal_jax(ladder_runs):
    """Counters and histogram counts of the two snapshots are equal;
    gauges of seconds and rates are host-timed and only present."""
    jsnap = ladder_runs["jax"][1].snapshot()
    tsnap = ladder_runs["port"][1].snapshot()
    assert sorted(tsnap) == sorted(jsnap)
    counters = [n for n, v in jsnap.items() if isinstance(v, int)]
    assert {"engine.decode_steps", "engine.loop_iters", "sched.preemptions",
            "tier.spills", "tier.fetches", "tier.bytes_moved",
            "requests.completed"} <= set(counters)
    for name in counters:
        assert tsnap[name] == jsnap[name], name
    for name in ("request.ttft_s", "request.inter_token_s"):
        assert tsnap[name]["count"] == jsnap[name]["count"], name
        assert tsnap[name]["buckets"] == jsnap[name]["buckets"], name
    res = ladder_runs["port"][2]
    assert tsnap["sched.preemptions"] == 2
    assert tsnap["tier.spills"] == res.tier["n_spills"]
    assert tsnap["tier.fetches"] == res.tier["n_fetches"]


def test_max_inter_token_equals_jax(ladder_runs):
    jres, tres = ladder_runs["jax"][2], ladder_runs["port"][2]
    for j, t in zip(sorted(jres.results, key=lambda r: r.uid),
                    sorted(tres.results, key=lambda r: r.uid)):
        np.testing.assert_array_equal(t.token_times, j.token_times)
        assert t.max_inter_token_s() == j.max_inter_token_s()
        mid = float(np.median(t.token_times))
        assert t.max_inter_token_s(mid) == j.max_inter_token_s(mid)
        assert t.max_inter_token_s(t1=mid) == j.max_inter_token_s(t1=mid)
    assert max(r.max_inter_token_s() for r in tres.results) > 0


def test_preemption_tiering_trace_causal_order(small_model, tmp_path):
    """The port's exported trace of the same schedule on the real clock:
    preempt-to-host snapshots the victim's blocks before the scheduler
    releases its ids, and the ticketed continuation fetches them back
    inside its restore span."""
    tr = port_obs.Tracer()
    eng = _engine("port", small_model, "kivi2", prompt_len=32, max_new=10,
                  slots=2, buckets=(32,), paged=True, block_len=8,
                  preempt_at=((3, 0), (5, 1)), tiering=True, tracer=tr)
    res = _run("port", eng)
    assert res.tier["n_spills"] >= 1 and res.tier["n_fetches"] >= 1
    with open(tr.export(str(tmp_path / "trace.json"))) as f:
        doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]

    def first_ts(name, ph):
        hits = [e["ts"] for e in evs if e["name"] == name and e["ph"] == ph]
        assert hits, f"no {name!r}/{ph} events in the exported trace"
        return min(hits)

    assert (first_ts("spill", "i") <= first_ts("preempt", "i")
            <= first_ts("restore", "X") <= first_ts("fetch", "i"))
    assert first_ts("request", "X") >= 0


# ---------------------------------------------------------------------------
# The decode loop's own spans, the model step's ranges, chunked admission by
# phase, queue wait (the port only)
# ---------------------------------------------------------------------------

LOOP_CASES = {
    "dense-monolithic": dict(),
    "paged-chunked": dict(paged=True, block_len=8, chunked_prefill=True,
                          chunk_len=8),
}
LAYER_RANGES = ("attn", "kv", "attend", "mlp")


def _loop_run(model, case, tracer=None):
    kw = dict(prompt_len=32, max_new=10, slots=2, buckets=(32,), seed=0,
              **LOOP_CASES[case])
    eng = _engine("port", model, "kivi2", tracer=tracer,
                  metrics=port_obs.Metrics() if tracer else None, **kw)
    return eng, _run("port", eng)


def _spans(tr, name):
    return [(ts, ts + dur, args or {}) for ph, n, tid, ts, dur, args
            in tr.events() if ph == "X" and n == name]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def loop_runs(small_model):
    out = {}
    for case in LOOP_CASES:
        tr = port_obs.Tracer(capacity=1 << 20)
        eng, on = _loop_run(small_model, case, tr)
        _, off = _loop_run(small_model, case)
        out[case] = (tr, eng, on, off)
    return out


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_decode_loop_spans_each_iteration(loop_runs, case):
    """`decode`, `token_wait` and `retire` each iteration; the `step` span
    still one a loop iteration, ending after the dispatch and before the
    pipelined token read; tokens as with tracing off."""
    tr, eng, on, off = loop_runs[case]
    assert _tokens(on) == _tokens(off)
    n = on.decode_steps
    steps, decodes = _spans(tr, "step"), _spans(tr, "decode")
    waits, retires = _spans(tr, "token_wait"), _spans(tr, "retire")
    assert n > 0 and len(decodes) == len(retires) == n
    assert len(steps) == eng.metrics.counter("engine.loop_iters").value
    # every dispatch inside its iteration's step span; the step's read and
    # its retire bookkeeping after the step span, in that order
    assert all(any(_inside(d, s) for s in steps) for d in decodes)
    outside = [w for w in waits if not any(_inside(w, s) for s in steps)]
    assert len(outside) == n
    ends = sorted(s[1] for s in steps)
    for w, r in zip(sorted(outside), sorted(retires)):
        assert w[1] <= r[0]
        assert any(e <= w[0] for e in ends)
        assert not any(s[0] < r[1] and r[0] < s[1] for s in steps)
    if case == "paged-chunked":
        # each chunk-admitted first token is read behind the next dispatch
        assert len(waits) == n + len(on.results)
    else:
        assert len(waits) == n
        # a refill's monolithic prefill nests in the retire bookkeeping
        later = [p for p in _spans(tr, "prefill") if p[0] > decodes[0][0]]
        assert later and all(any(_inside(p, r) for r in retires)
                             for p in later)


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_model_ranges_per_layer(loop_runs, case):
    """Inside each `decode`: `attn` ⊃ `kv` ⊃ `attend` and `mlp` once per
    layer, `logits` and `sample` once."""
    tr, eng, on, _ = loop_runs[case]
    L = eng.cfg.num_layers
    ranges = {k: _spans(tr, k) for k in LAYER_RANGES + ("logits", "sample")}
    for d in _spans(tr, "decode"):
        got = {k: [r for r in v if _inside(r, d)] for k, v in ranges.items()}
        assert {k: len(v) for k, v in got.items()} == dict(
            attn=L, kv=L, attend=L, mlp=L, logits=1, sample=1)
        for a, k, t in zip(got["attn"], got["kv"], got["attend"]):
            assert _inside(k, a) and _inside(t, k)
    # outside a traced dispatch the model step opens no range
    assert sum(len(v) for v in ranges.values()) == on.decode_steps * (
        4 * L + 2)


def test_chunked_segments_tile_each_prompt(loop_runs):
    """`prefill_segment` [c0, c1) tiles every chunked prompt exactly,
    inside `prefill_chunk` spans; one `prefill_finalize` and one
    `prefill_insert` per admission."""
    tr, _, on, _ = loop_runs["paged-chunked"]
    chunks = _spans(tr, "prefill_chunk")
    segs = _spans(tr, "prefill_segment")
    assert all(any(_inside(s, c) for c in chunks) for s in segs)
    by_uid = {}
    for _, _, a in segs:
        by_uid.setdefault(a["uid"], []).append((a["c0"], a["c1"]))
    assert sorted(by_uid) == sorted(r.uid for r in on.results)
    for r in on.results:
        cuts = sorted(by_uid[r.uid])
        assert cuts[0][0] == 0 and cuts[-1][1] == r.prompt_len
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert len(cuts) == r.prompt_len // 8
    for name in ("prefill_finalize", "prefill_insert"):
        uids = sorted(a["uid"] for _, _, a in _spans(tr, name))
        assert uids == sorted(r.uid for r in on.results)
    assert len(_spans(tr, "admit_start")) >= len(on.results)


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_dispatch_and_wait_within_decode_seconds(loop_runs, case):
    """The new counters are parts of `decode_seconds`, traced or not."""
    _, _, on, off = loop_runs[case]
    for res in (on, off):
        assert res.dispatch_seconds > 0.0 and res.token_wait_seconds >= 0.0
        assert (res.dispatch_seconds + res.token_wait_seconds
                <= res.decode_seconds)


def test_null_tracer_enters_no_profiler_range(small_model, monkeypatch):
    """Only a truthy tracer opens `record_function` ranges."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _loop_run(small_model, "paged-chunked")
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _loop_run(small_model, "paged-chunked", port_obs.Tracer())
    assert {"decode", "token_wait", "retire", "prefill_segment",
            "attend"} <= set(opened)
    # the ranges land in the profiler's own trace, on its clock
    assert {"decode", "attend", "prefill_segment"} <= {
        e.key for e in prof.key_averages()}


def test_queue_wait_counter_on_tick_clock():
    """`queue_s` is the first admission's t_admit - t_submit on the
    scheduler's clock; a preempted request keeps its first wait; a
    request failed from the queue reads 0."""
    tick = itertools.count()
    sched = Scheduler((4,), 2, clock=lambda: float(next(tick)))
    reqs = [Request(tokens=np.zeros(4, np.int32), max_new=2)
            for _ in range(4)]
    for r in reqs:
        sched.submit(r)                      # t = 0, 1, 2, 3
    sched.admit_next(0)                      # reqs[0] at t = 4: waited 4
    sched.begin_prefill(1)                   # reqs[1] at t = 5: waited 4
    sched.finish_prefill(1)
    sched.record_token(0, 7)                 # t = 6
    sched.preempt(0)                         # back to the front
    sched.admit_next(0)                      # reqs[0] again at t = 7
    for s in (0, 1):
        sched.record_token(s, 7)
        sched.retire(s, "length")
    failed = sched.fail_head()               # reqs[2], never admitted
    got = {r.uid: r.queue_s for r in sched.results}
    assert got[reqs[0].uid] == 4.0 and got[reqs[1].uid] == 4.0
    assert failed.queue_s == 0.0
    assert sched.pending == 1


def test_queue_wait_equals_queued_span(ladder_runs):
    """On the ladder schedule's tick clock: an unpreempted request's
    `queue_s` is its `queued` span; a preempted one keeps its first wait,
    shorter than the span to its last admission."""
    tr, _, res = ladder_runs["port"]
    queued = {a["uid"]: dur for ph, n, tid, ts, dur, a in tr.events()
              if n == "queued"}
    assert any(r.n_preemptions for r in res.results)
    for r in res.results:
        span = queued.get(r.uid, 0.0)
        if r.n_preemptions:
            assert 0.0 <= r.queue_s <= span
        else:
            assert r.queue_s == pytest.approx(span, abs=1e-12)
