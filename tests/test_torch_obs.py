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
