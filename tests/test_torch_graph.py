"""One CUDA graph per decode step (`repro_torch.serving.step_graph`) on the
CPU: the rule that picks the graphed steps, the CPU's eager runs, and the
replay plumbing through a stub capture backend that runs the captured
function on the static buffers at each replay (token copy-in and out,
`set_tokens` and admissions while a step is pending, both flush variants,
the launch counters' accounting, a fresh capture per call). The graphs
themselves run on the card (tests/test_torch_gpu.py)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.kernels import build as kbuild
from repro_torch.nn import model as M
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving import step_graph as graph_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

GRANITE = reduced(get_config("granite-8b"))


class Replaying:
    """A capture backend that records nothing: each replay runs the
    captured function eagerly on the static buffers. `capture` moves
    `counter` by `per_capture`, as a capture on the card moves the
    kernels' counters while it records their launches."""

    def __init__(self, counter=None, per_capture: int = 0) -> None:
        self.counter, self.per_capture = counter, per_capture
        self.pools = []

    def capture(self, fn, pool):
        if self.counter is not None:
            self.counter.launches += self.per_capture
        pool = pool if pool is not None else object()
        self.pools.append(pool)
        return fn, pool


@pytest.fixture
def fresh_warm(monkeypatch):
    """A process that has run no step eagerly yet."""
    monkeypatch.setattr(graph_lib, "_WARM", set())


def _prompts(n, lens=(32, 48), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GRANITE.vocab_size, lens[i % len(lens)])
            .astype(np.int32) for i in range(n)]


def _engine(cfg=GRANITE, pname="kivi2", backend=None, **kw):
    params = M.init_params(cfg, seed=0, device="cpu")
    opts = dict(prompt_len=48, max_new=12, slots=2, buckets=(32, 48))
    opts.update(kw)
    eng = Engine(cfg, params, presets(16, 8)[pname], device="cpu", **opts)
    eng.graph_backend = backend
    return eng


def _serve(eng, prompts, max_new=(12, 5, 9, 7, 12)):
    return eng.generate_continuous(
        [Request(tokens=p, max_new=max_new[i % len(max_new)])
         for i, p in enumerate(prompts)])


def _streams(res):
    return [(r.tokens.tolist(), r.finish_reason) for r in res.results]


# (config, policy, engine options, sampler) and the reason no step of the
# cache is graphed (None: its steps are)
RULE_CASES = {
    "dense": (GRANITE, "kivi2", {}, None, None),
    "paged": (GRANITE, "kivi2", dict(paged=True, block_len=8), None, None),
    "full": (GRANITE, "full", {}, None, None),
    "moe": (reduced(get_config("mixtral-8x22b")), "full", {}, None,
            "mixture of experts"),
    "ssm": (reduced(get_config("jamba-v0.1-52b")), "kivi2", {}, None,
            "SSM mixer"),
    "cross-attention": (reduced(get_config("seamless-m4t-large-v2")),
                        "kivi2", {}, None, "cross-attention memory"),
    "nacl-noise": (GRANITE, "nacl", {}, None, "policy noise"),
    "keyformer-noise": (GRANITE, "keyformer", {}, None, "policy noise"),
    "temperature": (GRANITE, "full", {}, sampler_lib.temperature(0.8, 5),
                    "sampler draws"),
    "plain-path": (GRANITE.replace(use_kernels=False), "kivi2", {}, None,
                   "plain path"),
}


@pytest.mark.parametrize("case", list(RULE_CASES) + ["append_mask",
                                                     "ring_full-none",
                                                     "cpu"])
def test_graph_rule(case, fresh_warm):
    """Which steps are graphed: the cache-wide rule (`blocker`) per model,
    policy and sampler; per step, a drafter's `append_mask` and an unknown
    `ring_full` keep it eager; on the CPU there is no capture backend."""
    cfg, pname, opts, smp, why = RULE_CASES.get(case, RULE_CASES["dense"])
    backend = None if case == "cpu" else Replaying()
    eng = _engine(cfg, pname, backend,
                  sampler=smp or sampler_lib.greedy, **opts)
    cache = M.init_cache(cfg, eng.spec, eng.slots, 60,
                         layer_budgets=eng.layer_budgets, device="cpu",
                         paged=eng.paged, block_len=eng.block_len,
                         pool_blocks=eng.pool_blocks,
                         src_len=16 if cfg.is_encoder_decoder else 0)
    tok = torch.zeros((eng.slots, 1), dtype=torch.int32)
    assert graph_lib.blocker(cfg, eng.spec, cache, eng.sampler,
                             eng.gen) == why
    eng._open_graphs(cache, tok)
    if case == "cpu":
        assert eng.graph_backend is None and eng._graphs is None
        return
    if why is not None:
        assert eng._graphs is None
        return
    g = eng._graphs
    assert g.variants == ((False, True) if eng.spec.quantized else (False,))
    mask = (torch.ones(eng.slots, dtype=torch.bool)
            if case == "append_mask" else None)
    ring_full = None if case == "ring_full-none" else False
    for _ in range(3):      # the first warms the shapes
        eng._decode(cache, tok, ring_full, append_mask=mask)
    want = 0 if case in ("append_mask", "ring_full-none") else 2
    assert (g.replays, g.captures) == (want, min(want, 1))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cpu_steps_are_eager(paged):
    """On the CPU (no capture backend) every step runs eagerly: no graph
    step or capture is counted, the decode spans are timed, and the
    flush steps are those the ring mirror decides."""
    eng = Engine(GRANITE, M.init_params(GRANITE, seed=0, device="cpu"),
                 presets(16, 8)["kivi2"], prompt_len=48, max_new=12, slots=2,
                 buckets=(32, 48), device="cpu", paged=paged)
    assert eng.graph_backend is None
    res = _serve(eng, _prompts(4))
    assert (res.graph_steps, res.graph_captures,
            res.graph_capture_seconds) == (0, 0, 0.0)
    assert res.decode_steps > 0 and 0 < res.kv_flush_steps < res.decode_steps
    assert 0.0 < res.dispatch_seconds <= res.decode_seconds
    wave = Engine(GRANITE, eng.params, presets(16, 8)["kivi2"],
                  prompt_len=32, max_new=6, slots=2, device="cpu")
    w = wave.generate(np.stack(_prompts(3, lens=(32,))))
    assert (w.graph_steps, w.graph_captures) == (0, 0)


REPLAY_CASES = {
    "kivi2-dense": ("kivi2", {}),
    "kivi2-paged-chunked": ("kivi2", dict(paged=True, block_len=8,
                                          chunked_prefill=True,
                                          chunk_len=16)),
    "full": ("full", {}),
    "h2o+kivi2-prefix-preempt": (
        "h2o+kivi2", dict(paged=True, block_len=8, prefix_sharing=True,
                          preempt_at=((3, 0), (6, 1)))),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replayed_streams_equal_eager(case, fresh_warm):
    """Through the stub backend the replays serve the engine's own
    streams (more requests than slots: admissions and `set_tokens` write
    the loop's tokens while a step is pending). A process's first call
    runs each variant's first step eagerly and captures it at its next;
    a second call captures afresh at its first step and replays every
    step. The launch counters move by what each capture recorded, once
    per replay."""
    pname, opts = REPLAY_CASES[case]
    count = kbuild.LaunchCount()
    try:
        backend = Replaying(count, per_capture=3)
        eager = _serve(_engine(pname=pname, **opts), _prompts(5))
        eng = _engine(pname=pname, backend=backend, **opts)
        quant = eng.spec.quantized
        first = _serve(eng, _prompts(5))
        second = _serve(eng, _prompts(5))
    finally:
        kbuild.LAUNCH_COUNTERS.remove(count)
    assert _streams(first) == _streams(eager) == _streams(second)
    n_var = 2 if quant else 1
    assert first.kv_flush_steps > 0 or not quant
    assert first.graph_steps == first.decode_steps - n_var
    assert second.graph_steps == second.decode_steps
    assert first.graph_captures == second.graph_captures == n_var
    assert first.graph_capture_seconds > 0
    assert count.launches == 3 * (first.graph_steps + second.graph_steps)
    # both variants share the first capture's pool
    assert len(set(map(id, backend.pools))) == 2
    assert eng._graphs is None       # freed with the call


def test_replay_copies_tokens_in_and_out(fresh_warm):
    """A replay reads the caller's tokens through the static input and
    hands back a copy of the static output: writing the returned tensor
    (as an admission writes the loop's tokens) leaves the graph's
    buffers alone, and the cache's storage keeps its addresses."""
    eng = _engine(pname="full", backend=Replaying())
    cache = M.init_cache(GRANITE, eng.spec, eng.slots, 60,
                         layer_budgets=eng.layer_budgets, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    eng._open_graphs(cache, tok)
    g = eng._graphs
    ptrs = [t.data_ptr() for t in graph_lib.cache_leaves(cache)]
    eng._decode(cache, tok, False)                  # eager: warms
    out = eng._decode(cache, tok, False)            # capture + replay
    assert g.replays == 1 and torch.equal(g.tok_in, tok)
    assert out.data_ptr() != g.tok_out.data_ptr()
    assert torch.equal(out, g.tok_out)
    out[0] = -1
    assert g.tok_out[0] != -1
    assert ptrs == [t.data_ptr() for t in graph_lib.cache_leaves(cache)]
    # a cache tensor that moves drops the graphs: the next step captures
    cache.attn.pos.set_(cache.attn.pos.clone())
    eng._decode(cache, tok, False)
    assert (g.captures, g.replays) == (2, 2)


def test_wave_path_captures_per_wave(fresh_warm):
    """`generate` captures for each wave's cache and replays its steps."""
    prompts = np.stack(_prompts(4, lens=(32,)))
    eager = _engine(pname="kivi2", prompt_len=32, max_new=6,
                    buckets=None).generate(prompts)
    eng = _engine(pname="kivi2", backend=Replaying(), prompt_len=32,
                  max_new=6, buckets=None)
    res = eng.generate(prompts)
    assert res.tokens.tolist() == eager.tokens.tolist()
    # two waves of 5 decode steps; the first wave warms both variants
    assert res.graph_captures == 2 + 2
    assert res.graph_steps == 2 * 5 - 2
