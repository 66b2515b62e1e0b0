"""The port's overload ladder end to end against the JAX package on the
CPU (reduced paper-llama-7b, 2 layers, f32, the same weights through
`repro_torch.bridge`, prompts of 32 or 64 tokens): the same requests
through the JAX `Engine` and the port's `Engine` give equal token
streams, finish reasons, preemption counts and decode steps, under forced
preemptions (`preempt_at`, plain and speculative loops), lazy block
growth, pool starvation with and without the ladder, shortest-prompt
admission and seeded allocator faults (where the two allocators also
count the same alloc calls and injected faults). Every forced-preemption
stream also equals the port's unpreempted stream."""
import signal

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import paging as JP
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import paging as TP
from repro_torch.core.policy import presets
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

BUDGET, WINDOW = 32, 8


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _prompts(vocab, n, seed, size=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=size).astype(np.int32)
            for _ in range(n)]


def _serve(model, pname, prompts, *, jax_side=False, max_new=10,
           eos=None, fault_plan=None, **kw):
    """(engine, result) of one `generate_continuous` run of `prompts`,
    through the JAX engine or the port's."""
    jcfg, jp, cfg, p = model
    L = max(len(t) for t in prompts)
    kw.setdefault("prompt_len", L)
    if jax_side:
        if fault_plan is not None:
            kw["fault_plan"] = JP.FaultPlan(**vars(fault_plan))
        eng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                        max_new=max_new, use_kernels=False, seed=0, **kw)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname],
                     max_new=max_new, device="cpu", fault_plan=fault_plan,
                     **kw)
        R = Request
    res = eng.generate_continuous(
        [R(tokens=t, max_new=max_new, eos_id=(eos[i] if eos else None))
         for i, t in enumerate(prompts)])
    return eng, res


def _streams(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


def _assert_equal_jax(got, want, what=""):
    """Streams, finish reasons, preemption and retry counts per request,
    and decode steps."""
    g = sorted(got.results, key=lambda r: r.uid)
    w = sorted(want.results, key=lambda r: r.uid)
    assert _streams(got) == _streams(want), what
    assert [r.finish_reason for r in g] == [r.finish_reason for r in w], what
    assert [r.n_preemptions for r in g] == [r.n_preemptions for r in w], what
    assert [r.n_retries for r in g] == [r.n_retries for r in w], what
    assert got.decode_steps == want.decode_steps, what


def _both(model, pname, prompts, **kw):
    """The port's (engine, result), held equal to the JAX engine's
    result, and that result."""
    eng, got = _serve(model, pname, prompts, **kw)
    _, want = _serve(model, pname, prompts, jax_side=True, **kw)
    _assert_equal_jax(got, want, f"{pname} {kw}")
    return eng, got, want


PAGED = dict(paged=True, block_len=8)
CHUNKED = dict(paged=True, block_len=8, chunked_prefill=True, chunk_len=16)


@pytest.mark.parametrize("opts", [{}, PAGED, CHUNKED],
                         ids=["dense", "paged", "paged+chunked"])
@pytest.mark.parametrize("pname", ["full", "kivi2"])
def test_preempt_resume_equals_jax(small_model, pname, opts):
    """Forced preemptions at fixed dispatches: the preempted run
    re-prefills the prompt and replays the emitted tokens; its streams
    equal the JAX engine's and the unpreempted run's, token for token."""
    prompts = _prompts(small_model[2].vocab_size, 3, seed=1)
    kw = dict(slots=2, **opts)
    _, ref = _serve(small_model, pname, prompts, **kw)
    eng, res, _ = _both(small_model, pname, prompts,
                        preempt_at=((3, 0), (5, 1)),
                        audit_every=2 if opts else 0, **kw)
    assert _streams(res) == _streams(ref)
    assert sum(r.n_preemptions for r in res.results) >= 2
    if opts:
        assert eng.last_audit["clean"]


@pytest.mark.parametrize("opts", [PAGED, CHUNKED],
                         ids=["paged", "paged+chunked"])
@pytest.mark.parametrize("pname", ["full", "kivi2"])
def test_preempt_resume_speculative_equals_jax(small_model, pname, opts):
    """The same contract through the draft / verify loop: a preempted slot
    replays through plain rounds, then drafts again."""
    prompts = _prompts(small_model[2].vocab_size, 3, seed=1)
    kw = dict(slots=2, max_new=12, speculative=True, gamma=3,
              draft_policy="kivi2:16:8", **opts)
    _, ref = _serve(small_model, pname, prompts, **kw)
    eng, res, want = _both(small_model, pname, prompts,
                           preempt_at=((2, 0), (4, 1)), audit_every=3, **kw)
    assert _streams(res) == _streams(ref)
    assert sum(r.n_preemptions for r in res.results) >= 2
    assert res.spec.rounds == want.spec.rounds
    assert eng.last_audit["clean"]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_lazy_growth_streams_equal_eager(small_model, spec):
    """Lazy growth on an ample pool changes no stream; under speculation
    the rollback returns every block it no longer covers (the pool ends
    drained)."""
    prompts = _prompts(small_model[2].vocab_size, 5, seed=1, size=64)
    kw = dict(slots=2, max_new=16, **PAGED)
    if spec:
        kw.update(speculative=True, gamma=3, draft_policy="window:16")
    _, eager = _serve(small_model, "full", prompts, **kw)
    eng, lazy, _ = _both(small_model, "full", prompts, block_growth="lazy",
                         **kw)
    assert _streams(lazy) == _streams(eager)
    assert eng.block_allocator.used == 0 and eng.last_audit["clean"]


@pytest.mark.parametrize("chunked", [False, True], ids=["mono", "chunked"])
def test_lazy_starvation_preempts_instead_of_oom(small_model, chunked):
    """Mid-decode starvation under lazy growth preempts and requeues: every
    request completes and none retires "oom", where the ladder-off twin
    fails some; streams equal an uncontended run's and the JAX engine's."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=3)
    kw = dict(slots=3, block_growth="lazy", pool_blocks=10,
              **(CHUNKED if chunked else PAGED))
    _, off, _ = _both(small_model, "full", prompts, **kw)
    assert any(r.finish_reason in ("oom", "failed") for r in off.results)
    eng, on, _ = _both(small_model, "full", prompts, preemption=True,
                       audit_every=2, **kw)
    assert all(r.finish_reason == "length" for r in on.results)
    assert sum(r.n_preemptions for r in on.results) >= 1
    assert eng.last_audit["clean"]
    kw.pop("pool_blocks")
    _, wide = _serve(small_model, "full", prompts, **kw)
    assert _streams(on) == _streams(wide)


@pytest.mark.parametrize("fail_patience", [1, 3, 6])
def test_unservable_request_fails_with_retries(small_model, fail_patience):
    """Only a request that cannot fit an empty pool fails, with the ladder
    on; its result carries the bounded retry count, which follows
    `fail_patience` as in the JAX engine."""
    prompts = [np.zeros(32, np.int32)]
    eng, res, _ = _both(small_model, "full", prompts, slots=2, max_new=4,
                        pool_blocks=2, preemption=True,
                        fail_patience=fail_patience, **PAGED)
    (r,) = res.results
    assert r.finish_reason == "failed" and r.n_tokens == 0
    assert r.n_retries == fail_patience + 1
    assert eng.last_audit["clean"]


@pytest.mark.parametrize("preempt_patience", [0, 5])
@pytest.mark.parametrize("chunked", [False, True], ids=["mono", "chunked"])
def test_preempt_patience_equals_jax(small_model, chunked, preempt_patience):
    """The refusals (monolithic admission) or stalled grants (chunked) the
    ladder waits out before it claims a victim: the same preemptions,
    retries and streams as the JAX engine at another patience than the
    default, with every request served."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=3)
    eng, res, _ = _both(small_model, "full", prompts, slots=3,
                        block_growth="lazy", pool_blocks=10,
                        preemption=True, preempt_patience=preempt_patience,
                        **(CHUNKED if chunked else PAGED))
    assert all(r.finish_reason == "length" for r in res.results)
    assert eng.last_audit["clean"]


class _Deadline:
    """Fail (instead of hanging) when the block runs past `seconds`."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def _fire(self, *_):
        raise TimeoutError(f"no result within {self.seconds} s")

    def __enter__(self):
        self.prev = signal.signal(signal.SIGALRM, self._fire)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self.prev)


# pools of 4-row blocks (the 44-row store resolves block_len 8 to 4): 9
# holds less than one whole request (32 + 12 rows), 11 exactly one
SMALL_POOLS = [9, 11, 14]


@pytest.mark.parametrize("pool", SMALL_POOLS)
@pytest.mark.parametrize("slots", [2, 3])
def test_lazy_ladder_small_pool_equals_jax(small_model, slots, pool):
    """Lazy growth with the ladder on a pool that holds at most a few
    requests: the plain loop converges as the JAX engine's does, with the
    same streams, finish reasons, preemptions and retries."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=1)
    eng, res, _ = _both(small_model, "full", prompts, slots=slots,
                        max_new=12, block_growth="lazy", preemption=True,
                        pool_blocks=pool, audit_every=2, **PAGED)
    assert eng.last_audit["clean"]
    whole = pool * eng.block_len >= 32 + 12
    assert all((r.finish_reason == "length") == whole for r in res.results)


@pytest.mark.parametrize("pool", SMALL_POOLS)
@pytest.mark.parametrize("slots", [2, 3])
def test_speculative_ladder_converges_on_small_pool(small_model, slots,
                                                    pool):
    """The draft / verify loop with lazy growth and the ladder on the same
    small pools. The JAX loop does not finish here (it preempts a resumed
    slot before its first new token, so two admissions trade the pool
    forever); the port exempts a continuation until that token commits.
    Every run ends: a request is served whole, equal to the ample-pool
    run's stream, where the pool can hold it, and otherwise ends "failed"
    or "oom" with a prefix of that stream."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=1)
    kw = dict(slots=slots, max_new=12, speculative=True, gamma=4,
              block_growth="lazy", preemption=True, **PAGED)
    _, ample = _serve(small_model, "full", prompts, **kw)
    with _Deadline(60):
        eng, res = _serve(small_model, "full", prompts, pool_blocks=pool,
                          audit_every=2, **kw)
    assert eng.last_audit["clean"] and eng.block_allocator.used == 0
    whole = pool * eng.block_len >= 32 + 12
    assert sum(r.n_preemptions for r in res.results) >= 1
    for got, want in zip(_streams(res), _streams(ample)):
        assert got == (want if whole else want[:len(got)])
    assert all((r.finish_reason == "length") == whole for r in res.results)
    assert all(r.finish_reason in ("length", "failed", "oom")
               for r in res.results)


def test_lazy_oom_with_chunked_first_token(small_model):
    """A chunk-admitted slot whose first token is still in flight when
    growth starves records that token and retires "oom" (pool = the
    prompt's coverage exactly)."""
    prompts = _prompts(small_model[2].vocab_size, 1, seed=1, size=64)
    _, res, _ = _both(small_model, "full", prompts, slots=1, max_new=8,
                      pool_blocks=8, block_growth="lazy",
                      chunked_prefill=True, chunk_len=16, **PAGED)
    (r,) = res.results
    assert r.finish_reason == "oom" and r.n_tokens == 1


def test_lazy_oom_retires_cleanly(small_model):
    """A pool that admits (prompt coverage) but cannot sustain growth
    retires starved slots "oom" with their emitted tokens kept."""
    prompts = _prompts(small_model[2].vocab_size, 2, seed=1, size=64)
    eng, res, _ = _both(small_model, "full", prompts, slots=2, max_new=24,
                        pool_blocks=9, block_growth="lazy", **PAGED)
    assert "oom" in {r.finish_reason for r in res.results}
    assert all(r.n_tokens >= 1 for r in res.results
               if r.finish_reason == "oom")
    assert eng.last_audit["clean"]


def test_shortest_prompt_end_to_end(small_model):
    """A short prompt queued behind three long ones is served first under
    shortest-prompt and last under FIFO, as in the JAX engine."""
    vocab = small_model[2].vocab_size
    prompts = _prompts(vocab, 3, seed=1, size=64) + \
        _prompts(vocab, 1, seed=9, size=32)
    for order, rank in (("fifo", 3), ("shortest-prompt", 0)):
        _, res, _ = _both(small_model, "full", prompts, slots=1,
                          max_new=6, buckets=(32, 64), admission_order=order)
        by_first = sorted(res.results, key=lambda r: r.token_times[0])
        short = max(res.results, key=lambda r: r.uid).uid
        assert [r.uid for r in by_first].index(short) == rank


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pname", ["full", "kivi2"])
def test_fault_injection_soak(small_model, pname, seed):
    """Seeded allocator refusals (rate 0.15) against lazy growth with the
    ladder on and audits every 4 dispatches: the same results as the JAX
    engine, the same alloc calls and injected faults, a clean audit."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=seed)
    plan = TP.FaultPlan(seed=seed, fail_rate=0.15)
    kw = dict(slots=2, block_growth="lazy", preemption=True, audit_every=4,
              fault_plan=plan, **PAGED)
    eng, res = _serve(small_model, pname, prompts, **kw)
    jeng, want = _serve(small_model, pname, prompts, jax_side=True, **kw)
    _assert_equal_jax(res, want, f"soak {pname} seed {seed}")
    a, ja = eng.block_allocator, jeng.block_allocator
    assert (a.alloc_calls, a.faults_injected) == \
        (ja.alloc_calls, ja.faults_injected)
    assert len(res.results) == 4 and eng.last_audit["clean"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_injection_soak_speculative(small_model, seed):
    """The soak through the draft / verify loop: refused verify grants
    fall back to plain steps and bounded retries, as in the JAX engine
    (same rounds, alloc calls and injected faults)."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=seed)
    plan = TP.FaultPlan(seed=seed, fail_rate=0.15)
    kw = dict(slots=2, max_new=12, block_growth="lazy", preemption=True,
              audit_every=4, fault_plan=plan, speculative=True, gamma=3,
              draft_policy="window:16", **PAGED)
    eng, res = _serve(small_model, "full", prompts, **kw)
    jeng, want = _serve(small_model, "full", prompts, jax_side=True, **kw)
    _assert_equal_jax(res, want, f"speculative soak seed {seed}")
    assert res.spec.rounds == want.spec.rounds
    a, ja = eng.block_allocator, jeng.block_allocator
    assert (a.alloc_calls, a.faults_injected) == \
        (ja.alloc_calls, ja.faults_injected)
    assert eng.last_audit["clean"]


def test_skew_mid_run_is_caught(small_model):
    """A refcount skew injected on the first allocation is invisible to
    the serving loop but fails the audit, in both packages with the same
    report."""
    prompts = _prompts(small_model[2].vocab_size, 2, seed=0)
    msgs = []
    for jax_side in (False, True):
        with pytest.raises((TP.PoolAuditError, JP.PoolAuditError)) as err:
            _serve(small_model, "full", prompts, jax_side=jax_side,
                   slots=2, max_new=4, block_growth="lazy",
                   preemption=True,
                   fault_plan=TP.FaultPlan(skew_alloc=0, skew_delta=1),
                   **PAGED)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
