"""The port's chunked prefill against the JAX package on the CPU: the plain
version of the chunked flash kernel against `flash_prefill_chunk_pallas`
(interpret mode), `prefill_chunk` + `prefill_finalize` against the JAX
model's, and `Engine(chunked_prefill=True)` (dense and paged, the paged
prefill-direct path included) streams token-equal to the JAX engine's.
Tolerances: attention outputs 2e-5 (f32 summation order), logits 1e-4
(as tests/test_torch_engine.py); in the caches the model builds, integer
leaves (codes, positions, lengths) exact and float leaves within 1e-5
(f32 GEMM summation order through two layers; readings up to 4.4e-6)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.policy import presets as jax_presets
from repro.kernels.flash_prefill import ops as jax_fp
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
_j_chunk = jax.jit(JM.prefill_chunk, static_argnums=(1, 5))


def assert_cache_close(t_lc, j_lc, what, skip=()):
    for f in t_lc._fields:
        if f in skip:
            continue
        got, want = getattr(t_lc, f).numpy(), np.asarray(getattr(j_lc, f))
        assert got.shape == want.shape, (what, f, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(got, want, atol=CACHE_TOL,
                                       rtol=CACHE_TOL, err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# B4's plain version against flash_prefill_chunk_pallas (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 20], ids=["causal", "window"])
def test_chunk_plain_matches_pallas(window):
    """Segments at offset 0, mid-prompt and a ragged tail (56 rows in
    24-row segments), each against a scratch whose rows past the segment
    are still zero; concatenated, they are the monolithic prefill."""
    rng = np.random.default_rng(window)
    B, T, Hq, Hkv, D, C = 2, 56, 4, 2, 32, 24
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
            for _ in range(2))
    outs = []
    for c0 in range(0, T, C):
        c1 = min(c0 + C, T)
        ks, vs = np.zeros_like(k), np.zeros_like(v)
        ks[:, :c1], vs[:, :c1] = k[:, :c1], v[:, :c1]
        want = jax_fp.flash_attention_chunk(
            jnp.asarray(q[:, c0:c1]), jnp.asarray(ks), jnp.asarray(vs),
            q_offset=c0, window=window, interpret=True)
        got = fp_ops.flash_attention_chunk(
            torch.tensor(q[:, c0:c1]), torch.tensor(ks), torch.tensor(vs),
            q_offset=c0, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=ATTN_TOL,
                                   err_msg=f"segment at {c0}")
        outs.append(got)
    whole = flash_prefill_ref(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), window=window)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# prefill_chunk + prefill_finalize against the JAX model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _chunked(step, st, toks, C):
    logits = None
    for c0 in range(0, toks.shape[1], C):
        logits, st = step(st, toks[:, c0:c0 + C], c0)
    return logits, st


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-plain", "reference"])
@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
def test_prefill_chunk_finalize_matches_jax(small_model, pname, use_kernels):
    """48-token prompt in 16-token segments. The JAX side runs its
    reference attention (mass accumulated for every policy); the port's
    kernel path keeps zero mass for the policies that read none, so
    there the caches are compared without the masses (`scores`,
    `r_scores`)."""
    jcfg, jp, cfg, p = small_model
    T, C = 48, 16
    jeng = JaxEngine(jcfg, jp, jax_presets(32, 8)[pname], prompt_len=T,
                     max_new=6, use_kernels=False)
    teng = Engine(cfg, p, presets(32, 8)[pname], prompt_len=T, max_new=6,
                  use_kernels=use_kernels, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, T))
    jl, jst = _chunked(
        lambda st, t, c0: _j_chunk(jp, jeng.cfg, st, jnp.asarray(t),
                                   jnp.int32(c0), jeng.spec),
        JM.init_prefill_state(jeng.cfg, T), toks, C)
    jc = JM.prefill_finalize(jeng.cfg, jst, jeng.spec,
                             layer_budgets=jnp.asarray(jeng.layer_budgets))
    tl, tst = _chunked(
        lambda st, t, c0: M.prefill_chunk(p, teng.cfg, st, torch.tensor(t),
                                          c0, teng.spec),
        M.init_prefill_state(teng.cfg, T), toks, C)
    tc = M.prefill_finalize(teng.cfg, tst, teng.spec,
                            layer_budgets=teng.layer_budgets)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    skip = (("scores", "r_scores")
            if use_kernels and not teng.spec.track_scores() else ())
    assert_cache_close(tc.attn, jc.attn, pname, skip)
    # the port's chunked admission is its monolithic prefill
    ml, mc = M.prefill(p, teng.cfg, {"tokens": torch.tensor(toks)},
                       teng.spec, layer_budgets=teng.layer_budgets)
    np.testing.assert_allclose(tl.numpy(), ml.numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    if pname == "full":
        # prefill-direct's metadata: that of the verbatim branch
        jm = JM.prefill_finalize_meta(
            jeng.cfg, jst, jeng.spec,
            layer_budgets=jnp.asarray(jeng.layer_budgets))
        tm = M.prefill_finalize_meta(teng.cfg, tst, teng.spec,
                                     layer_budgets=teng.layer_budgets)
        assert_cache_close(tm.attn, jm.attn, "finalize_meta", skip)


# ---------------------------------------------------------------------------
# Engine(chunked_prefill=True) against the JAX engine
# (tests/test_chunked_prefill.py:60-103)
# ---------------------------------------------------------------------------


def _run(model, pname, *, jax_side, chunked=True, chunk_len=16,
         paged=False, L=64, new=6, n=5, eos_at=None):
    jcfg, jp, cfg, p = model
    kw = dict(prompt_len=L, max_new=new, slots=2, paged=paged, block_len=8,
              chunked_prefill=chunked, chunk_len=chunk_len)
    if jax_side:
        eng = JaxEngine(jcfg, jp, jax_presets(32, 8)[pname],
                        use_kernels=False, **kw)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(32, 8)[pname], device="cpu", **kw)
        R = Request
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(n, L)).astype(np.int32)
    res = eng.generate_continuous([
        R(tokens=prompts[i], max_new=new,
          eos_id=(eos_at if i == 1 else None)) for i in range(n)])
    if paged and not jax_side:
        assert eng.last_audit is not None and eng.last_audit["clean"]
    return res


def _assert_equal_streams(got, want, label):
    assert len(got.results) == len(want.results)
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=label)
        assert a.finish_reason == b.finish_reason


# the FAST_GRID of tests/test_chunked_prefill.py, plus the paged
# prefill-direct path (full: every prompt row kept verbatim)
GRID = [("h2o", False, 24), ("kivi2", True, 16), ("full", True, 16)]


@pytest.mark.parametrize("pname,paged,chunk_len", GRID, ids=lambda v: str(v))
def test_chunked_streams_equal_jax(small_model, pname, paged, chunk_len):
    want = _run(small_model, pname, jax_side=True, chunk_len=chunk_len,
                paged=paged)
    got = _run(small_model, pname, jax_side=False, chunk_len=chunk_len,
               paged=paged)
    _assert_equal_streams(got, want, f"{pname}/paged={paged}/{chunk_len}")
    assert len({r.slot for r in got.results}) <= 2      # slot reuse
    if paged:
        assert got.pool_peak_blocks == want.pool_peak_blocks
    # and the port's chunked streams are its monolithic ones
    mono = _run(small_model, pname, jax_side=False, chunked=False,
                paged=paged)
    _assert_equal_streams(got, mono, "chunked vs monolithic")


def test_chunked_early_exit_equals_jax(small_model):
    """EOS mid-stream retires a slot while an admission is in flight; the
    freed slot's next occupant still matches."""
    probe = _run(small_model, "h2o", jax_side=False, chunked=False)
    eos = int(probe.results[1].tokens[2])
    want = _run(small_model, "h2o", jax_side=True, eos_at=eos)
    got = _run(small_model, "h2o", jax_side=False, eos_at=eos)
    _assert_equal_streams(got, want, "h2o/eos")
    assert got.results[1].finish_reason == "eos"
    first = int(np.argmax(probe.results[1].tokens == eos))
    assert got.results[1].n_tokens == first + 1


def test_chunked_validation(small_model):
    cfg, p = small_model[2], small_model[3]
    pol = presets(32, 8)["h2o"]
    eng = Engine(cfg, p, pol, prompt_len=64, max_new=4, slots=2,
                 chunked_prefill=True, chunk_len=27, device="cpu")
    assert eng.chunk_len == 24                  # snaps to the mass group
    with pytest.raises(ValueError):             # unaligned bucket
        Engine(cfg, p, pol, prompt_len=68, max_new=4, slots=2,
               buckets=(68,), chunked_prefill=True, device="cpu")
    with pytest.raises(ValueError):
        eng.generate_continuous(
            [Request(tokens=np.zeros(64, np.int32), max_new=2)],
            buckets=(12, 64))
