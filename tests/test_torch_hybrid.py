"""The port's superblocks of more than one layer and the hybrid
(jamba-v0.1-52b: one attention layer and seven Mamba-2 mixers per
superblock of 8, an MoE FFN every second layer) against the JAX package
on the CPU.

Both SSM configs (mamba2-130m, jamba-v0.1-52b) equal JAX's: fields,
`sb_layout` / `attn_positions` / `ssm_positions`, the parameter tree's
keys and shapes (at full size through the leaf specs, reduced through
`init_params`), `param_count` and `kv_bytes_per_token`. Reduced jamba
(f32, the same weights through `repro_torch.bridge`; reduced is a
period-2 / offset-1 interleave, so a superblock is a Mamba-2 + dense
layer and an attention + MoE layer) at 4 layers (two superblocks):
prefill / decode logits within 1e-4 of JAX's. At 2 layers,
`Engine.generate_continuous` streams are token-equal to the JAX
engine's for full / h2o / kivi2 / h2o+kivi2, dense and paged, with
`cache_physical_bytes` equal (the SSM leaves counted, as JAX's
`tree_bytes` counts them); with lazy growth and preemption on a starving
pool; and with the host tier on that pool the port's streams equal the
un-tiered run's, where the JAX engine's tier loses the SSM state.
Chunked prefill, prefix sharing and speculative decoding refuse with
JAX's messages."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as JB
from repro.core import cache as JC
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import model_cache_from_numpy, params_from_numpy
from repro_torch.configs import base as TB
from repro_torch.core.cache import CacheSpec
from repro_torch.core.policy import presets
from repro_torch.launch import serve
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
JAMBA = "jamba-v0.1-52b"
LOGIT_TOL = 1e-4
BUDGET, WINDOW, L_PROMPT, NEW, N_REQ = 32, 8, 64, 12, 6


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def _jax_flat(tree):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The configs and their layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_config_fields_layout_and_sizes_equal_jax(arch):
    cfg, jcfg = TB.get_config(arch), JB.get_config(arch)
    for f in dataclasses.fields(TB.ModelConfig):
        if f.name == "dtype":
            assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
        elif f.name in ("moe", "ssm"):
            assert (dataclasses.asdict(getattr(cfg, f.name))
                    == dataclasses.asdict(getattr(jcfg, f.name))), f.name
        elif f.name != "use_kernels":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for c, jc in ((cfg, jcfg), (TB.reduced(cfg), JB.reduced(jcfg)),
                  (TB.reduced(cfg, num_layers=4),
                   JB.reduced(jcfg, num_layers=4))):
        assert M.sb_layout(c) == JM.sb_layout(jc)
        assert M.attn_positions(c) == JM.attn_positions(jc)
        assert M.ssm_positions(c) == JM.ssm_positions(jc)
        assert [c.layer_kind(i) for i in range(c.num_layers)] == \
            [jc.layer_kind(i) for i in range(jc.num_layers)]
        assert (c.is_ssm_only, c.d_inner, c.ssm_heads) == \
            (jc.is_ssm_only, jc.d_inner, jc.ssm_heads)
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
        assert c.num_attn_layers() == jc.num_attn_layers()
        for bpe in (2.0, 0.25):
            assert c.kv_bytes_per_token(bpe) == jc.kv_bytes_per_token(bpe)
    # whole jamba: 8-layer superblocks of one attention layer at offset 4,
    # MoE on the odd layers; mamba2: no attention, no KV bytes
    if arch == JAMBA:
        assert M.sb_layout(cfg)[:2] == (8, 4)
        assert M.attn_positions(cfg) == [4]
    else:
        assert cfg.kv_bytes_per_token() == 0.0 and not M.attn_positions(cfg)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_tree_keys_and_shapes_equal_jax(arch):
    """The full-size tree's leaf specs (no allocation) against JAX's
    abstract init; the reduced tree the port draws against JAX's, with
    dtypes (A_log / D / dt_bias f32 in a bf16 model, as in JAX)."""
    cfg, jcfg = TB.get_config(arch), JB.get_config(arch)
    _, n_sb, _ = M.sb_layout(cfg)
    jfull = _jax_flat(jax.eval_shape(
        lambda: JM.init_params(jax.random.key(0), jcfg))["blocks"])
    spec = _flat(M._block_shapes(cfg))
    assert set(spec) == set(jfull)
    for k, (shape, *_) in spec.items():
        assert (n_sb, *shape) == tuple(jfull[k].shape), k
    rc = TB.reduced(cfg, num_layers=4, dtype=torch.bfloat16)
    jrc = JB.reduced(jcfg, num_layers=4, dtype=jnp.bfloat16)
    jp = _jax_flat(jax.eval_shape(
        lambda: JM.init_params(jax.random.key(0), jrc)))
    tp = _flat(M.init_params(rc, seed=0, device="cpu"))
    assert set(tp) == set(jp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == tuple(leaf.shape), k
        assert str(tp[k].dtype).split(".")[-1] == str(leaf.dtype), k


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


_MODELS: dict = {}


def _model(n_layers: int):
    """(jax cfg, jax params, port cfg, port params) of reduced jamba."""
    if n_layers not in _MODELS:
        jcfg = JB.reduced(JB.get_config(JAMBA), num_layers=n_layers)
        cfg = TB.reduced(TB.get_config(JAMBA), num_layers=n_layers)
        jp = JM.init_params(jax.random.key(0), jcfg)
        _MODELS[n_layers] = (jcfg, jp, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg))
    return _MODELS[n_layers]


_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))


@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
def test_hybrid_prefill_and_decode_equal_jax(pname):
    """Reduced jamba at 4 layers (two superblocks: the attention layer's
    budgets [n_sb, nA] = [2, 1], SSM stacks [2, 1, B, ...]): prefill of
    a 45-token prompt (a ragged SSD chunk) and 6 greedy decode steps,
    logits within 1e-4; the SSM stacks equal JAX's within 1e-5, and a
    decode step from a JAX-built cache (`bridge`) continues JAX's."""
    jcfg, jp, cfg, p = _model(4)
    pol, jpol = presets(BUDGET, WINDOW)[pname], jax_presets(BUDGET,
                                                            WINDOW)[pname]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 45))
    budgets = [24, 32] if pname == "h2o" else None
    lg, c = M.prefill(p, cfg, {"tokens": torch.as_tensor(toks)}, pol.spec,
                      layer_budgets=budgets)
    jlg, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jpol.spec,
                         layer_budgets=None if budgets is None
                         else jnp.asarray(budgets))
    assert c.attn.k.shape[:3] == jc.attn.k.shape[:3] == (2, 1, 2)
    assert c.ssm.state.shape == jc.ssm.state.shape
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL,
                               rtol=0)
    bc = model_cache_from_numpy(jax.tree.map(np.asarray, jc))
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None]
        lg, c = M.decode_step(p, cfg, c, torch.as_tensor(tok), pol.spec)
        blg, bc = M.decode_step(p, cfg, bc, torch.as_tensor(tok), pol.spec)
        jlg, jc = _j_decode(jp, jcfg, jc, jnp.asarray(tok), jpol.spec)
        for got in (lg, blg):
            np.testing.assert_allclose(got.numpy(), np.asarray(jlg),
                                       atol=LOGIT_TOL, rtol=0)
    for f in ("conv", "state"):
        np.testing.assert_allclose(getattr(c.ssm, f).numpy(),
                                   np.asarray(getattr(jc.ssm, f)),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(c.attn.budget.numpy(),
                                  np.asarray(jc.attn.budget))


def test_hybrid_gates_refuse_as_jax():
    """append_mask, prefill_from_kv and prefill_finalize_meta on the
    hybrid: JAX's refusals (the last a guard of the port's own: JAX's
    builds a cache its sb > 1 layout never inserts)."""
    jcfg, jp, cfg, p = _model(2)
    c = M.init_cache(cfg, CacheSpec(budget=16), 2, 16, device="cpu")
    assert c.attn.k.shape[:2] == (1, 1) and c.ssm.state.shape[:2] == (1, 1)
    with pytest.raises(ValueError) as e:
        M.decode_step(p, cfg, c, torch.zeros(2, 1, dtype=torch.long),
                      CacheSpec(budget=16),
                      append_mask=torch.ones(2, dtype=torch.bool))
    jc = JM.init_cache(jcfg, JC.CacheSpec(budget=16), 2, 16)
    with pytest.raises(ValueError) as je:
        JM.decode_step(jp, jcfg, jc, jnp.zeros((2, 1), jnp.int32),
                       JC.CacheSpec(budget=16), append_mask=jnp.ones(2, bool))
    assert str(e.value) == str(je.value)
    ks = torch.zeros(2, 1, 16, cfg.num_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError) as e:
        M.prefill_from_kv(cfg, CacheSpec(budget=16), ks, ks)
    with pytest.raises(ValueError) as je:
        JM.prefill_from_kv(jcfg, JC.CacheSpec(budget=16), jnp.asarray(ks),
                           jnp.asarray(ks))
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="uniform attention layers"):
        M.prefill_finalize_meta(cfg, None, CacheSpec(budget=16))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _prompts(vocab, n=N_REQ, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=L_PROMPT - 16 * (i % 2) * ragged)
            .astype(np.int32) for i in range(n)]


def _run(pname, *, jax_side, slots=2, max_new=NEW, ragged=True, **kw):
    jcfg, jp, cfg, p = _model(2)
    args = dict(prompt_len=L_PROMPT, max_new=max_new, slots=slots,
                buckets=(L_PROMPT - 16, L_PROMPT), **kw)
    if jax_side:
        eng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                        use_kernels=False, **args)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], device="cpu",
                     **args)
        R = Request
    res = eng.generate_continuous([
        R(tokens=t, max_new=max_new)
        for t in _prompts(cfg.vocab_size, ragged=ragged)])
    if eng.paged and not jax_side:
        assert eng.last_audit is not None and eng.last_audit["clean"]
    return res


def _streams(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


MODES = {"dense": {}, "paged": dict(paged=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2", "h2o+kivi2"])
def test_hybrid_streams_equal_jax(pname, mode):
    want = _run(pname, jax_side=True, **MODES[mode])
    got = _run(pname, jax_side=False, **MODES[mode])
    assert _streams(got) == _streams(want)
    assert [r.finish_reason for r in got.results] == \
        [r.finish_reason for r in want.results]
    assert got.decode_steps == want.decode_steps
    assert got.cache_physical_bytes == want.cache_physical_bytes


def test_hybrid_wave_path_equals_jax():
    """`Engine.generate` (waves): streams and the physical bytes (the SSM
    leaves counted) equal JAX's."""
    jcfg, jp, cfg, p = _model(2)
    prompts = np.stack(_prompts(cfg.vocab_size, 4)[::2])
    kw = dict(prompt_len=L_PROMPT, max_new=4, slots=2)
    want = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)["kivi2"],
                     use_kernels=False, **kw).generate(prompts)
    got = Engine(cfg, p, presets(BUDGET, WINDOW)["kivi2"], device="cpu",
                 **kw).generate(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_physical_bytes == want.cache_physical_bytes


# 6 prompts of 64 tokens, 24 new, 3 slots on a pool of 14 blocks of 16
# rows (6 blocks a request at full length): lazy growth starves
# mid-decode
OVERLOAD = dict(paged=True, pool_blocks=14, block_growth="lazy",
                preemption=True, slots=3, max_new=24, ragged=False)
DENSE_TWIN = dict(slots=3, max_new=24, ragged=False)


def test_hybrid_preemption_equals_jax_and_dense():
    """Lazy growth + preemption (recompute-on-resume: re-prefill, then the
    emitted tokens replayed) on a starving pool: every stream equals the
    JAX engine's and the unpreempted dense run's."""
    dense = _run("full", jax_side=True, **DENSE_TWIN)
    want = _run("full", jax_side=True, **OVERLOAD)
    got = _run("full", jax_side=False, **OVERLOAD)
    assert sum(r.n_preemptions for r in got.results) > 0
    assert [r.n_preemptions for r in got.results] == \
        [r.n_preemptions for r in want.results]
    assert _streams(got) == _streams(want) == _streams(dense)


def test_hybrid_tier_carries_the_ssm_state():
    """The same starving pool with the host tier: every preemption spills
    the slot's blocks, metadata and SSM leaves and restores them, so the
    port's streams equal the un-tiered run's (the JAX engine's and the
    dense one). The JAX tier spills the attention part only: a restored
    request decodes from its slot's stale SSM state, and its streams
    differ."""
    dense = _run("full", jax_side=True, **DENSE_TWIN)
    got = _run("full", jax_side=False, tiering=True, **OVERLOAD)
    assert got.tier["n_spills"] > 0 and got.tier["n_fetches"] > 0
    assert sum(r.n_spills for r in got.results) > 0
    assert _streams(got) == _streams(dense)
    want = _run("full", jax_side=True, tiering=True, **OVERLOAD)
    assert _streams(want) != _streams(dense)      # the reference's loss


def _verdict(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("gate", [
    dict(chunked_prefill=True, chunk_len=16),
    dict(paged=True, prefix_sharing=True),
    dict(speculative=True, gamma=2, draft_policy="same")],
    ids=["chunked", "prefix", "speculative"])
def test_hybrid_engine_gates_give_jax_message(gate):
    jcfg, jp, cfg, p = _model(2)
    kw = dict(prompt_len=64, max_new=4, slots=2, **gate)
    want = _verdict(lambda: JaxEngine(jcfg, jp, jax_presets(32, 8)["full"],
                                      **kw))
    got = _verdict(lambda: Engine(cfg, p, presets(32, 8)["full"],
                                  device="cpu", **kw))
    assert want is not None and "SSM state" in want
    assert got == want


def test_cli_serves_reduced_jamba_paged(capsys):
    """`--arch jamba-v0.1-52b --reduced --continuous --paged` on the CPU:
    every request completes and the pool audit is clean."""
    eng, res = serve.main(["--arch", JAMBA, "--reduced", "--policy",
                           "kivi2", "--budget", "32", "--window", "8",
                           "--requests", "4", "--max-new", "4", "--slots",
                           "2", "--continuous", "--buckets", "48,64",
                           "--paged", "--device", "cpu"])
    assert len(res.results) == 4
    assert all(r.finish_reason == "length" for r in res.results)
    out = capsys.readouterr().out
    assert "policy=kivi2 continuous requests=4" in out
    assert "audit clean=True" in out
