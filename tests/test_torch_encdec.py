"""The port's encoder-decoder (seamless-m4t-large-v2, reduced: 2 encoder
and 2 decoder layers, f32, the same weights through `repro_torch.bridge`)
against the JAX package on the CPU: the encoder output and the cross
K / V within 1e-5, prefill / decode logits within 1e-4, and the wave
path's `Engine.generate` streams token-equal to the JAX engine's under
full, h2o, kivi2 and h2o+kivi2, with equal physical bytes and
compression ratio. The JAX gate verdicts for continuous batching,
chunked prefill, speculation and paging hold in the port, and a paged
engine's `generate` raises JAX's ValueError on every arch."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as JB
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import base as TB
from repro_torch.core.policy import presets
from repro_torch.launch import serve
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine

ARCH = "seamless-m4t-large-v2"
POLICIES = ("full", "h2o", "kivi2", "h2o+kivi2")
BUDGET, WINDOW, L_PROMPT, MAX_NEW = 16, 8, 32, 5
ENC_TOL = 1e-5
LOGIT_TOL = 1e-4
_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))


@pytest.fixture(scope="module")
def model():
    jcfg = JB.reduced(JB.get_config(ARCH))
    cfg = TB.reduced(TB.get_config(ARCH))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg)


def _inputs(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, L_PROMPT))
    src = rng.standard_normal((n, L_PROMPT // 4 + 8, cfg.d_model)
                              ).astype(np.float32)
    return toks, src


def test_param_tree_equals_jax(model):
    """enc_blocks / enc_norm and each decoder layer's norm_x / xattn:
    the JAX tree's paths, shapes and dtypes."""
    jcfg, jp, cfg, _ = model
    ours = M.init_params(cfg, seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    from repro_torch.checkpoint.io import _flatten
    tflat = dict(_flatten(ours))
    assert list(tflat) == list(jflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
    assert "['enc_blocks']['attn']['wq']['w']" in tflat
    assert tflat["['blocks']['sub0']['xattn']['wk']['w']"].shape == (
        2, cfg.d_model, cfg.num_kv_heads * cfg.head_dim)
    assert sum(t.numel() for t in tflat.values()) == sum(
        v.size for v in jflat.values())
    assert cfg.param_count() == jcfg.param_count()


def test_encoder_and_cross_memory_equal_jax(model):
    """`encode` (bidirectional, RoPE on q and k) and `_cross_memory`
    (no RoPE on the memory) on the same frames."""
    jcfg, jp, cfg, p = model
    _, src = _inputs(cfg)
    jmem = JM.encode(jp, jcfg, jnp.asarray(src))
    mem = M.encode(p, cfg, torch.from_numpy(src))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=ENC_TOL,
                               rtol=ENC_TOL)
    jk, jv, jb = JM._cross_memory(jp, jcfg, jmem)
    k, v, b = M._cross_memory(p, cfg, mem)
    for got, want in ((k, jk), (v, jv), (b, jb)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ENC_TOL, rtol=ENC_TOL)
    # a causal encoder would differ: the memory is bidirectional
    from repro_torch.nn import blocks as TBL
    x = torch.from_numpy(src)
    p0 = M._layer(p["enc_blocks"], 0)
    assert not torch.allclose(TBL.block_train(p0, x, cfg, causal=False)[0],
                              TBL.block_train(p0, x, cfg, causal=True)[0])


@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
def test_prefill_and_decode_logits_equal_jax(model, pname):
    """Prefill encodes the frames and keeps the cross memory in the
    cache; three decode steps attend it with the zero bias."""
    jcfg, jp, cfg, p = model
    toks, src = _inputs(cfg)
    pol = presets(BUDGET, WINDOW)[pname]
    jspec = jax_presets(BUDGET, WINDOW)[pname].spec
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "src_embeds": jnp.asarray(src)}, jspec)
    tl, tc = M.prefill(p, cfg, {"tokens": torch.from_numpy(toks),
                                "src_embeds": torch.from_numpy(src)},
                       pol.spec)
    for f in ("cross_k", "cross_v", "cross_bias"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)),
                                   atol=ENC_TOL, rtol=ENC_TOL, err_msg=f)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the JAX cache through the bridge decodes like the port's own
    bc = bridge.model_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for step in range(3):
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(nxt), jspec)
        tl, _ = M.decode_step(p, cfg, tc, torch.from_numpy(nxt), pol.spec)
        bl, _ = M.decode_step(p, cfg, bc, torch.from_numpy(nxt), pol.spec)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_allclose(bl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("frames", ["given", "default"])
@pytest.mark.parametrize("pname", POLICIES)
def test_wave_generate_equals_jax(model, pname, frames):
    """Three requests over 2 slots (a padded second wave): streams,
    physical bytes (the cross leaves counted) and the compression ratio
    equal the JAX engine's, with the frames given or the default zeros
    of max(L // 4, 16) frames."""
    jcfg, jp, cfg, p = model
    toks, src = _inputs(cfg, n=3, seed=1)
    src = src if frames == "given" else None
    kw = dict(prompt_len=L_PROMPT, max_new=MAX_NEW, slots=2)
    want = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                     use_kernels=False, **kw).generate(toks, src_embeds=src)
    got = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], device="cpu",
                 **kw).generate(toks, src_embeds=src)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_physical_bytes == want.cache_physical_bytes
    assert got.cache_logical_bytes == want.cache_logical_bytes
    assert got.compression_ratio == want.compression_ratio
    assert got.full_cache_bytes == want.full_cache_bytes


def test_init_cache_cross_leaves_equal_jax(model):
    jcfg, _, cfg, _ = model
    spec = presets(BUDGET, WINDOW)["kivi2"].spec
    jspec = jax_presets(BUDGET, WINDOW)["kivi2"].spec
    jc = JM.init_cache(jcfg, jspec, 2, 40, src_len=24)
    tc = M.init_cache(cfg, spec, 2, 40, src_len=24, device="cpu")
    for f in ("cross_k", "cross_v", "cross_bias"):
        assert tuple(getattr(tc, f).shape) == getattr(jc, f).shape, f
        assert str(getattr(tc, f).dtype)[6:] == str(getattr(jc, f).dtype)
    assert M.init_cache(cfg, spec, 2, 40, device="cpu").cross_k is None
    assert JM.init_cache(jcfg, jspec, 2, 40).cross_k is None


def _verdict(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


GATES = {
    "continuous": (dict(), lambda e, t: e.generate_continuous([t[0]])),
    "chunked": (dict(chunked_prefill=True, chunk_len=16), None),
    "prefix": (dict(paged=True, prefix_sharing=True), None),
    "speculative": (dict(speculative=True, gamma=2, draft_policy="same"),
                    None),
    "paged-generate": (dict(paged=True), lambda e, t: e.generate(t)),
}


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("arch", [ARCH, "granite-8b"])
def test_engine_gates_give_jax_verdict(model, arch, gate):
    """The encoder-decoder refuses continuous batching
    (NotImplementedError), chunked prefill, the prefix cache and
    speculation (ValueError, JAX's messages); a paged engine's wave
    path refuses on every arch, as in JAX."""
    if arch == ARCH:
        jcfg, jp, cfg, p = model
    else:
        jcfg = JB.reduced(JB.get_config(arch))
        cfg = TB.reduced(TB.get_config(arch))
        jp = JM.init_params(jax.random.key(0), jcfg)
        p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    opts, run = GATES[gate]
    toks = np.zeros((2, L_PROMPT), np.int64)
    kw = dict(prompt_len=L_PROMPT, max_new=3, slots=2, **opts)

    def make(E, c, prm, pol, **extra):
        def go():
            eng = E(c, prm, pol, **kw, **extra)
            if run is not None:
                run(eng, toks)
        return go

    want = _verdict(make(JaxEngine, jcfg, jp,
                         jax_presets(BUDGET, WINDOW)["full"],
                         use_kernels=False))
    got = _verdict(make(Engine, cfg, p, presets(BUDGET, WINDOW)["full"],
                        device="cpu"))
    assert got == want
    refused = gate == "paged-generate" or arch == ARCH
    assert (want is not None) == refused
    if gate == "paged-generate":
        assert want[0] == "ValueError" and "wave path" in want[1]


def test_serve_cli_draws_frames_after_prompts(model, capsys):
    """`serve --arch seamless-m4t-large-v2 --reduced` (wave path): the
    frames come from the prompts' generator after the prompts, as in the
    JAX CLI; the streams equal the JAX engine's on those draws and the
    CLI's own random weights (handed to JAX as arrays). Continuous
    batching refuses the arch."""
    _, _, cfg, _ = model
    argv = ["--arch", ARCH, "--reduced", "--policy", "kivi2", "--budget",
            "16", "--window", "8", "--requests", "3", "--prompt-len", "32",
            "--max-new", "4", "--slots", "2", "--device", "cpu"]
    eng, res = serve.main(argv)
    assert "policy=kivi2" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(3, 32))
    src = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    jcfg = JB.reduced(JB.get_config(ARCH))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), eng.params)
    want = JaxEngine(jcfg, jp, jax_presets(16, 8)["kivi2"], prompt_len=32,
                     max_new=4, slots=2, use_kernels=False).generate(
                         prompts, src_embeds=src)
    np.testing.assert_array_equal(res.tokens, want.tokens)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(argv + ["--continuous"])
