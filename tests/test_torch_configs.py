"""The port's four further attention-only configs (minicpm-2b,
qwen2.5-32b, chameleon-34b, command-r-plus-104b) against the JAX package
on the CPU.

Each config's fields and sizes equal the reference's. At each config's
real head group and head dim (``reduced(cfg, num_heads=…,
num_kv_heads=…, head_dim=…)``, 2 layers, f32, the same weights through
`repro_torch.bridge`; qwen's QKV biases drawn nonzero, each rope_theta
kept; minicpm at an odd vocabulary), the port's prefill / decode logits
are within 1e-4 of the JAX model's and `Engine.generate_continuous`
streams are token-equal to the JAX engine's for full, h2o and kivi2,
dense and paged + chunked (speculative too at Gq 5 and 12).
chameleon (``arch_type="vlm"``) chunks in both packages. Rope at theta
1e6 and 7.5e7, the tied head over minicpm's full odd vocabulary and
MHA compress_prompt at minicpm's 36 KV heads are held to JAX at their
real sizes (f32, 1e-5 / 1e-6)."""
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
from repro.nn import layers as JL
from repro.nn import model as JM
from repro.nn import rope as JR
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TB
from repro_torch.core import cache as TC
from repro_torch.core.policy import presets
from repro_torch.nn import layers as TL
from repro_torch.nn import model as M
from repro_torch.nn import rope as TR
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

NEW_ARCHS = ("minicpm-2b", "qwen2.5-32b", "chameleon-34b",
             "command-r-plus-104b")
# reduced at each config's real Gq and D (2 KV heads where the real
# config has 8; MHA keeps Hq = Hkv)
REAL_GQ = {
    "minicpm-2b": dict(num_heads=4, num_kv_heads=4, head_dim=64,
                       vocab_size=1021),                          # Gq 1
    "qwen2.5-32b": dict(num_heads=10, num_kv_heads=2, head_dim=128),  # 5
    "chameleon-34b": dict(num_heads=16, num_kv_heads=2, head_dim=128),  # 8
    "command-r-plus-104b": dict(num_heads=24, num_kv_heads=2,
                                head_dim=128),                    # Gq 12
}
LOGIT_TOL = 1e-4
BUDGET, WINDOW, L_PROMPT, NEW, N_REQ = 32, 8, 64, 6, 5
_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))


# ---------------------------------------------------------------------------
# The configs themselves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_fields_and_sizes_equal_jax(arch):
    cfg, jcfg = TB.get_config(arch), JB.get_config(arch)
    for f in dataclasses.fields(TB.ModelConfig):
        if f.name == "dtype":
            assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
        elif f.name in ("moe", "ssm"):
            assert (dataclasses.asdict(getattr(cfg, f.name))
                    == dataclasses.asdict(getattr(jcfg, f.name))), f.name
        elif f.name != "use_kernels":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() == cfg.param_count()
    for bpe in (2.0, 0.25):
        assert cfg.kv_bytes_per_token(bpe) == jcfg.kv_bytes_per_token(bpe)
    assert cfg.num_attn_layers() == jcfg.num_attn_layers()
    # reduced() is the reference's shrink, overrides included
    over = REAL_GQ[arch]
    r, jr = TB.reduced(cfg, **over), JB.reduced(jcfg, **over)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qkv_bias", "rope_theta",
              "tie_embeddings", "sliding_window", "arch_type"):
        assert getattr(r, f) == getattr(jr, f), f
    assert r.param_count() == jr.param_count()


def test_get_config_and_all_configs_agree_with_jax():
    """All eleven reference configs, in JAX's order; the encoder-decoder
    (seamless-m4t-large-v2) field for field, its `param_count` (encoder
    blocks and cross-attention included, 2.03 B) and `reduced` (2
    encoder layers, no remat) JAX's. An unknown arch still raises
    KeyError and an unknown `arch_type` NotImplementedError."""
    port = TB.all_configs()
    assert list(port) == JB.ARCH_IDS == TB.ARCH_IDS
    jall = JB.all_configs()
    for name, cfg in port.items():
        assert cfg is TB.get_config(name)
        assert cfg.name == name == jall[name].name
        assert cfg.param_count() == jall[name].param_count()
        assert (cfg.remat, cfg.input_kind, cfg.is_encoder_decoder,
                cfg.num_encoder_layers) == (
            jall[name].remat, jall[name].input_kind,
            jall[name].is_encoder_decoder, jall[name].num_encoder_layers)
    cfg, jcfg = TB.get_config("seamless-m4t-large-v2"), jall[
        "seamless-m4t-large-v2"]
    for f in dataclasses.fields(TB.ModelConfig):
        if f.name in ("moe", "ssm"):
            assert (dataclasses.asdict(getattr(cfg, f.name))
                    == dataclasses.asdict(getattr(jcfg, f.name))), f.name
        elif f.name not in ("dtype", "use_kernels"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == 2_034_783_232
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    r, jr = TB.reduced(cfg), JB.reduced(jcfg)
    for f in ("num_layers", "num_encoder_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "remat"):
        assert getattr(r, f) == getattr(jr, f), f
    assert r.param_count() == jr.param_count()
    with pytest.raises(KeyError):
        TB.get_config("seamless-m4t-medium")
    with pytest.raises(NotImplementedError):
        TB.ModelConfig(name="x", arch_type="video", source="", num_layers=1,
                       d_model=8, num_heads=1, num_kv_heads=1, d_ff=8,
                       vocab_size=8)


def _verdict(check, cfg):
    try:
        check(cfg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_check_chunkable_gives_jax_verdict(arch):
    """Every reference config: the port's gate gives the JAX gate's
    verdict, message included (MoE, SSM layers and the encoder-decoder
    are refused)."""
    jcfg = JB.get_config(arch)
    want = _verdict(JM._check_chunkable, jcfg)
    cfg = TB.get_config(arch)
    assert _verdict(M._check_chunkable, cfg) == want
    assert (want is not None) == (cfg.is_moe or bool(M.ssm_positions(cfg))
                                  or cfg.is_encoder_decoder)
    if want is None:
        M.init_prefill_state(TB.reduced(cfg), 16, device="cpu")


# ---------------------------------------------------------------------------
# Layers at the configs' real sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e6, 7.5e7])
def test_rope_large_theta_equals_jax(theta):
    """qwen's and command-r's rope at D 128, positions up to 8191. The
    frequencies agree within one f32 ulp: torch's and XLA's CPU `pow`
    round 1e6 ** 0.578125 to neighbouring floats."""
    x = np.random.default_rng(0).standard_normal((1, 64, 2, 128)) \
        .astype(np.float32)
    pos = np.concatenate([np.arange(32), 8191 - np.arange(32)])[None]
    np.testing.assert_array_max_ulp(TR.rope_freqs(128, theta).numpy(),
                                    np.asarray(JR.rope_freqs(128, theta)),
                                    maxulp=1)
    got = TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_tied_unembed_odd_vocab_equals_jax():
    """minicpm's tied head over its full odd vocabulary (122 753)."""
    cfg = TB.get_config("minicpm-2b")
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((cfg.vocab_size, 64)) / 8).astype(np.float32)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    got = TL.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x))
    want = JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))
    assert got.shape == (2, 1, 122_753)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    ids = np.array([[0, cfg.vocab_size - 1]])
    np.testing.assert_array_equal(
        TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
        .numpy(), np.asarray(JL.embed({"table": jnp.asarray(table)},
                                      jnp.asarray(ids))))


@pytest.mark.parametrize("pname", ["h2o", "kivi2", "h2o+kivi2"])
def test_mha_compress_prompt_equals_jax(pname):
    """compress_prompt and the KIVI store at minicpm's 36 KV heads, D 64."""
    ts, js = presets(32, 8)[pname].spec, jax_presets(32, 8)[pname].spec
    rng = np.random.default_rng(2)
    k, v = (rng.standard_normal((2, 72, 36, 64)).astype(np.float32)
            for _ in range(2))
    mass = rng.uniform(0, 1, (2, 72)).astype(np.float32)
    t = TC.compress_prompt(ts, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(mass), dtype=torch.float32)
    j = JC.compress_prompt(js, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mass), dtype=jnp.float32)
    for f in TC.LayerKV._fields:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert got.shape == want.shape, f
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f)


# ---------------------------------------------------------------------------
# The model and the engine at each config's real Gq / D
# ---------------------------------------------------------------------------


_MODELS: dict = {}


def _model(arch):
    """(jax cfg, jax params, port cfg, port params), built once per arch."""
    if arch not in _MODELS:
        jcfg = JB.reduced(JB.get_config(arch), **REAL_GQ[arch])
        cfg = TB.reduced(TB.get_config(arch), **REAL_GQ[arch])
        jp = JM.init_params(jax.random.key(0), jcfg)
        if jcfg.qkv_bias:
            # JAX initialises biases to zero: draw them so they count
            rng = np.random.default_rng(3)
            a = jp["blocks"]["sub0"]["attn"]
            for w in ("wq", "wk", "wv"):
                a[w]["b"] = jnp.asarray(rng.standard_normal(a[w]["b"].shape)
                                        .astype(np.float32) * 0.5)
        _MODELS[arch] = (jcfg, jp, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg))
    return _MODELS[arch]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def model(request):
    return _model(request.param)


def test_real_gq_prefill_and_decode_logits_equal_jax(model):
    """Batch-2 prefill (h2o: the mass path) and three decode steps fed
    JAX's greedy tokens, at the config's real Gq / D; the port's kernels'
    plain versions."""
    jcfg, jp, cfg, p = model
    assert cfg.num_heads // cfg.num_kv_heads == \
        jcfg.num_heads // jcfg.num_kv_heads
    ts, js = presets(BUDGET, WINDOW)["h2o"].spec, \
        jax_presets(BUDGET, WINDOW)["h2o"].spec
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48))
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, js)
    tl, tc = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg="prefill")
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(nxt), js)
        tl, tc = M.decode_step(p, cfg, tc, torch.tensor(nxt), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode {step}")
    np.testing.assert_array_equal(tc.attn.slot_pos.numpy(),
                                  np.asarray(jc.attn.slot_pos))


def _run(model, pname, *, jax_side, eos=None, **kw):
    jcfg, jp, cfg, p = model
    args = dict(prompt_len=L_PROMPT, max_new=NEW, slots=2, block_len=8,
                buckets=(L_PROMPT - 16, L_PROMPT), **kw)
    if jax_side:
        eng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                        use_kernels=False, **args)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], device="cpu",
                     **args)
        R = Request
    rng = np.random.default_rng(5)
    lens = [L_PROMPT if i % 2 == 0 else L_PROMPT - 16 for i in range(N_REQ)]
    res = eng.generate_continuous([
        R(tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
          max_new=NEW, eos_id=eos if i == 1 else None)
        for i, n in enumerate(lens)])
    if eng.paged and not jax_side:
        assert eng.last_audit is not None and eng.last_audit["clean"]
    return eng, res


def _assert_streams(got, want, label):
    assert [r.uid for r in got.results] == [r.uid for r in want.results]
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=label)
        assert g.finish_reason == w.finish_reason, label
    # tokens_for: the same tokens by uid, KeyError past the last uid
    for r in want.results:
        np.testing.assert_array_equal(got.tokens_for(r.uid),
                                      want.tokens_for(r.uid))
    unknown = max(r.uid for r in want.results) + 1
    for res in (got, want):
        with pytest.raises(KeyError):
            res.tokens_for(unknown)


MODES = {"dense": {},
         "paged-chunked": dict(paged=True, chunked_prefill=True,
                               chunk_len=16)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
def test_real_gq_streams_equal_jax(model, pname, mode):
    jeng, want = _run(model, pname, jax_side=True, **MODES[mode])
    teng, got = _run(model, pname, jax_side=False, **MODES[mode])
    assert teng.chunked_prefill == jeng.chunked_prefill == (mode != "dense")
    _assert_streams(got, want, f"{model[2].name} {pname} {mode}")
    assert got.decode_steps == want.decode_steps
    assert got.cache_physical_bytes == want.cache_physical_bytes
    if teng.paged:
        assert got.pool_peak_blocks == want.pool_peak_blocks


@pytest.mark.parametrize("pname", ["full", "kivi2"])
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "command-r-plus-104b"])
def test_real_gq_speculative_streams_equal_jax(arch, pname):
    """The verify path at Gq 5 and 12 (Gq 12 packs L 5 into 60 rows on
    the card), qwen's biases included: the speculative engine's streams
    and stats equal JAX's."""
    model = _model(arch)
    kw = dict(speculative=True, gamma=4, draft_policy="same")
    _, want = _run(model, pname, jax_side=True, **kw)
    _, got = _run(model, pname, jax_side=False, **kw)
    _assert_streams(got, want, f"{arch} {pname} speculative")
    assert got.spec.verify_steps == want.spec.verify_steps > 0
    assert got.spec.committed == want.spec.committed
