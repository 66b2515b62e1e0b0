"""The port's model and serving engine against the JAX package on the CPU
(reduced granite-8b / paper-llama-7b, 2 layers, f32, the same weights
through `repro_torch.bridge`): prefill and decode-step logits within
1e-4, and greedy token streams of `Engine.generate_continuous` equal to
the JAX `Engine`'s, token for token, for every main-path policy."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import sampler as jax_sampler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

POLICIES = ("full", "streaming", "h2o", "kivi2", "h2o+kivi2")
# the other presets the port's engine takes (4- and 8-bit KIVI, the layer
# allocators and their hybrid)
MORE_POLICIES = ("kivi4", "int8", "pyramid", "squeeze", "zigzag",
                 "pyramid+kivi4")
BUDGET, WINDOW = 16, 8
BUCKETS = (32, 48)
MAX_NEW = 6
TOL = 1e-4
_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))
N_DECODE = 3


def _model(arch, **over):
    jcfg = jax_reduced(jax_get_config(arch), **over)
    cfg = reduced(get_config(arch), **over)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


@pytest.fixture(scope="module", params=["granite-8b", "paper-llama-7b"])
def model(request):
    return _model(request.param)


def _engines(model, pname, **kw):
    jcfg, jp, cfg, p = model
    jeng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                     prompt_len=max(BUCKETS), max_new=MAX_NEW, slots=2,
                     buckets=BUCKETS, use_kernels=False)
    teng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname],
                  prompt_len=max(BUCKETS), max_new=MAX_NEW, slots=2,
                  buckets=BUCKETS, device="cpu", **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def jax_logits(model):
    """Per policy: the JAX package's prefill logits and N_DECODE decode-step
    logits (greedy-fed) for one batch-2 prompt, with the tokens fed."""
    jcfg, jp, cfg, p = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    out = {}
    for pname in POLICIES:
        jeng, _ = _engines(model, pname)
        jl, jc = _j_prefill(jp, jeng.cfg, {"tokens": jnp.asarray(toks)},
                            jeng.spec, layer_budgets=jeng.layer_budgets)
        logits, fed = [np.asarray(jl)], []
        for _ in range(N_DECODE):
            fed.append(np.asarray(jnp.argmax(jl, -1))[:, None])
            jl, jc = _j_decode(jp, jeng.cfg, jc, jnp.asarray(fed[-1]),
                               jeng.spec)
            logits.append(np.asarray(jl))
        out[pname] = (toks, fed, logits, np.asarray(jc.attn.length),
                      np.asarray(jc.attn.slot_pos))
    return out


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-plain", "reference"])
@pytest.mark.parametrize("pname", POLICIES)
def test_prefill_and_decode_logits(model, jax_logits, pname, use_kernels):
    """Batch-2 prefill at the engine's spec and layer budgets, then three
    decode steps (ring flushes and evictions included) fed the same
    tokens; the port's cache is updated in place."""
    jcfg, jp, cfg, p = model
    toks, fed, want, length, slot_pos = jax_logits[pname]
    _, teng = _engines(model, pname, use_kernels=use_kernels)
    tl, tc = M.prefill(p, teng.cfg, {"tokens": torch.tensor(toks)},
                       teng.spec, layer_budgets=teng.layer_budgets)
    got = [tl]
    for nxt in fed:
        got.append(M.decode_step(p, teng.cfg, tc, torch.tensor(nxt),
                                 teng.spec)[0])
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=f"step {step} (0 = prefill)")
    np.testing.assert_array_equal(tc.attn.length.numpy(), length)
    np.testing.assert_array_equal(tc.attn.slot_pos.numpy(), slot_pos)


def _requests(R, vocab, eos=None):
    rng = np.random.default_rng(1)
    lens = (BUCKETS[0], BUCKETS[1], BUCKETS[0])
    return [R(tokens=rng.integers(0, vocab, size=n).astype(np.int32),
              max_new=MAX_NEW, eos_id=eos if i == 0 else None)
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def llama():
    """The arch of tests/test_decode_kernel_path.py's token-equality test
    (one arch: each JAX engine compiles its own prefill/decode)."""
    return _model("paper-llama-7b")


@pytest.fixture(scope="module")
def llama6():
    """paper-llama-7b reduced at 6 layers: the layer allocators give
    each layer its own budget."""
    return _model("paper-llama-7b", num_layers=6)


@pytest.mark.parametrize("pname", POLICIES)
def test_continuous_token_streams_equal_jax(llama, pname):
    """3 requests over 2 slots and two buckets; request 0 stops at an EOS
    taken from its own stream (its second token), so its slot is reused
    mid-decode by request 2. Streams equal the JAX engine's token for
    token (the port with its kernels' plain versions)."""
    _streams_equal_jax(llama, pname)


@pytest.mark.parametrize("layers", [2, 6])
@pytest.mark.parametrize("pname", MORE_POLICIES)
def test_more_presets_token_streams_equal_jax(request, pname, layers):
    """The stream test above for the presets off the main path, at 2
    layers and at 6 (where pyramid / squeeze / zigzag give each layer
    its own budget): streams, decode steps, cache bytes and the layer
    budgets equal the JAX engine's."""
    _streams_equal_jax(request.getfixturevalue(
        "llama" if layers == 2 else "llama6"), pname)


def _streams_equal_jax(model, pname):
    jcfg, jp, cfg, p = model
    jeng, teng = _engines(model, pname)
    np.testing.assert_array_equal(np.asarray(teng.layer_budgets),
                                  np.asarray(jeng.layer_budgets))
    free_run = teng.generate_continuous(_requests(Request, cfg.vocab_size))
    eos = int(free_run.results[0].tokens[1])
    want = jeng.generate_continuous(_requests(JaxRequest, cfg.vocab_size,
                                              eos))
    got = teng.generate_continuous(_requests(Request, cfg.vocab_size, eos))
    assert [r.finish_reason for r in got.results] == \
        [r.finish_reason for r in want.results]
    assert got.results[0].finish_reason == "eos"
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens,
                                      err_msg=f"{pname} uid order {g.uid}")
    assert got.decode_steps == want.decode_steps
    assert got.cache_physical_bytes == want.cache_physical_bytes
    assert got.cache_logical_bytes == want.cache_logical_bytes


def test_wave_generate_equals_jax(model):
    jcfg, jp, cfg, p = model
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 32))
    pol = "h2o+kivi2"
    want = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pol],
                     prompt_len=32, max_new=MAX_NEW, slots=2,
                     use_kernels=False).generate(prompts)
    got = Engine(cfg, p, presets(BUDGET, WINDOW)[pol], prompt_len=32,
                 max_new=MAX_NEW, slots=2, device="cpu").generate(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_physical_bytes == want.cache_physical_bytes


def test_unported_engine_options_raise(model):
    """Nothing the JAX engine takes is refused any more: degradation,
    tiering, the nacl / keyformer presets and a non-greedy sampler all
    construct. What the JAX engine refuses, the port refuses with the
    same error type: speculative decoding under a non-greedy sampler
    (ValueError in both)."""
    jcfg, jp, cfg, p = model
    paged = dict(paged=True, block_len=8, block_growth="lazy")
    for pname, opts in (("kivi2", dict(paged, degrade=True)),
                        ("h2o", dict(paged, tiering=True))):
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], prompt_len=32,
                     max_new=4, device="cpu", **opts)
        assert (eng.pressure is not None) == ("degrade" in opts)
        assert eng.tiering == ("tiering" in opts)
    sample = sampler_lib.temperature(0.8, top_k=4)
    for pname in ("nacl", "keyformer"):
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], prompt_len=32,
                     max_new=4, device="cpu", sampler=sample)
        assert eng.spec.policy == pname and eng.sampler is sample
    for make, pol, smp in (
            (Engine, presets(BUDGET, WINDOW)["h2o"], sample),
            (JaxEngine, jax_presets(BUDGET, WINDOW)["h2o"],
             jax_sampler.temperature(0.8, top_k=4))):
        kw = dict(device="cpu") if make is Engine else {}
        with pytest.raises(ValueError, match="greedy"):
            make(jcfg if make is JaxEngine else cfg,
                 jp if make is JaxEngine else p, pol, prompt_len=32,
                 max_new=4, speculative=True, sampler=smp, **kw)
