"""The port's CacheBlend against the JAX package on the CPU (the cases of
tests/test_cacheblend.py), same weights and tokens: `blend_prefill`'s
logits within 1e-4 and its blended K / V within 1e-5 of the JAX
package's (f32 matmul summation order through three layers), the
recomputed token indices exact; recompute fraction 1 equals a full
prefill; partial recompute beats pure chunk reuse; the query token is
always recomputed."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.nn import model as JM
from repro.serving import cacheblend as JCB
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.cache import CacheSpec
from repro_torch.nn import model as M
from repro_torch.serving import cacheblend as CB

LOGIT_TOL = 1e-4
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=3)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=3)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _tokens(cfg, B=2, S=48, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _blend_both(model, toks, bounds, frac):
    jcfg, jp, cfg, p = model
    want = JCB.blend_prefill(jp, jcfg, jnp.asarray(toks), bounds,
                             recompute_frac=frac)
    got = CB.blend_prefill(p, cfg, torch.tensor(toks), bounds,
                           recompute_frac=frac)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=KV_TOL,
                                   rtol=KV_TOL)
    return got


def test_full_recompute_equals_prefill(model):
    cfg, p = model[2], model[3]
    toks = _tokens(cfg)
    lg_cb, (ks, vs), _ = _blend_both(model, toks, [0, 16, 32], 1.0)
    spec = CacheSpec(budget=toks.shape[1] + 1)
    lg_ref, _ = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, spec)
    np.testing.assert_allclose(lg_cb.numpy(), lg_ref.numpy(), atol=2e-3,
                               rtol=1e-3)
    # the blended K/V through `prefill_from_kv` are an insert-ready cache
    pc = M.prefill_from_kv(cfg, spec, ks[:, :1], vs[:, :1])
    assert int(pc.attn.length[0, 0, 0]) == toks.shape[1]


def test_partial_beats_pure_reuse(model):
    cfg, p = model[2], model[3]
    toks = _tokens(cfg, seed=2)
    spec = CacheSpec(budget=toks.shape[1] + 1)
    lg_ref, _ = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, spec)

    def kl(lg):
        pf = torch.log_softmax(lg_ref, -1)
        pc = torch.log_softmax(lg, -1)
        return float((pf.exp() * (pf - pc)).sum(-1).mean())

    lg_reuse = _blend_both(model, toks, [0, 16, 32], 1.0 / 48)[0]
    lg_blend = _blend_both(model, toks, [0, 16, 32], 0.35)[0]
    assert kl(lg_blend) < kl(lg_reuse)


def test_selection_includes_query(model):
    toks = _tokens(model[2], seed=3)
    _, _, sel = _blend_both(model, toks, [0, 24], 0.2)
    assert (sel[:, -1] == toks.shape[1] - 1).all()
