"""The PyTorch port's primitive layers against the JAX package on the CPU:
the same numpy inputs through `repro.nn` and `repro_torch.nn`, f32."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import model as JM
from repro.nn import rope as JR
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import granite_8b, paper_llama_7b
from repro_torch.configs.base import reduced
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL
from repro_torch.nn import rope as TR

ATOL = 1e-5
ARCHS = {"granite-8b": granite_8b.CONFIG,
         "paper-llama-7b": paper_llama_7b.CONFIG}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    """(jax cfg, jax params, port cfg, port params) at reduced size, f32."""
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(ARCHS[request.param])
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=ATOL)


def test_rmsnorm(model):
    jcfg, jp, cfg, p = model
    x = _x((2, 5, cfg.d_model))
    blk_j = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"])
    pj = {"scale": blk_j["norm1"]["scale"] * 1.5}
    pt = {"scale": torch.tensor(np.asarray(pj["scale"]))}
    _close(TL.rmsnorm(pt, torch.from_numpy(x), cfg.norm_eps),
           JL.rmsnorm(pj, jnp.asarray(x), jcfg.norm_eps))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    x = _x((2, 7, 3, 64), seed=1)
    pos = np.array([[0, 1, 2, 3, 40, 77, 120], [5, 6, 7, 8, 9, 10, 11]])
    _close(TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mlp(model):
    jcfg, jp, cfg, p = model
    x = _x((2, 5, cfg.d_model), seed=2)
    _close(TL.mlp({k: {"w": v["w"][0]} for k, v in
                   p["blocks"]["sub0"]["mlp"].items()}, torch.from_numpy(x)),
           JL.mlp(jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["mlp"]),
                  jnp.asarray(x)))


def test_qkv(model):
    jcfg, jp, cfg, p = model
    x = _x((2, 6, cfg.d_model), seed=3)
    pos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]])
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["attn"])
    pt = {k: {"w": v["w"][0]} for k, v in p["blocks"]["sub0"]["attn"].items()}
    for got, want in zip(TA.qkv(pt, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos)),
                         JA.qkv(pj, jnp.asarray(x), jcfg, jnp.asarray(pos))):
        _close(got, want)


def test_unembed(model):
    jcfg, jp, cfg, p = model
    x = _x((3, cfg.d_model), seed=4)
    _close(TL.unembed(p["embed"], torch.from_numpy(x)),
           JL.unembed(jp["embed"], jnp.asarray(x)))


def test_embed_and_reduced_shapes(model):
    jcfg, jp, cfg, p = model
    ids = np.array([[0, 5, cfg.vocab_size - 1]])
    _close(TL.embed(p["embed"], torch.from_numpy(ids)),
           JL.embed(jp["embed"], jnp.asarray(ids)), atol=0)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "tie_embeddings", "norm_eps",
              "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
