"""The temperature / top-k sampler against the JAX package on the CPU.

  * Gumbel-max under JAX's draws: with the port's draw function
    (`cache.gumbel`) handing out `jax.random.gumbel(key, shape)`, the
    port's `temperature(temp, top_k)` picks exactly what
    `repro.serving.sampler.temperature` picks (`jax.random.categorical`)
    in f32, for top_k 0, 1 and 50, on logits with ties at the k-th value
    (the mask keeps ties; the threshold is a value, never an index);
  * at the engine level (reduced paper-llama-7b, 2 layers, f32) top_k 1
    gives the greedy streams;
  * the real draws: 20k seeded samples at a vocabulary of 12 do not
    reject ``softmax(logits / temp)`` restricted to the top k, in a
    chi-square test at p = 1e-3.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.nn import model as JM
from repro.serving import sampler as jax_sampler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as TC
from repro_torch.core.policy import presets
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

P_REJECT = 1e-3           # chi-square significance
N_DRAWS = 20_000


def _logits(seed, B=8, V=96, ties=False):
    r = np.random.default_rng(seed)
    if ties:
        # a few distinct values: ties at every rank, the k-th included
        return r.integers(-3, 4, size=(B, V)).astype(np.float32)
    return (3 * r.standard_normal((B, V))).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("temp", [0.8, 1.7])
@pytest.mark.parametrize("top_k", [0, 1, 50])
def test_gumbel_max_equals_jax_categorical(monkeypatch, top_k, temp, ties):
    """64 keys x 8 rows: the port under JAX's draws picks JAX's token in
    every row (greedy-equal rows at top_k 1 without ties)."""
    keys = []
    monkeypatch.setattr(TC, "gumbel", lambda shape, generator, device: (
        torch.tensor(np.asarray(jax.random.gumbel(keys.pop(0), tuple(shape),
                                                  jnp.float32)))))
    port = sampler_lib.temperature(temp, top_k)
    ref = jax_sampler.temperature(temp, top_k)
    logits = _logits(int(10 * temp) + top_k, ties=ties)
    picked = set()
    for i in range(64):
        key = jax.random.key(i)
        keys.append(key)
        got = port(torch.tensor(logits), torch.Generator()).numpy()
        want = np.asarray(ref(jnp.asarray(logits), key))
        np.testing.assert_array_equal(got, want, err_msg=f"key {i}")
        assert got.dtype == np.int32
        picked.add(tuple(got))
    assert not keys
    if top_k == 1 and not ties:
        assert picked == {tuple(logits.argmax(-1))}
    else:
        assert len(picked) > 1


@pytest.mark.parametrize("top_k", [0, 3])
def test_draws_follow_softmax_of_top_k(top_k):
    """20k rows of one logit vector (vocabulary 12) through the real
    draws: the token counts fit softmax(logits / temp) over the kept
    logits (every other token never drawn)."""
    temp = 0.7
    logits = np.array([1.0, 0.2, -0.5, 1.4, 0.9, -1.0, 0.0, 0.3, 1.2, -0.2,
                       0.6, 0.8], np.float32)
    sample = sampler_lib.temperature(temp, top_k)
    gen = torch.Generator().manual_seed(0)
    toks = sample(torch.tensor(logits).expand(N_DRAWS, -1), gen).numpy()
    counts = np.bincount(toks, minlength=logits.size)
    lg = logits.astype(np.float64) / temp
    keep = (np.ones_like(lg, bool) if not top_k
            else lg >= np.sort(lg)[-top_k])
    p = np.where(keep, np.exp(lg - lg.max()), 0.0)
    p /= p.sum()
    assert counts[~keep].sum() == 0
    res = stats.chisquare(counts[keep], N_DRAWS * p[keep])
    assert res.pvalue > P_REJECT, (counts, N_DRAWS * p)


def test_top_k_1_equals_greedy_in_the_engine():
    """temperature(0.8, top_k=1) masks all but the largest logit, so the
    Gumbel draw cannot move the pick: streams equal the greedy engine's
    (draws still taken from the engine's generator)."""
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=32) for _ in range(3)]
    kw = dict(prompt_len=32, max_new=8, slots=2, device="cpu")
    out = {}
    for name, smp in (("greedy", sampler_lib.greedy),
                      ("top1", sampler_lib.temperature(0.8, top_k=1)),
                      ("top50", sampler_lib.temperature(0.8, top_k=50))):
        eng = Engine(cfg, p, presets(16, 8)["h2o"], sampler=smp, **kw)
        res = eng.generate_continuous([Request(tokens=t, max_new=8)
                                       for t in prompts])
        out[name] = [r.tokens.tolist() for r in res.results]
    assert out["top1"] == out["greedy"]
    assert out["top50"] != out["greedy"]
