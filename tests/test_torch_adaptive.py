"""The port's `serving.adaptive` against the JAX package's on the CPU:
`PressureController` watermarks, hysteresis and validation
(tests/test_faults.py:161-181), `prompt_entropy` / `choose_budget`
(tests/test_adaptive.py:12), and `AdaptiveEngine`'s routing and
per-bucket tokens (tests/test_adaptive.py:23) on the same weights."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import paging as JP
from repro.nn import model as JM
from repro.serving import adaptive as JA
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import paging as TP
from repro_torch.serving import adaptive as TA

PACKAGES = {"jax": (JA, JP), "port": (TA, TP)}


def _both(fn, *args):
    got = {k: fn(v, *args) for k, v in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_pressure_controller_hysteresis():
    def run(pkg):
        A, P = pkg
        ctrl = A.PressureController(high_water=0.8, low_water=0.5)
        a = P.BlockAllocator(10)
        grants = [a.alloc(1) for _ in range(7)]
        out = [(ctrl.shortfall(a), ctrl.pressed)]      # 0.7 < high
        grants.append(a.alloc(1))
        out.append((ctrl.shortfall(a), ctrl.pressed))  # 0.8 -> target 5
        a.free(grants.pop())
        a.free(grants.pop())
        out.append((ctrl.shortfall(a), ctrl.pressed))  # 0.6: still on
        a.free(grants.pop())
        out.append((ctrl.shortfall(a), ctrl.pressed))  # 0.5: released
        ctrl.note_degrade(3)
        ctrl.note_spill(2)
        return out, dict(ctrl.stats)
    out, stats = _both(run)
    assert out == [(0, False), (3, True), (1, True), (0, False)]
    assert stats["peak_used_frac"] == 0.8 and stats["ticks_pressed"] == 2
    assert stats["degrades"] == 1 and stats["blocks_dropped"] == 3
    assert stats["spills"] == 1 and stats["blocks_spilled"] == 2


@pytest.mark.parametrize("kw", [dict(high_water=0.4, low_water=0.6),
                                dict(low_water=0.0), dict(high_water=1.1),
                                dict(keep_groups=1)])
def test_pressure_controller_validation(kw):
    for A in (JA, TA):
        with pytest.raises(ValueError):
            A.PressureController(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entropy_and_budget_choice_equal_jax(seed):
    """Repetitive, diverse and mixed prompts: the same entropy (to the
    bit) and the same bucket in both packages; repetitive prompts get the
    smallest bucket, diverse ones the largest."""
    rng = np.random.default_rng(seed)
    prompts = [np.tile(rng.integers(0, 512, 4).astype(np.int32), 32),
               rng.integers(0, 512, 128).astype(np.int32),
               np.concatenate([np.tile(rng.integers(0, 512, 4), 16),
                               rng.integers(0, 512, 64)]).astype(np.int32)]
    buckets = [32, 64, 128]
    got = [(TA.prompt_entropy(p, 512), TA.choose_budget(p, 512, buckets))
           for p in prompts]
    want = [(JA.prompt_entropy(p, 512), JA.choose_budget(p, 512, buckets))
            for p in prompts]
    assert got == want
    assert got[0][1] == 32 and got[1][1] == 128
    assert got[0][0] < got[1][0]


def test_adaptive_engine_equals_jax():
    """Two diverse and two repetitive prompts route to both buckets; the
    chosen budgets and every bucket's tokens equal the JAX engine's."""
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    L = 64
    diverse = rng.integers(0, cfg.vocab_size, (2, L)).astype(np.int32)
    repetitive = np.tile(rng.integers(0, 8, (2, 8)).astype(np.int32),
                         (1, L // 8))
    prompts = np.concatenate([diverse, repetitive])
    kw = dict(buckets=[16, 48], prompt_len=L, max_new=4, slots=2)
    # on the CPU the JAX engines take the reference path (kernels on TPU
    # only), as the port's take the kernels' plain versions
    want = JA.AdaptiveEngine(jcfg, jp, **kw).generate(prompts)
    got = TA.AdaptiveEngine(cfg, p, device="cpu", **kw).generate(prompts)
    assert got.budgets_chosen == want.budgets_chosen
    assert set(got.budgets_chosen) == {16, 48}
    assert set(got.per_bucket) == set(want.per_bucket) == {16, 48}
    for b in got.per_bucket:
        np.testing.assert_array_equal(got.per_bucket[b].tokens,
                                      want.per_bucket[b].tokens)
        assert got.per_bucket[b].tokens.shape[1] == 4
