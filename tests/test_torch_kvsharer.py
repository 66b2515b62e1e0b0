"""The port's KVSharer (layer-wise KV sharing, `core/sharing.py` and the
unrolled `serving/shared_runner.py`) against the JAX package on the CPU:
the same sharing maps from the same summaries, summaries and
`materialize` within 1e-6 (f32), and the runner's logits within 2e-4 +
1e-4 of JAX's runner on the same weights (reduced paper-llama-7b at 4
layers, f32, through `repro_torch.bridge`), with and without sharing."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import cache as JC
from repro.core import sharing as JSH
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import shared_runner as JSR
from repro_torch.bridge import layer_kv_from_numpy, params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as TC
from repro_torch.core import sharing as SH
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving import shared_runner as SR

ATOL, RTOL = 2e-4, 1e-4
F_ATOL = 1e-6


def _summary_cases():
    rng = np.random.default_rng(0)
    a = np.ones((1, 8)); b = np.ones((1, 8))
    c = np.zeros((1, 8)); c[0, 0] = 1
    d = np.zeros((1, 8)); d[0, 1] = 1
    return {
        # tests/test_policies.py: test_kvsharer_map_properties
        "random-12x32-n4": (rng.standard_normal((12, 32)), 4),
        # tests/test_policies.py: test_kvsharer_picks_dissimilar
        "identical-and-orthogonal-n1": (np.concatenate([a, b, c, d]), 1),
        "random-36x64-n9": (np.random.default_rng(1)
                            .standard_normal((36, 64)), 9),
        "positive-8x16-n3": (np.random.default_rng(2)
                             .uniform(0.5, 1.0, (8, 16)), 3),
        "more-than-fit-6x4-n5": (np.random.default_rng(3)
                                 .standard_normal((6, 4)), 5),
        "zero-row-5x4-n2": (np.concatenate(
            [np.zeros((1, 4)),
             np.random.default_rng(4).standard_normal((4, 4))]), 2),
    }


@pytest.mark.parametrize("case", sorted(_summary_cases()))
def test_sharing_map_equals_jax(case):
    """The same pairs from the same summaries, as numpy and as a f32
    tensor; the map keeps the reference's invariants."""
    summaries, n_share = _summary_cases()[case]
    L = summaries.shape[0]
    want = JSH.build_sharing_map(summaries, n_share)
    assert SH.build_sharing_map(summaries, n_share) == want
    f32 = summaries.astype(np.float32)
    assert (SH.build_sharing_map(torch.from_numpy(f32), n_share)
            == JSH.build_sharing_map(jnp.asarray(f32), n_share))
    np.testing.assert_array_equal(SH.layer_kv_similarity(summaries),
                                  JSH.layer_kv_similarity(summaries))
    for tgt, src in want.items():
        assert tgt > src and src not in want
    assert len(want) <= n_share
    assert (SH.shared_bytes_fraction(want, L)
            == JSH.shared_bytes_fraction(want, L))
    assert SR.cache_bytes_saved(want, L) == JSR.cache_bytes_saved(want, L)
    if case == "random-12x32-n4":
        assert len(want) == 4
        assert SH.shared_bytes_fraction(want, 12) == pytest.approx(8 / 12)
    if case == "identical-and-orthogonal-n1":
        (tgt, src), = want.items()
        assert {tgt, src} == {2, 3} or (tgt in (2, 3) and src < tgt)


def test_calibration_summaries_equal_jax():
    rng = np.random.default_rng(5)
    ks = rng.standard_normal((4, 2, 24, 2, 64)).astype(np.float32)
    vs = rng.standard_normal((4, 2, 24, 2, 64)).astype(np.float32)
    got = SH.calibration_summaries(torch.from_numpy(ks), torch.from_numpy(vs))
    want = JSH.calibration_summaries(jnp.asarray(ks), jnp.asarray(vs))
    assert got.dtype == torch.float32 and got.shape == (4, 2 * 2 * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=0)


@pytest.mark.parametrize("pname", ["full", "streaming", "h2o+kivi2"])
def test_materialize_equals_jax(pname):
    """`materialize` = `materialize_kv` + `validity_bias`, on one JAX
    compressed prompt carried over through the bridge."""
    budget, window = 16, 8
    if pname == "full":
        ts, js = (TC.CacheSpec(budget=48, policy="none"),
                  JC.CacheSpec(budget=48, policy="none"))
    else:
        ts = presets(budget, window)[pname].spec
        js = jax_presets(budget, window)[pname].spec
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    mass = rng.uniform(0, 1, (2, 40)).astype(np.float32)
    j = JC.compress_prompt(js, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mass), dtype=jnp.float32)
    j = j._replace(length=j.length.at[0].set(3))
    t = layer_kv_from_numpy(jax.tree.map(np.asarray, j))
    got = TC.materialize(t, ts, torch.float32)
    want = JC.materialize(j, js, jnp.float32)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F_ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def model():
    """tests/test_kvsharer_runner.py's model on both packages."""
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=4)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=4)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _greedy(lg):
    return np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-plain", "reference"])
def test_empty_mapping_matches_scanned_and_jax(model, use_kernels):
    """With no shared layer the runner is the model: its logits equal the
    port's `M.prefill` / `M.decode_step` and the JAX runner's."""
    jcfg, jp, cfg, p = model
    cfg = cfg.replace(use_kernels=use_kernels)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    spec, jspec = TC.CacheSpec(budget=40), JC.CacheSpec(budget=40)
    lg_j, jc = JSR.shared_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  jspec, {})
    lg_s, cache = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, spec)
    lg_u, caches = SR.shared_prefill(p, cfg, {"tokens": torch.tensor(toks)},
                                     spec, {})
    assert len(caches) == cfg.num_layers and None not in caches
    _close(lg_u, lg_s.numpy(), "prefill vs scanned")
    _close(lg_u, lg_j, "prefill vs JAX runner")
    tok = _greedy(lg_j)
    for step in range(3):
        lg_j, jc = JSR.shared_decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                          jspec, {})
        lg_s, cache = M.decode_step(p, cfg, cache, torch.tensor(tok), spec)
        lg_u, caches = SR.shared_decode_step(p, cfg, caches,
                                             torch.tensor(tok), spec, {})
        _close(lg_u, lg_s.numpy(), f"decode {step} vs scanned")
        _close(lg_u, lg_j, f"decode {step} vs JAX runner")
        tok = _greedy(lg_j)


@pytest.mark.parametrize("seed", [2, 3])
def test_calibrate_sharing_picks_jax_map(model, seed):
    jcfg, jp, cfg, p = model
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 32))
    for n_share in (1, 2):
        want = JSR.calibrate_sharing(jp, jcfg, jnp.asarray(toks), n_share)
        got = SR.calibrate_sharing(p, cfg, torch.tensor(toks), n_share)
        assert got == want and len(got) == n_share


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-plain", "reference"])
def test_sharing_matches_jax_and_saves_memory(model, use_kernels):
    """tests/test_kvsharer_runner.py's sharing run on both packages: one
    shared layer stores no cache; prefill and 3 decode steps fed JAX's
    greedy tokens give JAX's logits, and the unshared caches equal
    JAX's."""
    jcfg, jp, cfg, p = model
    cfg = cfg.replace(use_kernels=use_kernels)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 32))
    mapping = JSR.calibrate_sharing(jp, jcfg, jnp.asarray(toks), n_share=1)
    assert SR.calibrate_sharing(p, cfg, torch.tensor(toks), 1) == mapping
    spec, jspec = TC.CacheSpec(budget=40), JC.CacheSpec(budget=40)
    lg_j, jc = JSR.shared_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  jspec, mapping)
    lg, caches = SR.shared_prefill(p, cfg, {"tokens": torch.tensor(toks)},
                                   spec, mapping)
    assert sum(c is None for c in caches) == 1
    assert [c is None for c in caches] == [c is None for c in jc]
    _close(lg, lg_j, "prefill")
    tok = _greedy(lg_j)
    for step in range(3):
        lg_j, jc = JSR.shared_decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                          jspec, mapping)
        lg, caches = SR.shared_decode_step(p, cfg, caches, torch.tensor(tok),
                                           spec, mapping)
        assert bool(torch.isfinite(lg).all())
        _close(lg, lg_j, f"decode {step}")
        tok = _greedy(lg_j)
    for i, (t, j) in enumerate(zip(caches, jc)):
        if j is None:
            assert t is None
            continue
        for f in ("length", "pos", "slot_pos"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"layer {i} {f}")
        np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), atol=ATOL,
                                   rtol=RTOL, err_msg=f"layer {i} k")
