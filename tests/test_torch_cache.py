"""The port's quantization and compressed KV cache against the JAX package
on the CPU: codes and integer leaves exact, float leaves within 1e-6."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cache as JC
from repro.core import quantization as JQ
from repro.core.policy import presets as jax_presets
from repro_torch.bridge import layer_kv_from_numpy
from repro_torch.core import cache as TC
from repro_torch.core import quantization as TQ
from repro_torch.core.policy import presets
from repro_torch.serving.engine import RingMirror

F_ATOL = 1e-6
POLICIES = ("full", "streaming", "h2o", "kivi2", "h2o+kivi2")
# the JAX side of the long append sequences, compiled once per spec
_j_append = jax.jit(JC.append_token, static_argnums=(1,))
_j_accumulate = jax.jit(JC.accumulate_scores, static_argnums=(1,))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rng(seed):
    return np.random.default_rng(seed)


def assert_kv_equal(t_lc, j_lc, what=""):
    for f in TC.LayerKV._fields:
        got = getattr(t_lc, f).numpy()
        want = np.asarray(getattr(j_lc, f))
        assert got.shape == want.shape, (what, f, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(got, want, atol=F_ATOL, rtol=0,
                                       err_msg=f"{what} {f}")


def _specs(budget=16, window=8):
    """(port spec, jax spec) per main-path preset; "full" as the engine
    builds it (uncompressed baseline with decode headroom)."""
    out = {}
    for name in POLICIES:
        if name == "full":
            out[name] = (TC.CacheSpec(budget=48, policy="none"),
                         JC.CacheSpec(budget=48, policy="none"))
        else:
            out[name] = (presets(budget, window)[name].spec,
                         jax_presets(budget, window)[name].spec)
    return out


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_codes(bits):
    q = _rng(bits).integers(0, 1 << bits, size=(3, 5, 2, 16)).astype(np.uint8)
    packed = TQ.pack_codes(_t(q), bits)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_codes(jnp.asarray(q),
                                                           bits)))
    np.testing.assert_array_equal(TQ.unpack_codes(packed, bits, 16).numpy(), q)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kivi_quantize(bits):
    x = _rng(10 + bits).standard_normal((2, 16, 3, 8)).astype(np.float32)
    x[0, :8, 1, 2] = 0.5              # a constant channel: the 1e-8 floor
    tk, jk = (TQ.quantize_k_per_channel(_t(x), bits, 8),
              JQ.quantize_k_per_channel(jnp.asarray(x), bits, 8))
    tv, jv = (TQ.quantize_v_per_token(_t(x), bits),
              JQ.quantize_v_per_token(jnp.asarray(x), bits))
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))


# ---------------------------------------------------------------------------
# prompt compression
# ---------------------------------------------------------------------------


def _prompt(B, S_p, H=2, D=16, seed=0):
    r = _rng(seed)
    k = r.standard_normal((B, S_p, H, D)).astype(np.float32)
    v = r.standard_normal((B, S_p, H, D)).astype(np.float32)
    mass = r.uniform(size=(B, S_p)).astype(np.float32)
    return k, v, mass


def _compress(specs, k, v, mass, **kw):
    ts, js = specs
    t = TC.compress_prompt(ts, _t(k), _t(v), _t(mass), dtype=torch.float32,
                           **kw)
    j = JC.compress_prompt(js, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mass), dtype=jnp.float32, **kw)
    return t, j


@pytest.mark.parametrize("S_p", [40, 24], ids=["selects", "headroom"])
@pytest.mark.parametrize("pname", POLICIES)
def test_compress_prompt(pname, S_p):
    """Every main-path preset; S_p=24 < budget+window pads candidates with
    -inf rows that tie with the ring's -inf — the lower-index tie-break
    decides which rows feed the quantized groups' K min/max."""
    k, v, mass = _prompt(2, S_p)
    t, j = _compress(_specs()[pname], k, v, mass)
    assert_kv_equal(t, j, pname)


def test_compress_prompt_logical_budget():
    k, v, mass = _prompt(2, 40, seed=3)
    t, j = _compress(_specs(budget=32)["h2o+kivi2"], k, v, mass,
                     logical_budget=24)
    assert_kv_equal(t, j, "logical budget")


def test_compress_prompt_ties_follow_lax_top_k():
    """Equal masses (and +inf sinks / -inf ring) everywhere: torch.topk's
    order would differ; the stable sort keeps JAX's lower-index picks."""
    k, v, _ = _prompt(1, 40, seed=4)
    mass = np.ones((1, 40), np.float32)
    mass[0, ::3] = 2.0
    t, j = _compress(_specs()["h2o"], k, v, mass)
    assert_kv_equal(t, j, "ties")


# ---------------------------------------------------------------------------
# decode appends, score accumulation, slot surgery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pname", POLICIES)
def test_append_token_through_eviction_and_flush(pname):
    """20 appends with score accumulation: dense stores evict, quantized
    rings flush (per row: row 1 is reset, then re-admitted, so the two
    rows sit at different ring phases); the port follows JAX leaf for
    leaf, and the engine's host ring mirror tracks `rlen` exactly."""
    specs = _specs()
    ts, js = specs[pname]
    k, v, mass = _prompt(2, 40, seed=5)
    t, j = _compress(specs[pname], k, v, mass)
    k1, v1, m1 = _prompt(1, 40, seed=6)
    t_in, j_in = _compress(specs[pname], k1, v1, m1)
    mirror = RingMirror(ts, 2)
    mirror.fill()
    r = _rng(7)
    for step in range(20):
        if step == 7:
            TC.reset_slot(t, 1, batch_axis=0)
            j = JC.reset_slot(j, 1, batch_axis=0)
            mirror.clear(1)
        if step == 12:
            TC.insert_request(t, 1, t_in, batch_axis=0)
            j = JC.insert_request(j, 1, j_in, batch_axis=0)
            mirror.fill(1)
        kn = r.standard_normal((2, 2, 16)).astype(np.float32)
        vn = r.standard_normal((2, 2, 16)).astype(np.float32)
        TC.append_token(t, ts, _t(kn), _t(vn), ring_full=mirror.advance())
        j = _j_append(j, js, jnp.asarray(kn), jnp.asarray(vn))
        am = r.uniform(size=(2, t.scores.shape[1] + t.rk.shape[1]))
        am = am.astype(np.float32)
        TC.accumulate_scores(t, ts, _t(am))
        j = _j_accumulate(j, js, jnp.asarray(am))
        assert_kv_equal(t, j, f"{pname} step {step}")
        if ts.quantized:
            np.testing.assert_array_equal(mirror.rlen, t.rlen.numpy())


def test_accumulate_scores_only_for_tracking_policies():
    k, v, mass = _prompt(2, 40, seed=8)
    am = _rng(9).uniform(size=(2, 24)).astype(np.float32)
    for pname in ("streaming", "h2o"):
        t, j = _compress(_specs()[pname], k, v, mass)
        before = t.scores.clone()
        TC.accumulate_scores(t, _specs()[pname][0], _t(am))
        j = JC.accumulate_scores(j, _specs()[pname][1], jnp.asarray(am))
        assert_kv_equal(t, j, pname)
        assert torch.equal(before, t.scores) == (pname == "streaming")


def test_stacked_insert_and_reset_slot():
    ts, js = _specs()["kivi2"]
    t = TC.stacked_kv(ts, 3, 4, 40, 2, 16, torch.float32)
    j = JC.stacked_kv(js, 3, 4, 40, 2, 16, jnp.float32)
    assert_kv_equal(t, j, "init")
    k, v, mass = _prompt(1, 40, seed=10)
    pt, pj = _compress((ts, js), k, v, mass)
    stack_t = TC.LayerKV(*(x[None].expand(3, *x.shape).clone() for x in pt))
    stack_j = JC.LayerKV(*(jnp.broadcast_to(x[None], (3, *x.shape))
                           for x in pj))
    TC.insert_request(t, 2, stack_t, batch_axis=1)
    j = JC.insert_request(j, 2, stack_j, batch_axis=1)
    assert_kv_equal(t, j, "insert")
    TC.reset_slot(t, 2, batch_axis=1)
    j = JC.reset_slot(j, 2, batch_axis=1)
    assert_kv_equal(t, j, "reset")


def test_validity_bias_and_materialize():
    for pname in ("streaming", "kivi2"):
        ts, js = _specs()[pname]
        k, v, mass = _prompt(2, 40, seed=11)
        t, j = _compress((ts, js), k, v, mass)
        t.length[0] = 3
        j = j._replace(length=j.length.at[0].set(3))
        np.testing.assert_array_equal(TC.validity_bias(t).numpy(),
                                      np.asarray(JC.validity_bias(j)))
        for got, want in zip(TC.materialize_kv(t, ts, torch.float32),
                             JC.materialize_kv(j, js, jnp.float32)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=F_ATOL, rtol=0)


def test_bridge_and_byte_accounting():
    ts, js = _specs()["h2o+kivi2"]
    k, v, mass = _prompt(2, 40, seed=12)
    j = JC.compress_prompt(js, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mass), dtype=jnp.bfloat16)
    t = layer_kv_from_numpy(j)
    assert t.rk.dtype == torch.bfloat16 and t.k.dtype == torch.int8
    np.testing.assert_array_equal(t.rk.float().numpy(),
                                  np.asarray(j.rk, np.float32))
    assert TC.cache_physical_bytes(t) == JC.cache_physical_bytes(j)
    for spec_t, spec_j in _specs().values():
        assert (TC.cache_logical_bytes_per_layer(spec_t, 64, 8, 128)
                == JC.cache_logical_bytes_per_layer(spec_j, 64, 8, 128))
