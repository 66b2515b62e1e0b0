"""The port's library-level compression functions against the JAX package
on the CPU: GEAR / QAQ and the KIVI dequantizers
(`core/quantization.py`), Lexico / PQCache (`core/lexico.py`), the
eviction helpers (`core/eviction.py`) and the kernel packages' last plain
helpers (`kvquant/ref.py:pack_ref` / `unpack_ref`,
`decode_qattn/ref.py:decode_qattn_ref`).

The random draws (GEAR's start vectors, the Lexico dictionary, PQ's
initial centroids) are JAX's own, handed out through the port's
monkeypatched draw functions (`quantization.normal`, `lexico.choice`). Bounds: GEAR's ``u @ vt`` and
reconstruction within 1e-5 (QR's column signs may differ between LAPACK
builds, so ``u`` and ``vt`` are not compared apart), outlier indices
exact; QAQ bit widths exact, ties included; Lexico indices exact,
coefficients within 1e-6 (absolute + relative); PQ centroids within
1e-6, codes exact, MIPS scores within 1e-5; the eviction helpers within 1e-6; pack / unpack
exact; decode_qattn_ref within 1e-5. The JAX package's own cases
(tests/test_quantization.py, test_lexico_pq.py, test_policies.py) run
on the port too."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import eviction as JEV
from repro.core import lexico as JLX
from repro.core import quantization as JQ
from repro.kernels.decode_qattn import ref as jdq_ref
from repro.kernels.kvquant import ref as jkvq_ref
from repro_torch.core import eviction as EV
from repro_torch.core import lexico as LX
from repro_torch.core import quantization as Q
from repro_torch.kernels.decode_qattn import ref as dq_ref
from repro_torch.kernels.kvquant import ref as kvq_ref


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_normal(key):
    """A stand-in for a port draw function that hands out JAX's draws."""
    return lambda shape, generator, device: _t(
        jax.random.normal(key, tuple(shape), jnp.float32))


# ---------------------------------------------------------------------------
# KIVI dequantizers, the error bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,group", [(2, 8), (4, 16), (8, 8)])
def test_dequantizers_and_bound_equal_jax(bits, group):
    k = _np((2, 32, 2, 8), seed=bits, scale=3.0)
    tq = Q.quantize_k_per_channel(_t(k), bits, group)
    jq = JQ.quantize_k_per_channel(jnp.asarray(k), bits, group)
    got = Q.dequantize_k_per_channel(tq, group, dtype=torch.float32)
    want = JQ.dequantize_k_per_channel(jq, group, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    tv, jv = Q.quantize_v_per_token(_t(k), bits), \
        JQ.quantize_v_per_token(jnp.asarray(k), bits)
    np.testing.assert_allclose(
        Q.dequantize_v_per_token(tv, torch.float32).numpy(),
        np.asarray(JQ.dequantize_v_per_token(jv, jnp.float32)),
        atol=1e-6, rtol=0)
    assert Q.dequantize_v_per_token(tv).dtype == torch.bfloat16
    for dims in ((-1,), (-3,)):
        np.testing.assert_allclose(
            Q.quant_error_bound(_t(k), bits, dims).numpy(),
            np.asarray(JQ.quant_error_bound(jnp.asarray(k), bits, dims)),
            rtol=1e-6, atol=0)
    # the per-group bound holds (tests/test_quantization.py's property)
    assert float((got - _t(k)).abs().max()) <= float(tq.scale.max()) / 2 + 1e-4


def test_per_channel_beats_per_token_on_channel_outliers():
    """tests/test_quantization.py: with a channel outlier, per-channel
    keys keep the other channels far better than per-token ones."""
    k = _np((1, 128, 2, 16), seed=3)
    k[..., 0] *= 50.0
    kt = _t(k)
    deq_c = Q.dequantize_k_per_channel(Q.quantize_k_per_channel(kt, 4, 128),
                                       group=128, dtype=torch.float32)
    deq_t = Q.dequantize_v_per_token(Q.quantize_v_per_token(kt, 4),
                                     dtype=torch.float32)
    err_c = float((deq_c - kt)[..., 1:].abs().mean())
    err_t = float((deq_t - kt)[..., 1:].abs().mean())
    assert err_c < err_t / 5


# ---------------------------------------------------------------------------
# GEAR
# ---------------------------------------------------------------------------


GEAR_CASES = {"2bit-r4": (2, 4, 16, (2, 32, 64)),
              "4bit-r2": (4, 2, 8, (3, 16, 24)),
              "2bit-r8-2d": (2, 8, 32, (48, 40))}


@pytest.mark.parametrize("case", sorted(GEAR_CASES))
def test_gear_equals_jax(case, monkeypatch):
    bits, rank, n_out, shape = GEAR_CASES[case]
    x = _np(shape, seed=4)
    key = jax.random.key(5)
    monkeypatch.setattr(Q, "normal", _jax_normal(key))
    t = Q.gear_compress(_t(x), bits=bits, rank=rank, n_outliers=n_out)
    j = JQ.gear_compress(jnp.asarray(x), bits=bits, rank=rank,
                         n_outliers=n_out, key=key)
    np.testing.assert_array_equal(t.base.q.numpy(), np.asarray(j.base.q))
    np.testing.assert_allclose((t.u @ t.vt).numpy(), np.asarray(j.u @ j.vt),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.outlier_idx.numpy(),
                                  np.asarray(j.outlier_idx))
    np.testing.assert_allclose(t.outlier_vals.numpy(),
                               np.asarray(j.outlier_vals), atol=1e-5, rtol=0)
    got = Q.gear_decompress(t, shape, torch.float32)
    want = JQ.gear_decompress(j, shape, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert Q.gear_decompress(t, shape).dtype == torch.bfloat16
    # tests/test_quantization.py: the low-rank + outlier terms improve on
    # the base quantization
    base = Q._minmax_quant(_t(x), bits, dims=(-1,))
    base_err = float((base.dequantize(torch.float32) - _t(x)).abs().mean())
    assert float((got - _t(x)).abs().mean()) < base_err


def test_gear_default_generator_is_deterministic():
    x = _t(_np((2, 16, 32), seed=6))
    a, b = (Q.gear_compress(x, bits=2, rank=4, n_outliers=8)
            for _ in range(2))
    assert torch.equal(a.u @ a.vt, b.u @ b.vt)
    assert torch.equal(a.outlier_idx, b.outlier_idx)


def test_scatter_last_equals_jax():
    x = _np((2, 3, 20), seed=7)
    idx = np.stack([np.random.default_rng(s).permutation(20)[:5]
                    for s in range(6)]).reshape(2, 3, 5).astype(np.int32)
    vals = _np((2, 3, 5), seed=8)
    got = Q._scatter_last(_t(x), _t(idx).long(), _t(vals))
    want = JQ._scatter_last(jnp.asarray(x), jnp.asarray(idx),
                            jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# QAQ
# ---------------------------------------------------------------------------


QAQ_SENS = {
    "uniform": lambda: np.random.default_rng(9).uniform(0, 1, 64),
    "ties": lambda: np.round(np.random.default_rng(10).uniform(0, 1, 64),
                             1),
    "all-equal": lambda: np.ones(40),
    "2d": lambda: np.random.default_rng(11).uniform(0, 1, (4, 12)),
}


@pytest.mark.parametrize("budget", [2.0, 3.0, 4.0, 5.5, 6.0, 8.0])
@pytest.mark.parametrize("sens", sorted(QAQ_SENS))
def test_qaq_bit_allocation_equals_jax(sens, budget):
    s = QAQ_SENS[sens]().astype(np.float32)
    got = Q.qaq_bit_allocation(_t(s), budget)
    want = JQ.qaq_bit_allocation(jnp.asarray(s), budget)
    assert got.dtype == torch.int32 and got.shape == s.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # tests/test_quantization.py: the budget holds, more sensitive never
    # gets fewer bits
    assert float(got.float().mean()) <= budget + 0.6
    b_sorted = got.reshape(-1)[torch.argsort(_t(s).reshape(-1), stable=True)]
    assert bool((torch.diff(b_sorted) >= 0).all())


# ---------------------------------------------------------------------------
# Lexico and PQCache
# ---------------------------------------------------------------------------


def _dictionaries(monkeypatch, n_atoms, d, seed):
    key = jax.random.key(seed)
    monkeypatch.setattr(Q, "normal", _jax_normal(key))
    t = LX.make_dictionary(n_atoms, d)
    j = JLX.make_dictionary(key, n_atoms, d)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
    return t, j


@pytest.mark.parametrize("sparsity", [2, 4, 8])
def test_lexico_equals_jax(sparsity, monkeypatch):
    td, jd = _dictionaries(monkeypatch, 256, 32, seed=0)
    x = _np((64, 32), seed=12)
    t = LX.lexico_encode(_t(x), td, sparsity)
    j = JLX.lexico_encode(jnp.asarray(x), jd, sparsity)
    assert t.idx.dtype == torch.int32
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    # within 1e-6 relative: the residual products sum in another order
    np.testing.assert_allclose(t.coef.numpy(), np.asarray(j.coef),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(LX.lexico_decode(t, td).numpy(),
                               np.asarray(JLX.lexico_decode(j, jd)),
                               atol=1e-6, rtol=1e-6)
    assert LX.lexico_bytes_per_vector(sparsity) == \
        JLX.lexico_bytes_per_vector(sparsity)


def test_lexico_sparsity_monotone():
    """tests/test_lexico_pq.py on the port's own draws."""
    D = LX.make_dictionary(256, 32, generator=torch.Generator().manual_seed(0))
    x = _t(_np((64, 32), seed=1))
    errs = []
    for s in (2, 4, 8):
        xh = LX.lexico_decode(LX.lexico_encode(x, D, s), D)
        errs.append(float(((x - xh) ** 2).sum(-1).mean()))
    assert errs[0] > errs[1] > errs[2]
    assert LX.lexico_bytes_per_vector(4) == 16.0


def _clustered(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, 32)) * 3
    x = centers[rng.integers(0, 8, 256)] + 0.1 * rng.standard_normal((256, 32))
    return x.astype(np.float32)


PQ_CASES = {"clustered-m4-k16": (_clustered, 4, 16, 8),
            "gauss-m4-k32-12it": (lambda s: _np((128, 32), s), 4, 32, 12),
            "gauss-m8-k8": (lambda s: _np((96, 64), s), 8, 8, 8)}


@pytest.mark.parametrize("case", sorted(PQ_CASES))
def test_pq_equals_jax(case, monkeypatch):
    make, m, k, iters = PQ_CASES[case]
    x = make(13)
    key = jax.random.key(14)
    n = x.shape[0]
    monkeypatch.setattr(LX, "choice", lambda n_, k_, g, dev: _t(
        jax.random.choice(key, n_, (k_,), replace=False)).long())
    tcb = LX.pq_train(_t(x), m, k, iters)
    jcb = JLX.pq_train(key, jnp.asarray(x), m, k, iters)
    np.testing.assert_allclose(tcb.centroids.numpy(),
                               np.asarray(jcb.centroids), atol=1e-6, rtol=0)
    tc, jc = LX.pq_encode(tcb, _t(x)), JLX.pq_encode(jcb, jnp.asarray(x))
    assert tc.dtype == torch.uint8 and tc.shape == (n, m)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    xh = LX.pq_decode(tcb, tc)
    np.testing.assert_allclose(xh.numpy(), np.asarray(JLX.pq_decode(jcb, jc)),
                               atol=1e-6, rtol=0)
    q = _np((x.shape[1],), seed=15)
    got = LX.pq_mips_scores(tcb, tc, _t(q))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JLX.pq_mips_scores(jcb, jc, jnp.asarray(q))),
        atol=1e-5, rtol=0)
    # tests/test_lexico_pq.py: MIPS equals the exact product on the
    # decoded vectors
    np.testing.assert_allclose(got.numpy(), (xh @ _t(q)).numpy(), atol=1e-4,
                               rtol=1e-4)
    if case.startswith("clustered"):
        err = float(((_t(x) - xh) ** 2).sum(-1).mean())
        base = float(((_t(x) - _t(x).mean(0)) ** 2).sum(-1).mean())
        assert err < base / 4


def test_choice_draws_distinct_indices():
    idx = LX.choice(50, 20, torch.Generator().manual_seed(0), "cpu")
    assert len(set(idx.tolist())) == 20 and int(idx.max()) < 50


# ---------------------------------------------------------------------------
# The eviction helpers
# ---------------------------------------------------------------------------


def test_merge_evicted_equals_jax():
    k, v = _np((2, 12, 3, 8), 16), _np((2, 12, 3, 8), 17)
    rng = np.random.default_rng(18)
    keep = rng.uniform(size=(2, 12)) < 0.5
    keep[1] = True                                   # nothing evicted
    w = rng.uniform(size=(2, 12)).astype(np.float32)
    tk, tv = EV.merge_evicted(_t(k), _t(v), _t(keep), _t(w))
    jk, jv = JEV.merge_evicted(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(keep), jnp.asarray(w))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    # tests/test_policies.py's weighted mean
    k1 = torch.arange(8, dtype=torch.float32).reshape(1, 4, 1, 2)
    kc, _ = EV.merge_evicted(k1, k1, torch.tensor([[True, False, False, True]]),
                             torch.tensor([[1.0, 3.0, 1.0, 1.0]]))
    np.testing.assert_allclose(kc[0, 0].numpy(),
                               ((3.0 * k1[0, 1, 0] + k1[0, 2, 0]) / 4).numpy(),
                               rtol=1e-6)


def test_retrieval_heads_and_razor_budgets_equal_jax():
    rng = np.random.default_rng(19)
    mass = rng.uniform(size=(2, 4, 16)).astype(np.float32)
    mass[0, 0, 8:] = 0          # head 0 of row 0: long-range only
    mass[1, 2] = 0              # an all-zero head
    pos = np.stack([np.arange(16), np.arange(16) + 5]).astype(np.int32)
    got = EV.retrieval_head_scores(_t(mass), _t(pos), window=8)
    want = JEV.retrieval_head_scores(jnp.asarray(mass), jnp.asarray(pos), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    for thresh in (0.1, 0.3):
        np.testing.assert_array_equal(
            EV.razor_head_budgets(got, 1024, 64, thresh).numpy(),
            np.asarray(JEV.razor_head_budgets(want, 1024, 64, thresh)))
    # tests/test_policies.py's two heads
    m = torch.zeros(1, 2, 16)
    m[0, 0, :4] = 1.0
    m[0, 1, -4:] = 1.0
    frac = EV.retrieval_head_scores(m, torch.arange(16)[None], window=8)
    assert float(frac[0]) > 0.9 and float(frac[1]) < 0.1
    assert EV.razor_head_budgets(frac, 1024, 64).tolist() == [1024, 64]


def test_lookm_and_vq_mask_equal_jax():
    rng = np.random.default_rng(20)
    mass = rng.uniform(size=(2, 10)).astype(np.float32)
    toks = rng.integers(0, 400, (2, 10)).astype(np.int32)
    is_img = np.asarray(JEV.vq_token_mask(jnp.asarray(toks), 100, 300))
    np.testing.assert_array_equal(
        EV.vq_token_mask(_t(toks), 100, 300).numpy(), is_img)
    for boost in (4.0, 1.5):
        np.testing.assert_allclose(
            EV.lookm_scores(_t(mass), _t(is_img), boost).numpy(),
            np.asarray(JEV.lookm_scores(jnp.asarray(mass),
                                        jnp.asarray(is_img), boost)),
            atol=1e-6, rtol=0)
    # tests/test_lexico_pq.py: every text token outranks every image token
    img = torch.tensor([[True, True, False, False, True, False, True, False]])
    s = EV.lookm_scores(torch.ones(1, 8), img)
    assert float(s[0][~img[0]].min()) > float(s[0][img[0]].max())
    assert EV.vq_token_mask(torch.tensor([[5, 100, 200, 300]]), 100,
                            300).tolist() == [[False, True, True, False]]


# ---------------------------------------------------------------------------
# The kernel packages' plain helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_ref_equal_jax(bits):
    codes = np.random.default_rng(21).integers(
        0, 1 << bits, (2, 8, 3, 32)).astype(np.uint8)
    got = kvq_ref.pack_ref(_t(codes), bits)
    want = jkvq_ref.pack_ref(jnp.asarray(codes), bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = kvq_ref.unpack_ref(got, bits, 32)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jkvq_ref.unpack_ref(want, bits,
                                                                 32)))
    np.testing.assert_array_equal(back.numpy(), codes.astype(np.int32))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_decode_qattn_ref_equals_jax(bits):
    B, S, Hq, Hkv, D, G = 2, 32, 8, 2, 64, 16
    k, v = _np((B, S, Hkv, D), 22), _np((B, S, Hkv, D), 23)
    q = _np((B, Hq, D), 24)
    bias = np.zeros((B, S), np.float32)
    bias[1, 20:] = -1e30
    kq, ks, kz = jkvq_ref.kquant_ref(jnp.asarray(k), bits, G)
    vq, vs, vz = jkvq_ref.vquant_ref(jnp.asarray(v), bits)
    want = jdq_ref.decode_qattn_ref(jnp.asarray(q), kq, ks, kz, vq, vs, vz,
                                    jnp.asarray(bias), bits=bits, group=G)
    got = dq_ref.decode_qattn_ref(_t(q), *map(_t, (kq, ks, kz, vq, vs, vz)),
                                  _t(bias), bits=bits, group=G)
    assert got.shape == (B, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
