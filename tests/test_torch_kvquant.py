"""The port's fused KIVI quantize-and-pack (B6) against the JAX package on
the CPU: `kquant_ref` / `vquant_ref` and the `ops.quantize_k` /
`quantize_v` / `quantize_kv_pair` dispatch (CPU tensors: the plain
versions) against `kquant_pallas` / `vquant_pallas` in interpret mode
and against `repro.kernels.kvquant.ref`, over the cases of
tests/test_kernels.py (and, for the pair, D 20).

Against the jnp reference (which divides exactly, as the port does):
codes and zeros exact, scales within rtol 1e-6 (the convention of
tests/test_torch_cache.py; the readings are 0). Against the Pallas
kernels in interpret mode: zeros exact, scales within rtol 1e-6, and
codes exact except a difference of one level where the port's own
quotient (x - lo) / scale lies within 1e-5 of a .5 tie. Under `jax.jit`
XLA turns the division by the constant `levels` into a multiplication
by its reciprocal, so the Pallas kernels' scale is one f32 ulp off the
exact quotient in some channels, and a bf16 input that sits on a tie
rounds the other way (tests/test_kernels.py compares dequantized values
for the same reason). Then the serving path's two call sites —
`plan_group_flush` (through the quantized appends, dense and paged) and
`compress_prompt` — give the same packed store with `use_kernels` True
and False."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax.numpy as jnp
import numpy as np

from repro.kernels.kvquant import kernel as jkq
from repro.kernels.kvquant import ref as jref
from repro_torch.core import cache as TC
from repro_torch.core import paging as TP
from repro_torch.core import quantization as TQ
from repro_torch.core.policy import presets
from repro_torch.kernels.kvquant import ops as kvq
from repro_torch.kernels.kvquant import ref as kref

SCALE_RTOL = 1e-6
K_CASES = [(1, 64, 2, 32, 16), (2, 128, 4, 64, 32), (1, 32, 1, 128, 32)]
V_CASES = [(2, 64, 2, 32, 16), (1, 128, 8, 64, 64)]
PAIR_CASES = [(1, 64, 2, 32, 16), (2, 32, 3, 20, 16), (1, 128, 4, 64, 32)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, seed, mult, dt):
    """numpy f32 values, rounded to `dt` on both sides (bf16 exact)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.tensor(x * mult).to(DTYPES[dt][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dt][1])


TIE = 1e-5


def _same(got, want, what, *, x=None, bits=None, per_channel=None):
    """`x` given: codes may differ by one level at the ties of the
    port's quotient (a jitted side's reciprocal scale); else exact."""
    (gp, gs, gz), (wp, ws, wz) = got, want
    if x is None:
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp),
                                      err_msg=f"{what} codes")
    else:
        D = x.shape[-1]
        a = kref.unpack_ref(gp, bits, D).numpy()
        b = kref.unpack_ref(torch.tensor(np.asarray(wp)), bits, D).numpy()
        if per_channel:
            G = x.shape[1] // gs.shape[1]
            lo = np.repeat(gz.numpy(), G, axis=1)
            sc = np.repeat(gs.numpy(), G, axis=1)
        else:
            lo, sc = gz.numpy()[..., None], gs.numpy()[..., None]
        quot = (x.float().numpy() - lo) / sc
        tie = np.abs(quot - np.floor(quot) - 0.5) <= TIE
        diff = np.abs(a - b)
        bad = (diff > 1) | ((diff == 1) & ~tie)
        assert not bad.any(), (f"{what} codes: {int(bad.sum())} differ "
                               f"beyond a tie")
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz),
                                  err_msg=f"{what} zero")
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCALE_RTOL,
                               atol=0, err_msg=f"{what} scale")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("B,S,H,D,G", K_CASES)
def test_kquant_matches_pallas(bits, dt, B, S, H, D, G):
    t, j = _x((B, S, H, D), 0, 2.0, dt)
    want = jkq.kquant_pallas(j, bits=bits, group=G, interpret=True)
    tie = dict(x=t, bits=bits, per_channel=True)
    _same(kref.kquant_ref(t, bits, G), want, "kquant_ref vs pallas", **tie)
    _same(kvq.quantize_k(t, bits=bits, group=G), want,
          "quantize_k vs pallas", **tie)
    _same(kref.kquant_ref(t, bits, G), jref.kquant_ref(j, bits, G),
          "kquant_ref vs jnp ref")
    _same(kvq.quantize_k(t, bits=bits, group=G), jref.kquant_ref(j, bits, G),
          "quantize_k vs jnp ref")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("B,S,H,D,G", V_CASES)
def test_vquant_matches_pallas(bits, dt, B, S, H, D, G):
    t, j = _x((B, S, H, D), 1, 3.0, dt)
    want = jkq.vquant_pallas(j, bits=bits, group=G, interpret=True)
    tie = dict(x=t, bits=bits, per_channel=False)
    _same(kref.vquant_ref(t, bits), want, "vquant_ref vs pallas", **tie)
    _same(kvq.quantize_v(t, bits=bits, group=G), want,
          "quantize_v vs pallas", **tie)
    _same(kref.vquant_ref(t, bits), jref.vquant_ref(j, bits),
          "vquant_ref vs jnp ref")
    _same(kvq.quantize_v(t, bits=bits, group=G), jref.vquant_ref(j, bits),
          "quantize_v vs jnp ref")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("B,S,H,D,G", PAIR_CASES)
def test_kv_pair_matches_pallas(bits, dt, B, S, H, D, G):
    """`quantize_kv_pair` (the cache's one call per flush or admission)
    against `kquant_pallas` on k and `vquant_pallas` on v, with the
    bounds of the two tests above, and equal to the two standalone
    dispatchers exactly."""
    tk, jk = _x((B, S, H, D), 2, 2.0, dt)
    tv, jv = _x((B, S, H, D), 3, 3.0, dt)
    got_k, got_v = kvq.quantize_kv_pair(tk, tv, bits=bits, group=G)
    _same(got_k, jkq.kquant_pallas(jk, bits=bits, group=G, interpret=True),
          "pair K vs pallas", x=tk, bits=bits, per_channel=True)
    _same(got_v, jkq.vquant_pallas(jv, bits=bits, group=G, interpret=True),
          "pair V vs pallas", x=tv, bits=bits, per_channel=False)
    apart = (kvq.quantize_k(tk, bits=bits, group=G)
             + kvq.quantize_v(tv, bits=bits, group=G))
    for a, b in zip(got_k + got_v, apart):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_round_trip(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, (3, 4, 16))
    p = kref.pack_ref(torch.tensor(q), bits)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jref.pack_ref(jnp.asarray(q), bits)))
    assert p.shape[-1] == 16 * bits // 8
    np.testing.assert_array_equal(kref.unpack_ref(p, bits, 16).numpy(), q)
    # the dequantized round trip is within half a step of the input
    t, _ = _x((1, 32, 2, 16), bits, 2.0, "f32")
    pk, sk, zk = kref.kquant_ref(t, bits, 16)
    d = kref.dequant_k_ref(pk, sk, zk, bits, 16, torch.float32)
    assert float((d - t).abs().max()) <= float(sk.max()) / 2 + 1e-6
    pv, sv, zv = kref.vquant_ref(t, bits)
    d = kref.dequant_v_ref(pv, sv, zv, bits, torch.float32)
    assert float((d - t).abs().max()) <= float(sv.max()) / 2 + 1e-6


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fused_equals_quantization_module(bits):
    """`quantize_kv` with the kernel (its plain version here), with
    `core.quantization` + `pack_codes`, and from the two standalone
    dispatchers `quantize_k` + `quantize_v` on the same k and v: the
    same packed codes, scales and zeros, in the same layouts, bit for
    bit."""
    spec = TC.CacheSpec(budget=32, window=16, group=16, bits=bits,
                        policy="streaming")
    k, _ = _x((2, 32, 2, 8), 5, 2.0, "bf16")
    v, _ = _x((2, 32, 2, 8), 6, 2.0, "bf16")
    k[0, :16, 1] = 0.25                          # a constant group: 1e-8 floor
    fused = TC.quantize_kv(k, v, spec, use_kernels=True)
    plain = TC.quantize_kv(k, v, spec, use_kernels=False)
    kp, ks, kz = kvq.quantize_k(k, bits=bits, group=16)
    vp, vs, vz = kvq.quantize_v(v, bits=bits, group=16)
    apart = (TQ.Quantized(kp, ks[:, :, None], kz[:, :, None]),
             TQ.Quantized(vp, vs[..., None], vz[..., None]))
    for other in (plain, apart):
        for a, b in zip(fused, other):
            for f in TQ.Quantized._fields:
                ta, tb = getattr(a, f), getattr(b, f)
                assert ta.shape == tb.shape and ta.dtype == tb.dtype, f
                assert torch.equal(ta, tb), f


def _kivi_spec():
    return presets(budget=16, window=8)["kivi2"].spec


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_flush_and_compress_same_store_either_quantizer(paged):
    """A prompt compressed and then appended through three ring flushes
    (eviction at budget included): every leaf of the store equal with
    `use_kernels` True and False."""
    spec = _kivi_spec()
    B, S_p, H, D = 2, 24, 2, 16
    r = np.random.default_rng(9)
    k = torch.tensor(r.standard_normal((B, S_p, H, D)), dtype=torch.float32)
    v = torch.tensor(r.standard_normal((B, S_p, H, D)), dtype=torch.float32)
    mass = torch.zeros(B, S_p)
    toks = torch.tensor(r.standard_normal((26, 2, B, H, D)),
                        dtype=torch.float32)

    def run(uk):
        lc = TC.compress_prompt(spec, k, v, mass, dtype=torch.float32,
                                use_kernels=uk)
        if paged:
            S = lc.scores.shape[1]
            n_max = S // spec.group
            pg = TP.init_paged_kv(spec, B, S_p, H, D, n_blocks=B * n_max,
                                  block_len=spec.group, dtype=torch.float32)
            for b in range(B):
                one = TC.LayerKV(*(t[b:b + 1] if t.dim() else t for t in lc))
                ids = torch.arange(b * n_max, (b + 1) * n_max,
                                   dtype=torch.int32)
                TP.insert_request_paged(pg, b, one, ids, batch_axis=0)
            lc = pg
        for t in range(toks.shape[0]):
            TC.append_token(lc, spec, toks[t, 0], toks[t, 1],
                            ring_full=None, use_kernels=uk)
        return lc

    a, b = run(True), run(False)
    for f in type(a)._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_refuses_what_it_does_not_take():
    """The CUDA wrappers take CUDA tensors only (a CPU tensor goes
    through `quantize_k` / `quantize_v` / `quantize_kv_pair` to the plain
    versions)."""
    x = torch.zeros(1, 32, 2, 16)
    for fn in (kvq.kquant_cuda, kvq.vquant_cuda,
               lambda x, **kw: kvq.kvquant_cuda(x, x, **kw)):
        with pytest.raises(ValueError):
            fn(x, bits=2, group=16)
