"""The port's CUDA kernels against their plain versions on the card.

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Marked `gpu`; without a CUDA device every test skips (decided in the
`cuda` fixture, so every xdist worker collects the same tests). Imports
no jax: it runs where only the port's dependencies are installed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced
from repro_torch.configs.granite_8b import CONFIG as GRANITE
from repro_torch.core import paging as TP
from repro_torch.core.policy import presets
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.decode_qattn.ref import (decode_attn_paged_ref,
                                                  decode_attn_ref, gather_pool)
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_chunk_ref,
                                                   flash_prefill_ref,
                                                   flash_verify_ref)
from repro_torch.kernels.kvquant import ops as kvq_ops
from repro_torch.kernels.kvquant.ref import (kquant_ref, unpack_ref,
                                             vquant_ref)
from repro_torch.nn import model as M
from repro_torch.nn import moe as moe_lib
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

pytestmark = pytest.mark.gpu

# (atol, rtol) of the outputs. Kernel and plain version both compute in
# f32 on the same inputs: they differ by f32 summation order and, for a
# bf16 output, by at most one bf16 ulp of the final rounding, which is
# <= 2^-7 |out|. Masses are f32 on both sides.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-4, 1e-2)}
MASS_TOL = (1e-5, 1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_inputs(dev, dt, bits, ring, B=8, S=512, W=128, Hq=32, Hkv=8,
                   D=128):
    """Main-path shapes (granite-8b); ragged rows and one empty slot."""
    g = torch.Generator(device=dev).manual_seed(bits + 2 * ring)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    length = torch.tensor([S, 300, 17, 0, S - 1, 128, 64, 1], device=dev)
    rlen = torch.tensor([W, 5, 1, 0, 64, W, 1, W - 1], device=dev)
    bias = torch.where(torch.arange(S, device=dev)[None] < length[:, None],
                       0.0, -1e30)
    if bits < 16:
        Dp = D * bits // 8
        k, v = (torch.randint(-128, 128, (B, S, Hkv, Dp), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
        # KIVI scales are range / levels: dequantized values stay O(1)
        # at every bit width, as in a real cache
        unit = 3.0 / ((1 << bits) - 1)
        meta = ((rnd(B, S // W, Hkv, D).abs() * 0.1 + 0.01) * unit,
                rnd(B, S // W, Hkv, D),
                (rnd(B, S, Hkv).abs() * 0.1 + 0.01) * unit, rnd(B, S, Hkv))
    else:
        k, v = rnd(B, S, Hkv, D, dtype=dt), rnd(B, S, Hkv, D, dtype=dt)
        meta = (None,) * 4
    ks, kz, vs, vz = meta
    if ring:
        rk, rv = rnd(B, W, Hkv, D, dtype=dt), rnd(B, W, Hkv, D, dtype=dt)
        rbias = torch.where(torch.arange(W, device=dev)[None]
                            < rlen[:, None], 0.0, -1e30)
    else:
        rk = rv = rbias = None
    return (rnd(B, Hq, D, dtype=dt), k, ks, kz, v, vs, vz, bias, rk, rv,
            rbias)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits,ring", [(2, True), (4, True), (8, True),
                                       (16, True), (16, False)])
@pytest.mark.parametrize("mass", [True, False], ids=["mass", "no-mass"])
def test_decode_attn_kernel_matches_plain(cuda, dt, bits, ring, mass):
    args = _decode_inputs(cuda, dt, bits, ring)
    out, m = dq_ops.decode_attn_cuda(*args, bits=bits, group=128,
                                     return_mass=mass, compute_dtype=dt)
    out_r, m_r = decode_attn_ref(*args, bits=bits, group=128,
                                 compute_dtype=dt)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), out_r.float(), atol=atol,
                               rtol=rtol)
    if mass:
        torch.testing.assert_close(m, m_r, atol=MASS_TOL[0],
                                   rtol=MASS_TOL[1])
    else:
        assert m is None


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,window,D", [(1024, 0, 128), (1000, 0, 128),
                                        (777, 200, 128), (300, 0, 64)])
def test_flash_prefill_kernel_matches_plain(cuda, dt, T, window, D):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = (torch.randn(2, T, h, D, generator=g, device=cuda).to(dt)
               for h in (32, 8, 8))
    out = fp_ops.flash_prefill_cuda(q, k, v, window=window)
    ref = flash_prefill_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _paged_inputs(dev, dt, bits, ring, B=8, Hq=32, Hkv=8, D=128, W=128,
                  S=512):
    """Main-path shapes: 128-row blocks (the group) for a quantized pool,
    16-row blocks for a dense one; a shuffled table over a pool with
    spare blocks, -1 past each row's length, one all -1 (free) slot.
    Returns (paged args, the same rows as dense-store args)."""
    bl = 128 if bits < 16 else 16
    n_max = S // bl
    nb = B * n_max + 5
    g = torch.Generator(device=dev).manual_seed(100 + bits + 2 * ring)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    length = torch.tensor([S, 300, 17, 0, S - 1, 128, 64, 1], device=dev)
    ids = torch.randperm(nb, generator=g, device=dev)[:B * n_max]
    used = (torch.arange(n_max, device=dev)[None] * bl) < length[:, None]
    tbl = torch.where(used, ids.view(B, n_max), -1).to(torch.int32)
    bias = torch.where(torch.arange(S, device=dev)[None] < length[:, None],
                       0.0, -1e30)
    if bits < 16:
        Dp = D * bits // 8
        pk, pv = (torch.randint(-128, 128, (nb, bl, Hkv, Dp), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        unit = 3.0 / ((1 << bits) - 1)
        meta = ((rnd(nb, bl // 128, Hkv, D).abs() * 0.1 + 0.01) * unit,
                rnd(nb, bl // 128, Hkv, D),
                (rnd(nb, bl, Hkv).abs() * 0.1 + 0.01) * unit, rnd(nb, bl, Hkv))
    else:
        pk, pv = rnd(nb, bl, Hkv, D, dtype=dt), rnd(nb, bl, Hkv, D, dtype=dt)
        meta = (None,) * 4
    if ring:
        rk, rv = rnd(B, W, Hkv, D, dtype=dt), rnd(B, W, Hkv, D, dtype=dt)
        rbias = torch.where(torch.arange(W, device=dev)[None] < torch.tensor(
            [W, 5, 1, 0, 64, W, 1, W - 1], device=dev)[:, None], 0.0, -1e30)
    else:
        rk = rv = rbias = None
    q = rnd(B, Hq, D, dtype=dt)
    ks, kz, vs, vz = meta
    paged = (q, tbl, pk, ks, kz, pv, vs, vz, bias, rk, rv, rbias)

    def gd(pool):
        return None if pool is None else gather_pool(pool, tbl).contiguous()

    dense = (q, gd(pk), gd(ks), gd(kz), gd(pv), gd(vs), gd(vz), bias, rk, rv,
             rbias)
    return paged, dense


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits,ring", [(2, True), (4, True), (16, True),
                                       (16, False)])
@pytest.mark.parametrize("mass", [True, False], ids=["mass", "no-mass"])
def test_paged_decode_kernel_matches_plain_and_dense(cuda, dt, bits, ring,
                                                     mass):
    """Against its plain version within TOL, and against the dense kernel
    on the same rows bit for bit (one kernel body, two row addressings)."""
    paged, dense = _paged_inputs(cuda, dt, bits, ring)
    kw = dict(bits=bits, group=128, return_mass=mass, compute_dtype=dt)
    out, m = dq_ops.decode_attn_paged_cuda(*paged, **kw)
    out_d, m_d = dq_ops.decode_attn_cuda(*dense, **kw)
    out_r, m_r = decode_attn_paged_ref(*paged, bits=bits, group=128,
                                       compute_dtype=dt)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), out_r.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(out, out_d)
    if mass:
        torch.testing.assert_close(m, m_r, atol=MASS_TOL[0],
                                   rtol=MASS_TOL[1])
        assert torch.equal(m, m_d)
    else:
        assert m is None


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "no-ring"])
@pytest.mark.parametrize("mass", [True, False], ids=["mass", "no-mass"])
def test_paged_decode_full_path_bit_equal_to_dense(cuda, dt, ring, mass):
    """The `full paged` serve case: a 16-bit pool of 16-row blocks, S 2112
    (several splits of the key axis, split boundaries inside blocks):
    within TOL of the plain version and bit-equal to the dense kernel on
    the same rows."""
    paged, dense = _paged_inputs(cuda, dt, 16, ring, S=2112)
    kw = dict(bits=16, group=128, return_mass=mass, compute_dtype=dt)
    out, m = dq_ops.decode_attn_paged_cuda(*paged, **kw)
    out_d, m_d = dq_ops.decode_attn_cuda(*dense, **kw)
    out_r, m_r = decode_attn_paged_ref(*paged, bits=16, group=128,
                                       compute_dtype=dt)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), out_r.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(out, out_d)
    if mass:
        torch.testing.assert_close(m, m_r, atol=MASS_TOL[0],
                                   rtol=MASS_TOL[1])
        assert torch.equal(m, m_d)


# edges of the key split: (bits, group, S, W, Hq, Hkv, D, valid main
# rows per slot, valid ring rows per slot) — a (lo, hi) range each
DECODE_EDGES = {
    # S+W = 2013: not a multiple of any split length (whole 32-key tiles)
    "ragged-split": (16, 1, 2000, 13, 32, 8, 128,
                     [(0, 2000), (0, 1500), (0, 0), (0, 1)],
                     [(0, 13), (0, 2), (0, 0), (0, 13)]),
    # S+W = 21: less than one split, one tile
    "below-one-split": (2, 8, 16, 5, 32, 8, 128,
                        [(0, 16), (0, 3), (0, 0), (0, 16)],
                        [(0, 5), (0, 0), (0, 0), (0, 1)]),
    # every unmasked key of slot 0 in one split, the others all masked;
    # slot 1 a window of keys across a split boundary
    "one-split-row": (16, 1, 2112, 0, 32, 8, 128,
                      [(1000, 1010), (250, 330), (0, 0), (0, 2112)], None),
    # the free slot (2) with mass over a quantized store and a ring
    "free-slot": (4, 128, 512, 128, 32, 8, 128,
                  [(0, 512), (0, 0), (0, 0), (0, 100)],
                  [(0, 128), (0, 7), (0, 0), (0, 0)]),
    "gq1": (16, 1, 700, 40, 8, 8, 64,
            [(0, 700), (0, 300), (0, 0), (0, 1)],
            [(0, 40), (0, 1), (0, 0), (0, 39)]),
    "gq1-2bit": (2, 8, 704, 40, 8, 8, 64,
                 [(0, 704), (0, 300), (0, 0), (0, 8)],
                 [(0, 40), (0, 1), (0, 0), (0, 39)]),
    "gq8": (16, 1, 1100, 128, 64, 8, 128,
            [(0, 1100), (0, 999), (0, 0), (0, 64)],
            [(0, 128), (0, 5), (0, 0), (0, 128)]),
    # qwen2.5-32b (Hq 40 / Hkv 8) and command-r-plus-104b (96 / 8): the
    # `full` store at S 2112 and the kivi2 store (512 + ring 128)
    "gq5": (16, 1, 2112, 0, 40, 8, 128,
            [(0, 2112), (0, 1100), (0, 0), (0, 33)], None),
    "gq5-2bit": (2, 128, 512, 128, 40, 8, 128,
                 [(0, 512), (0, 384), (0, 0), (0, 128)],
                 [(0, 128), (0, 1), (0, 0), (0, 127)]),
    "gq12": (16, 1, 2112, 0, 96, 8, 128,
             [(0, 2112), (0, 1100), (0, 0), (0, 33)], None),
    "gq12-2bit": (2, 128, 512, 128, 96, 8, 128,
                  [(0, 512), (0, 384), (0, 0), (0, 128)],
                  [(0, 128), (0, 1), (0, 0), (0, 127)]),
    # mixtral-8x22b (48 / 8): the `full` store of a 6144-token prompt
    # plus 64 new (its window masks the first rows of slot 0), and kivi2
    "gq6": (16, 1, 6208, 0, 48, 8, 128,
            [(2100, 6208), (0, 2048), (0, 0), (0, 33)], None),
    "gq6-2bit": (2, 128, 512, 128, 48, 8, 128,
                 [(0, 512), (0, 384), (0, 0), (0, 128)],
                 [(0, 128), (0, 1), (0, 0), (0, 127)]),
}


def _edge_inputs(dev, dt, bits, G, S, W, Hq, Hkv, D, valid, rvalid):
    g = torch.Generator(device=dev).manual_seed(S + W + Hq + bits)
    B = len(valid)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def bias_of(ranges, n):
        idx = torch.arange(n, device=dev)[None]
        lo = torch.tensor([r[0] for r in ranges], device=dev)[:, None]
        hi = torch.tensor([r[1] for r in ranges], device=dev)[:, None]
        return torch.where((idx >= lo) & (idx < hi), 0.0, -1e30)

    if bits < 16:
        Dp = D * bits // 8
        k, v = (torch.randint(-128, 128, (B, S, Hkv, Dp), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
        unit = 3.0 / ((1 << bits) - 1)
        meta = ((rnd(B, S // G, Hkv, D).abs() * 0.1 + 0.01) * unit,
                rnd(B, S // G, Hkv, D),
                (rnd(B, S, Hkv).abs() * 0.1 + 0.01) * unit, rnd(B, S, Hkv))
    else:
        k, v = rnd(B, S, Hkv, D, dtype=dt), rnd(B, S, Hkv, D, dtype=dt)
        meta = (None,) * 4
    ks, kz, vs, vz = meta
    if W:
        rk, rv = rnd(B, W, Hkv, D, dtype=dt), rnd(B, W, Hkv, D, dtype=dt)
        rbias = bias_of(rvalid, W)
    else:
        rk = rv = rbias = None
    return (rnd(B, Hq, D, dtype=dt), k, ks, kz, v, vs, vz, bias_of(valid, S),
            rk, rv, rbias)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(DECODE_EDGES))
def test_decode_attn_kernel_at_split_edges(cuda, dt, case):
    """B1 with mass at the edges of the split-KV design, against its
    plain version; a slot whose every key is masked (the free slot)
    softmaxes uniformly over all S+W keys, as the plain version does."""
    bits, G, S, W, Hq, Hkv, D, valid, rvalid = DECODE_EDGES[case]
    args = _edge_inputs(cuda, dt, bits, G, S, W, Hq, Hkv, D, valid, rvalid)
    kw = dict(bits=bits, group=G, return_mass=True, compute_dtype=dt)
    out, m = dq_ops.decode_attn_cuda(*args, **kw)
    out_r, m_r = decode_attn_ref(*args, bits=bits, group=G, compute_dtype=dt)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), out_r.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(m, m_r, atol=MASS_TOL[0], rtol=MASS_TOL[1])
    free = [i for i, r in enumerate(valid)
            if r[0] == r[1] and (not W or rvalid[i][0] == rvalid[i][1])]
    for i in free:
        torch.testing.assert_close(m[i], torch.full_like(m[i], Hq / (S + W)),
                                   atol=MASS_TOL[0], rtol=MASS_TOL[1])
    # a second call reuses the tickets the first left at zero
    out2, m2 = dq_ops.decode_attn_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(m, m2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 16])
@pytest.mark.parametrize("Hq", [40, 48, 64, 96],
                         ids=["gq5", "gq6", "gq8", "gq12"])
def test_paged_decode_kernel_at_real_gq(cuda, dt, bits, Hq):
    """B3 at the head groups of qwen2.5-32b, mixtral-8x22b, chameleon-34b /
    kimi-k2-1t-a32b and command-r-plus-104b (Hkv 8, D 128) with mass and
    a ring: within TOL
    of its plain version and bit-equal to B1 on the same rows."""
    paged, dense = _paged_inputs(cuda, dt, bits, True, Hq=Hq)
    kw = dict(bits=bits, group=128, return_mass=True, compute_dtype=dt)
    out, m = dq_ops.decode_attn_paged_cuda(*paged, **kw)
    out_d, m_d = dq_ops.decode_attn_cuda(*dense, **kw)
    out_r, m_r = decode_attn_paged_ref(*paged, bits=bits, group=128,
                                       compute_dtype=dt)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), out_r.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(m, m_r, atol=MASS_TOL[0], rtol=MASS_TOL[1])
    assert torch.equal(out, out_d) and torch.equal(m, m_d)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (40, 8, 128),
                                      (48, 8, 128), (96, 8, 128)],
                         ids=["gq1-mha", "gq5", "gq6", "gq12"])
def test_flash_kernels_at_real_gq(cuda, dt, Hq, Hkv, D):
    """B2 on one 2048-row prompt and B4 on its 512-row segments at the
    head groups of minicpm-2b (MHA, D 64), qwen2.5-32b, mixtral-8x22b and
    command-r-plus-104b: each within TOL of its plain version, the
    segments bit-equal to the monolithic kernel."""
    g = torch.Generator(device=cuda).manual_seed(Hq + D)
    T, C = 2048, 512
    q, k, v = (torch.randn(1, T, h, D, generator=g, device=cuda).to(dt)
               for h in (Hq, Hkv, Hkv))
    atol, rtol = TOL[dt]
    whole = fp_ops.flash_prefill_cuda(q, k, v)
    ref = flash_prefill_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(whole.float(), ref.float(), atol=atol,
                               rtol=rtol)
    outs = []
    for c0 in range(0, T, C):
        ks, vs = torch.zeros_like(k), torch.zeros_like(v)
        ks[:, :c0 + C], vs[:, :c0 + C] = k[:, :c0 + C], v[:, :c0 + C]
        out = fp_ops.flash_prefill_chunk_cuda(q[:, c0:c0 + C], ks, vs,
                                              q_offset=c0)
        ref = flash_prefill_chunk_ref(q[:, c0:c0 + C], ks, vs, q_offset=c0)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        outs.append(out)
    assert torch.equal(torch.cat(outs, 1), whole)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,window", [
    (2, 1000, 8, 8, 128, 0),       # Hq = Hkv, T not a multiple of 64
    (2, 777, 8, 8, 64, 200),       # ... under a window, D 64
    (1, 65, 32, 8, 64, 0),         # one row past a tile
    (2, 1, 32, 8, 128, 0),         # a single row
    (1, 2048, 32, 8, 128, 64),     # window tiles skipped, the serve width
    (1, 6144, 48, 8, 128, 4096)])  # mixtral's longest prompt and window
def test_flash_prefill_kernel_at_tile_edges(cuda, dt, B, T, Hq, Hkv, D,
                                            window):
    g = torch.Generator(device=cuda).manual_seed(T + D + window)
    q, k, v = (torch.randn(B, T, h, D, generator=g, device=cuda).to(dt)
               for h in (Hq, Hkv, Hkv))
    out = fp_ops.flash_prefill_cuda(q, k, v, window=window)
    ref = flash_prefill_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,C,window,D", [(1024, 256, 0, 128),
                                          (1000, 384, 0, 128),
                                          (777, 128, 200, 128),
                                          (300, 64, 0, 64)])
def test_flash_chunk_kernel_matches_plain_and_monolithic(cuda, dt, T, C,
                                                         window, D):
    """Each segment against its plain version over a scratch whose rows
    past the segment are zero; with C a multiple of the 64-row tile, the
    concatenated segments equal the monolithic kernel bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(T + C)
    q, k, v = (torch.randn(2, T, h, D, generator=g, device=cuda).to(dt)
               for h in (32, 8, 8))
    atol, rtol = TOL[dt]
    outs = []
    for c0 in range(0, T, C):
        c1 = min(c0 + C, T)
        ks, vs = torch.zeros_like(k), torch.zeros_like(v)
        ks[:, :c1], vs[:, :c1] = k[:, :c1], v[:, :c1]
        out = fp_ops.flash_prefill_chunk_cuda(q[:, c0:c1], ks, vs,
                                              q_offset=c0, window=window)
        ref = flash_prefill_chunk_ref(q[:, c0:c1], ks, vs, q_offset=c0,
                                      window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        outs.append(out)
    whole = fp_ops.flash_prefill_cuda(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 1), whole)


def _verify_inputs(dev, dt, Tk, W, L, Hq=32, Hkv=8, D=128, paged=False):
    """A verify segment over a materialized view of Tk rows: main rows at
    positions 0.. (W = 0) or streaming positions with the last W rows a
    ring labelled `pos - rlen + arange`; ragged valid lengths (5, 4, 3, 2,
    1, 0, 5, 1: rows past them still run), one empty main store; with
    `paged`, K/V gathered from a shuffled 16-row-block pool."""
    g = torch.Generator(device=dev).manual_seed(Tk + W + L)
    B, S = 8, Tk - W

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    valid = torch.tensor([5, 4, 3, 2, 1, 0, 5, 1], device=dev).clamp(max=L)
    before = torch.tensor([S - 64, S // 2, 17, 0, S - 5, 100, 7, 3],
                          device=dev)
    idx = torch.arange(S, device=dev)[None]
    if W:
        rlen = torch.maximum(torch.tensor([W, 5, W - 1, 4, 64, 1, 5, 9],
                                          device=dev), valid)
        n_main = before.clamp(max=S)
        n_main[3] = 0
        pos = before + W + valid
        main = torch.where(idx < n_main[:, None],
                           (pos - rlen)[:, None] - (n_main[:, None] - idx), -1)
        ring = (pos - rlen)[:, None] + torch.arange(W, device=dev)[None]
        kv_pos = torch.cat([main, ring], 1)
        bias = torch.cat([torch.where(idx < n_main[:, None], 0.0, -1e30),
                          torch.where(torch.arange(W, device=dev)[None]
                                      < rlen[:, None], 0.0, -1e30)], 1)
        q_pos = (pos - valid)[:, None] + torch.arange(L, device=dev)[None]
    else:
        length = before + valid
        kv_pos = torch.where(idx < length[:, None], idx, -1)
        bias = torch.where(idx < length[:, None], 0.0, -1e30)
        q_pos = before[:, None] + torch.arange(L, device=dev)[None]
    k, v = rnd(B, Tk, Hkv, D), rnd(B, Tk, Hkv, D)
    if paged:
        nb = B * (Tk // 16) + 3
        ids = torch.randperm(nb, generator=g, device=dev)[:B * (Tk // 16)]
        tbl = ids.view(B, Tk // 16).to(torch.int32)
        k = gather_pool(rnd(nb, 16, Hkv, D), tbl).contiguous()
        v = gather_pool(rnd(nb, 16, Hkv, D), tbl).contiguous()
    return (rnd(B, L, Hq, D), k, v, kv_pos.to(torch.int32).contiguous(),
            bias.float().contiguous(), q_pos.to(torch.int32).contiguous())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Tk,W,window,L,D,paged", [
    (2112, 0, 0, 5, 128, False),      # `full` at the serve shape
    (640, 128, 0, 5, 128, False),     # kivi2 512 + ring 128
    (640, 128, 64, 5, 128, False),    # ... under a sliding window
    (2112, 0, 0, 5, 128, True),       # a paged view, gathered
    (200, 40, 0, 16, 64, False),      # the longest segment, D 64
    (77, 0, 0, 1, 128, False)])       # a ragged key tile, one row
def test_flash_verify_kernel_matches_plain(cuda, dt, Tk, W, window, L, D,
                                           paged):
    args = _verify_inputs(cuda, dt, Tk, W, L, D=D, paged=paged)
    out = fp_ops.flash_verify_cuda(*args, window=window)
    ref = flash_verify_ref(*args, window=window)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _verify_edge_inputs(dev, dt, B, Tk, L, Hq, Hkv, D, split_len,
                        n_split):
    """Keys at positions 0.. with the segment after them, one row per
    pattern of the split design: 0 sees every key; 1 sees none (q_pos
    below every key: uniform over exactly Tk keys); 2 only the keys of
    the last split; 3 only those of the first (the other splits masked
    for every row); 4 every key invalid by the bias (uniform); 5.. as 0."""
    g = torch.Generator(device=dev).manual_seed(Tk + L + Hkv)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    idx = torch.arange(Tk, device=dev)
    far = 2 ** 30
    last = (n_split - 1) * split_len
    pats = [idx, idx, torch.where(idx >= last, idx, far),
            torch.where(idx < split_len, idx, far), idx]
    kv_pos = torch.stack([pats[min(b, 4)] if b < 5 else idx
                          for b in range(B)]).to(torch.int32)
    bias = torch.zeros(B, Tk, device=dev)
    bias[4] = -1e30
    q_pos = (Tk + torch.arange(L, device=dev))[None].repeat(B, 1)
    q_pos[1] = -1 - torch.arange(L, device=dev)
    return (rnd(B, L, Hq, D), rnd(B, Tk, Hkv, D), rnd(B, Tk, Hkv, D),
            kv_pos.contiguous(), bias, q_pos.to(torch.int32).contiguous())


# (B, Tk, L, Hq, Hkv, D): edges of the verify kernel's key split
VERIFY_EDGES = {
    "one-tile": (6, 32, 5, 32, 8, 128),
    "below-one-tile": (6, 20, 5, 32, 8, 128),
    "one-past-a-split": (6, None, 5, 32, 8, 128),   # Tk found below
    "most-splits": (6, 2048, 5, 4, 1, 128),          # 64 splits at 132 SMs
    "two-row-tiles": (6, 700, 16, 32, 8, 128),       # L 16 x Gq 4 = 64 rows
    "d64": (6, 300, 7, 16, 2, 64),
    "gq5": (6, 700, 5, 40, 8, 128),                  # L 5: 25 rows, one tile
    "gq12": (6, 700, 5, 96, 8, 128),                 # L 5: 60 rows, two
}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(VERIFY_EDGES))
def test_flash_verify_kernel_at_split_edges(cuda, dt, case):
    """B5 at the edges of the split-KV design against its plain version:
    a row that sees no key and a row of invalid keys average uniformly
    over exactly Tk keys; a split masked for every row adds nothing where
    another split is visible; the tail of the last split takes no part."""
    from repro_torch.kernels.build import SPLIT_MAX, sm_count
    B, Tk, L, Hq, Hkv, D = VERIFY_EDGES[case]
    n_sm = sm_count(cuda)
    if Tk is None:   # the smallest Tk >= 200 whose last split holds 1 key
        Tk = 200
        while True:
            _, n, sl = fp_ops.verify_splits(B, Hkv, Hq // Hkv * L, Tk, n_sm)
            if Tk - (n - 1) * sl == 1:
                break
            Tk += 1
    n_rt, n_split, split_len = fp_ops.verify_splits(B, Hkv, Hq // Hkv * L,
                                                    Tk, n_sm)
    if case == "most-splits" and n_sm == 132:
        assert n_split == SPLIT_MAX
    if case in ("two-row-tiles", "gq12"):
        assert n_rt == 2
    if case == "gq5":
        assert n_rt == 1
    args = _verify_edge_inputs(cuda, dt, B, Tk, L, Hq, Hkv, D, split_len,
                               n_split)
    out = fp_ops.flash_verify_cuda(*args)
    ref = flash_verify_ref(*args)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    v = args[2].float()
    uniform = v.mean(1).repeat_interleave(Hq // Hkv, 1)[:, None]
    for b in (1, 4):
        torch.testing.assert_close(out[b].float(),
                                   uniform[b].expand(L, -1, -1),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_verify_kernel_windowed_at_gq6(cuda, dt):
    """B5 at mixtral's head group (48 / 8: 30 packed rows, one row tile)
    with its 4096-token window over a 6208-row view whose segments sit at
    positions past 6000, so the window masks a slot's first ~2000 keys:
    within TOL of its plain version, which the window moves."""
    g = torch.Generator(device=cuda).manual_seed(6208)
    B, Tk, L, Hq, Hkv, D, win = 4, 6208, 5, 48, 8, 128, 4096

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    before = torch.tensor([6200, 5000, 100, 6203], device=cuda)
    valid = torch.tensor([5, 4, 3, 1], device=cuda)
    idx = torch.arange(Tk, device=cuda)[None]
    length = before + valid
    kv_pos = torch.where(idx < length[:, None], idx, -1).to(torch.int32)
    bias = torch.where(idx < length[:, None], 0.0, -1e30).float()
    q_pos = (before[:, None] + torch.arange(L, device=cuda)[None]) \
        .to(torch.int32)
    args = (rnd(B, L, Hq, D), rnd(B, Tk, Hkv, D), rnd(B, Tk, Hkv, D),
            kv_pos.contiguous(), bias.contiguous(), q_pos.contiguous())
    n_rt, _, _ = fp_ops.verify_splits(B, Hkv, Hq // Hkv * L, Tk,
                                      torch.cuda.get_device_properties(
                                          cuda).multi_processor_count)
    assert n_rt == 1
    out = fp_ops.flash_verify_cuda(*args, window=win)
    ref = flash_verify_ref(*args, window=win)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    assert not torch.equal(ref, flash_verify_ref(*args, window=0))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_verify_kernel_is_deterministic(cuda, dt):
    """Two launches on the same inputs (the `full` serve shape: 8 splits
    merged by whichever CTA arrives last) are bit-equal, one launch
    counted each."""
    args = _verify_inputs(cuda, dt, 2112, 0, 5)
    n0 = fp_ops.flash_verify_kernel.launches
    a = fp_ops.flash_verify_cuda(*args)
    b = fp_ops.flash_verify_cuda(*args)
    torch.cuda.synchronize()
    assert fp_ops.flash_verify_kernel.launches == n0 + 2
    assert torch.equal(a, b)


def test_split_kernels_interleaved_keep_their_tickets(cuda):
    """B1, B3 and B5 launched in turn on one stream at shapes with
    different ticket counts (B1 / B3 share one per-device buffer, 64 and
    32 counters here; B5 keeps its own, 64 and 128): a counter left
    nonzero would make a later launch merge early or never. Every launch
    matches its plain version and the first launch of its case bit for
    bit."""
    bf = torch.bfloat16
    dense = _decode_inputs(cuda, bf, 16, True)
    edge = _edge_inputs(cuda, bf, *DECODE_EDGES["ragged-split"])
    paged, _ = _paged_inputs(cuda, bf, 2, True)
    ver = _verify_inputs(cuda, bf, 2112, 0, 5)
    ver16 = _verify_inputs(cuda, bf, 200, 40, 16, D=64)
    kw16 = dict(bits=16, group=1, compute_dtype=bf)
    cases = {
        "b1": (lambda: dq_ops.decode_attn_cuda(*dense, **kw16)[0],
               lambda: decode_attn_ref(*dense, **kw16)[0]),
        "b1-edge": (lambda: dq_ops.decode_attn_cuda(*edge, **kw16)[0],
                    lambda: decode_attn_ref(*edge, **kw16)[0]),
        "b3": (lambda: dq_ops.decode_attn_paged_cuda(
                   *paged, bits=2, group=128, compute_dtype=bf)[0],
               lambda: decode_attn_paged_ref(
                   *paged, bits=2, group=128, compute_dtype=bf)[0]),
        "b5": (lambda: fp_ops.flash_verify_cuda(*ver),
               lambda: flash_verify_ref(*ver)),
        "b5-l16": (lambda: fp_ops.flash_verify_cuda(*ver16),
                   lambda: flash_verify_ref(*ver16)),
    }
    first = {}
    atol, rtol = TOL[bf]
    for name in ["b1", "b5", "b3", "b1-edge", "b5-l16", "b1", "b3", "b5",
                 "b1-edge", "b5-l16", "b3", "b5"]:
        kern, plain = cases[name]
        out = kern()
        torch.cuda.synchronize()
        if name not in first:
            first[name] = out
            torch.testing.assert_close(out.float(), plain().float(),
                                       atol=atol, rtol=rtol)
        assert torch.equal(out, first[name]), name


def test_tier_side_stream_copy_beside_split_kernels(cuda):
    """Two streams: host-tier spills (device-to-host copies of 0.15 GB
    each on the tier's side stream) in flight while B1 and B3
    launch on the main stream at shapes with different ticket counts.
    Every launch equals its plain version and its first launch (taken
    with no copy in flight) bit for bit, so the side stream never touches
    the kernels' ticket buffers or partials scratch. The pool is
    overwritten right after each spill, as a re-granted block would be:
    the fetched bytes still equal the spilled ones, bit for bit."""
    bf = torch.bfloat16
    dense = _decode_inputs(cuda, bf, 16, True)
    edge = _edge_inputs(cuda, bf, *DECODE_EDGES["ragged-split"])
    paged, _ = _paged_inputs(cuda, bf, 2, True)
    kw16 = dict(bits=16, group=1, compute_dtype=bf)
    cases = {
        "b1": (lambda: dq_ops.decode_attn_cuda(*dense, **kw16)[0],
               lambda: decode_attn_ref(*dense, **kw16)[0]),
        "b1-edge": (lambda: dq_ops.decode_attn_cuda(*edge, **kw16)[0],
                    lambda: decode_attn_ref(*edge, **kw16)[0]),
        "b3": (lambda: dq_ops.decode_attn_paged_cuda(
                   *paged, bits=2, group=128, compute_dtype=bf)[0],
               lambda: decode_attn_paged_ref(
                   *paged, bits=2, group=128, compute_dtype=bf)[0]),
    }
    atol, rtol = TOL[bf]
    first = {}
    for name, (kern, plain) in cases.items():
        first[name] = kern()
        torch.cuda.synchronize()
        torch.testing.assert_close(first[name].float(), plain().float(),
                                   atol=atol, rtol=rtol)
    # a granite-8b-wide pool: [layers, blocks, 16 rows, 8 heads, 128] bf16
    g = torch.Generator(device=cuda).manual_seed(3)
    pool = torch.randn(36, 160, 16, 8, 128, generator=g, device=cuda).to(bf)
    tier = TP.HostTier(1024)
    order = ["b3", "b1", "b1-edge", "b3", "b3", "b1-edge", "b1"] * 3
    spills = []
    for k in range(3):
        ids = torch.arange(k * 40, k * 40 + 128, device=cuda) % 160
        payload = dict(blocks=dict(pk=pool.index_select(1, ids)),
                       meta=dict(length=ids.to(torch.int32)[None]))
        want = {f: v.clone() for f, v in payload["blocks"].items()}
        h = tier.begin_spill(payload, 128)
        pool.index_fill_(1, ids, float(k + 1))        # re-granted, rewritten
        outs = [(name, cases[name][0]()) for name in order]
        spills.append((h, want, ids))
        torch.cuda.synchronize()
        for name, out in outs:
            assert torch.equal(out, first[name]), (k, name)
    assert tier.drain() == 3 and tier.d2h_seconds > 0
    for h, want, ids in spills:
        host, nbytes, stall = tier.fetch(h)
        assert host["blocks"]["pk"].is_pinned() and stall == 0.0
        dev = tier.upload(host, cuda)
        assert torch.equal(dev["blocks"]["pk"], want["pk"])
        assert torch.equal(dev["meta"]["length"][0], ids.to(torch.int32))
        assert nbytes == want["pk"].numel() * 2 + ids.numel() * 4
    torch.cuda.synchronize()
    assert tier.stats["fetches"] == 3 and tier.used_blocks == 0
    # the arena reuses its pinned buffers: three spills, at most three
    # buffers' worth pinned, and a fourth spill pins nothing new
    pinned = tier.pinned_bytes
    tier.begin_spill(dict(pk=pool.index_select(1, ids)), 128)
    tier.drain()
    assert tier.pinned_bytes == pinned


def test_quantized_wrapper_matches_plain(cuda):
    """B1w: the fused kernel on a quantized store, no ring, no mass, f32
    compute."""
    args = _decode_inputs(cuda, torch.bfloat16, 4, False)[:8]
    n0 = dq_ops.decode_qattn_count.launches
    b0 = dq_ops.decode_attn_kernel.launches
    out = dq_ops.decode_attention_quantized(*args, bits=4, group=128)
    assert dq_ops.decode_qattn_count.launches == n0 + 1
    assert dq_ops.decode_attn_kernel.launches == b0 + 1
    ref, _ = decode_attn_ref(*args, None, None, None, bits=4, group=128,
                             compute_dtype=torch.float32)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 96, device=cuda)          # head_dim 96
    with pytest.raises(ValueError):
        fp_ops.flash_prefill_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError):                     # bias not f32
        dq_ops.decode_attn_cuda(
            torch.zeros(1, 4, 64, device=cuda),
            torch.zeros(1, 8, 2, 64, device=cuda), None, None,
            torch.zeros(1, 8, 2, 64, device=cuda), None, None,
            torch.zeros(1, 8, device=cuda, dtype=torch.float16), None, None,
            None, bits=16, group=1)
    q = torch.zeros(1, 64, 4, 64, device=cuda)
    with pytest.raises(ValueError):                     # segment past Tk
        fp_ops.flash_prefill_chunk_cuda(q, q[:, :, :2], q[:, :, :2],
                                        q_offset=1)
    with pytest.raises(ValueError):                     # table not int32
        dq_ops.decode_attn_paged_cuda(
            torch.zeros(1, 4, 64, device=cuda),
            torch.zeros(1, 2, device=cuda, dtype=torch.int64),
            torch.zeros(3, 8, 2, 64, device=cuda), None, None,
            torch.zeros(3, 8, 2, 64, device=cuda), None, None,
            torch.zeros(1, 16, device=cuda), None, None, None, bits=16,
            group=1)
    q = torch.zeros(1, 17, 4, 64, device=cuda)          # segment of 17
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        fp_ops.flash_verify_cuda(
            q, kv, kv, torch.zeros(1, 8, dtype=torch.int32, device=cuda),
            torch.zeros(1, 8, device=cuda),
            torch.zeros(1, 17, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2", "h2o+kivi2"])
def test_reduced_engine_on_card_matches_cpu(cuda, pname):
    """Reduced granite-8b in f32: the engine on the card (kernels) and on
    the CPU (their plain versions) give the same streams, and the card
    run went through both kernels where the policy uses them."""
    cfg = reduced(GRANITE)
    pol = presets(16, 8)[pname]
    reqs = [Request(tokens=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=torch.Generator()
                                         .manual_seed(n)).numpy(),
                    max_new=6) for n in (32, 48, 32)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(cfg, params, pol, prompt_len=48, max_new=6, slots=2,
                     buckets=(32, 48), device=dev)
        dq_ops.decode_attn_kernel.launches = 0
        fp_ops.flash_prefill_kernel.launches = 0
        out[dev] = eng.generate_continuous(
            [Request(tokens=r.tokens, max_new=r.max_new) for r in reqs])
    assert dq_ops.decode_attn_kernel.launches == \
        out["cuda"].decode_steps * cfg.num_layers
    if not pol.spec.track_scores():
        assert fp_ops.flash_prefill_kernel.launches == 3 * cfg.num_layers
    for a, b in zip(out["cpu"].results, out["cuda"].results):
        assert a.tokens.tolist() == b.tokens.tolist()


@pytest.mark.parametrize("cf", [4.0, 1.25], ids=["drop-free", "cf1.25"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_apply_on_card_matches_cpu(cuda, arch, cf):
    """`moe_apply` (and the dense oracle) on the card against the CPU port
    at a small width in f32: drop-free at the reduced 4 experts top 2; at
    capacity 1.25 with each config's real experts and top k (8 / 2, 384 /
    8), where tokens drop. Outputs within 1e-5, the same drop fraction
    (the fixed-order combine has no atomics), two calls bit-equal."""
    cfg = reduced(get_config(arch))
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    if cf == 1.25:
        E, k = (get_config(arch).moe.num_experts,
                get_config(arch).moe.num_experts_per_tok)
    p = M.init_params(cfg.replace(moe=cfg.moe.__class__(
        num_experts=E, num_experts_per_tok=k, d_expert=64)), seed=0,
        device="cpu")["blocks"]["sub0"]["moe"]
    p = {n: v[0] for n, v in p.items()}
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = moe_lib.moe_apply(p, x, top_k=k, capacity_factor=cf)
    yc, auxc = moe_lib.moe_apply(_to(p, "cuda"), x.cuda(), top_k=k,
                                 capacity_factor=cf)
    torch.testing.assert_close(yc.cpu(), y, atol=1e-5, rtol=1e-5)
    assert auxc.drop_fraction.item() == aux.drop_fraction.item()
    assert (aux.drop_fraction.item() > 0) == (cf == 1.25)
    yd, _ = moe_lib.moe_apply_dense(_to(p, "cuda"), x.cuda(), top_k=k)
    if cf == 4.0:
        torch.testing.assert_close(yd.cpu(), y, atol=1e-4, rtol=1e-4)
    again, _ = moe_lib.moe_apply(_to(p, "cuda"), x.cuda(), top_k=k,
                                 capacity_factor=cf)
    assert torch.equal(again, yc)


@pytest.mark.parametrize("arch,pname,paged", [
    ("mixtral-8x22b", "full", False), ("mixtral-8x22b", "kivi2", True),
    ("kimi-k2-1t-a32b", "h2o", False)])
def test_reduced_moe_engine_on_card_matches_cpu(cuda, arch, pname, paged):
    """Reduced mixtral (window 64, prompts past it) and kimi in f32 at
    capacity 1.25 over 8 experts (drops couple the slots): the engine on
    the card (kernels; paged with monolithic admission) gives the CPU's
    streams."""
    cfg = reduced(get_config(arch))
    cfg = cfg.replace(moe=cfg.moe.__class__(
        num_experts=8, num_experts_per_tok=2, d_expert=256,
        capacity_factor=1.25))
    pol = presets(32, 8)[pname]
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=torch
                          .Generator().manual_seed(n)).numpy()
            for n in (96, 80, 96)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(M.init_params(cfg, seed=0, device="cpu"), dev)
        eng = Engine(cfg, params, pol, prompt_len=96, max_new=6, slots=2,
                     buckets=(80, 96), device=dev, paged=paged)
        out[dev] = eng.generate_continuous(
            [Request(tokens=t, max_new=6) for t in reqs])
    for a, b in zip(out["cpu"].results, out["cuda"].results):
        assert a.tokens.tolist() == b.tokens.tolist()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2", "h2o+kivi2"])
def test_reduced_paged_chunked_engine_on_card_matches_cpu(cuda, pname):
    """`Engine(paged=True, chunked_prefill=True)`, reduced granite-8b in
    f32: the card's streams equal the CPU's, the decode went through the
    paged kernel only, and the admissions through the chunked flash
    kernel for the policies that read no mass."""
    cfg = reduced(GRANITE)
    pol = presets(16, 8)[pname]
    reqs = [Request(tokens=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=torch.Generator()
                                         .manual_seed(n)).numpy(),
                    max_new=6) for n in (32, 48, 32)]
    kernels = (dq_ops.decode_attn_kernel, dq_ops.decode_attn_paged_kernel,
               fp_ops.flash_prefill_kernel, fp_ops.flash_prefill_chunk_kernel)
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(cfg, params, pol, prompt_len=48, max_new=6, slots=2,
                     buckets=(32, 48), device=dev, paged=True,
                     chunked_prefill=True, chunk_len=16)
        for k in kernels:
            k.launches = 0
        out[dev] = eng.generate_continuous(
            [Request(tokens=r.tokens, max_new=r.max_new) for r in reqs])
        assert eng.last_audit["clean"]
    dense_dec, paged_dec, mono, chunk = (k.launches for k in kernels)
    assert (dense_dec, mono) == (0, 0)
    assert paged_dec == out["cuda"].decode_steps * cfg.num_layers
    if not pol.spec.track_scores():
        assert chunk == (2 + 3 + 2) * cfg.num_layers     # 16-row segments
    for a, b in zip(out["cpu"].results, out["cuda"].results):
        assert a.tokens.tolist() == b.tokens.tolist()


@pytest.mark.parametrize("pname,draft,paged", [("full", "same", False),
                                               ("kivi2", "window:16", False),
                                               ("full", "same", True)])
def test_reduced_spec_engine_on_card_matches_cpu(cuda, pname, draft, paged):
    """`Engine(speculative=True)`, reduced granite-8b in f32: the card's
    streams equal the CPU's and the plain engine's, and every verify
    round went through the verify kernel, once per layer."""
    cfg = reduced(GRANITE)
    pol = presets(16, 8)[pname]
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=torch.Generator()
                          .manual_seed(n)).numpy() for n in (32, 48, 32)]
    kw = dict(paged=True, chunked_prefill=True, chunk_len=16) if paged else {}
    out = {}
    for dev, spec_on in (("cpu", True), ("cuda", True), ("cuda", False)):
        params = M.init_params(cfg, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(cfg, params, pol, prompt_len=48, max_new=8, slots=2,
                     buckets=(32, 48), device=dev, speculative=spec_on,
                     gamma=3, draft_policy=draft, **kw)
        fp_ops.flash_verify_kernel.launches = 0
        out[dev, spec_on] = eng.generate_continuous(
            [Request(tokens=r, max_new=8) for r in reqs])
        if spec_on and dev == "cuda":
            assert fp_ops.flash_verify_kernel.launches == \
                out[dev, spec_on].spec.verify_rounds * cfg.num_layers > 0
    for key in (("cuda", True), ("cuda", False)):
        for a, b in zip(out["cpu", True].results, out[key].results):
            assert a.tokens.tolist() == b.tokens.tolist(), key


# B6: codes may differ from the plain version by one level only where the
# plain version's own quotient (x - lo) / scale lies within KV_TIE of a
# .5 tie; zeros bit-equal; scales within one f32 ulp (both divide exactly)
KV_TIE = 1e-5


def _b6_matches_plain(x, got, want, bits, group):
    """B6's (packed, scale, zero) against the plain version's on the same
    `x`: per channel over `group` rows (K) when `group`, else per row
    (V)."""
    (pk, sk, zk), (pr, sr, zr) = got, want
    torch.cuda.synchronize()
    assert pk.shape == pr.shape and sk.shape == sr.shape
    assert torch.equal(zk, zr)
    assert (sk.view(torch.int32) - sr.view(torch.int32)).abs().max() <= 1
    D = x.shape[-1]
    a, b = unpack_ref(pk, bits, D), unpack_ref(pr, bits, D)
    if group:
        lo = zr.repeat_interleave(group, 1)
        sc = sr.repeat_interleave(group, 1)
    else:
        lo, sc = zr[..., None], sr[..., None]
    q = (x.float() - lo) / sc
    tie = (q - q.floor() - 0.5).abs() <= KV_TIE
    diff = (a - b).abs()
    assert not ((diff > 1) | ((diff == 1) & ~tie)).any()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("B,S,H,D,G", [(8, 128, 8, 128, 128),
                                       (1, 512, 8, 128, 128),
                                       (1, 1920, 8, 128, 128),
                                       (2, 64, 2, 32, 16),
                                       (1, 64, 3, 40, 16),
                                       (2, 32, 1, 20, 16),
                                       (1, 1024, 2, 16, 512)])
def test_kvquant_kernels_match_plain(cuda, dt, bits, B, S, H, D, G):
    """kquant / vquant at the serve path's shapes (the ring flush of 8
    slots, kivi2's prompt compressions) and small odd ones: H*D 120 and
    20 end in part of kquant's 16-channel slice (20 bf16 channels: no
    whole 16-byte chunks, element loads), G 512 holds more rows than a
    thread keeps in registers; each call adds one to its own launch
    count."""
    g = torch.Generator(device=cuda).manual_seed(S + bits)
    x = (torch.randn(B, S, H, D, generator=g, device=cuda) * 2).to(dt)
    for fn, kern, plain, group in (
            (kvq_ops.kquant_cuda, kvq_ops.kquant_kernel,
             lambda: kquant_ref(x, bits, G), G),
            (kvq_ops.vquant_cuda, kvq_ops.vquant_kernel,
             lambda: vquant_ref(x, bits), 0)):
        n0 = kern.launches
        got = fn(x, bits=bits, group=G)
        assert kern.launches == n0 + 1
        _b6_matches_plain(x, got, plain(), bits, group)


# vquant's edges, (B, S, H, D): D 64 / 128 (16 and 8 bf16 lanes a row,
# 16 / 32 f32), D 20 (3 bf16 chunks, the last part-filled: element loads
# and byte stores), 21 rows (not whole CTAs: 8 rows a CTA in bf16 at D
# 128, 4 in f32), D 512 (f32: 4 chunks a lane, 2 held in registers and 2
# read again)
VQ_EDGES = {"D64": (2, 16, 4, 64), "D128": (8, 16, 8, 128),
            "D20": (2, 16, 3, 20), "rows21": (1, 7, 3, 128),
            "D512": (1, 4, 2, 512)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("case", list(VQ_EDGES))
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_vquant_kernel_at_edges(cuda, dt, bits, case, offset):
    """vquant against `vquant_ref` at VQ_EDGES, on an aligned tensor and
    on a view one element into its storage (no 16-byte loads), with one
    constant row (the 1e-8 scale floor)."""
    B, S, H, D = VQ_EDGES[case]
    n = B * S * H * D
    g = torch.Generator(device=cuda).manual_seed(n + bits)
    flat = (torch.randn(n + 1, generator=g, device=cuda) * 3).to(dt)
    x = (flat[1:] if offset else flat[:n]).view(B, S, H, D)
    x[0, 0, 0] = 0.25
    assert (x.data_ptr() % 16 != 0) == offset
    n0 = kvq_ops.vquant_kernel.launches
    got = kvq_ops.vquant_cuda(x, bits=bits, group=S)
    assert kvq_ops.vquant_kernel.launches == n0 + 1
    _b6_matches_plain(x, got, vquant_ref(x, bits), bits, 0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("B,S,H,D,G,offset", [
    (8, 128, 8, 128, 128, False), (1, 512, 8, 128, 128, False),
    (2, 32, 1, 20, 16, False), (1, 64, 3, 40, 16, False),
    (1, 1024, 2, 16, 512, False), (1, 21, 3, 64, 7, True)])
def test_kvquant_fused_equals_separate(cuda, dt, bits, B, S, H, D, G,
                                       offset):
    """`kvquant_cuda` (one launch) bit-equal to `kquant_cuda` +
    `vquant_cuda` on the same k and v, and within B6's bounds of the plain
    versions; the last case reads both through views one element into
    their storage. Only the fused counter moves."""
    n = B * S * H * D
    g = torch.Generator(device=cuda).manual_seed(n + bits)
    flat = [(torch.randn(n + 1, generator=g, device=cuda) * 2).to(dt)
            for _ in range(2)]
    k, v = ((f[1:] if offset else f[:n]).view(B, S, H, D) for f in flat)
    counts = [c.launches for c in (kvq_ops.kvquant_kernel,
                                   kvq_ops.kquant_kernel,
                                   kvq_ops.vquant_kernel)]
    kf, vf = kvq_ops.kvquant_cuda(k, v, bits=bits, group=G)
    assert [c.launches for c in (kvq_ops.kvquant_kernel,
                                 kvq_ops.kquant_kernel,
                                 kvq_ops.vquant_kernel)] == \
        [counts[0] + 1, counts[1], counts[2]]
    apart = (kvq_ops.kquant_cuda(k, bits=bits, group=G)
             + kvq_ops.vquant_cuda(v, bits=bits, group=G))
    for a, b in zip(kf + vf, apart):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    _b6_matches_plain(k, kf, kquant_ref(k, bits, G), bits, G)
    _b6_matches_plain(v, vf, vquant_ref(v, bits), bits, 0)


def test_kvquant_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 64, 2, 32, device=cuda)
    for fn in (kvq_ops.kquant_cuda, kvq_ops.vquant_cuda,
               lambda x, **kw: kvq_ops.kvquant_cuda(x, x, **kw)):
        with pytest.raises(ValueError):
            fn(x, bits=3, group=16)                 # bits
        with pytest.raises(ValueError):
            fn(x, bits=2, group=48)                 # S % group
        with pytest.raises(ValueError):
            fn(x.half(), bits=2, group=16)          # dtype
    for v in (x[:, :32], x.bfloat16(), x.cpu()):    # k and v differ
        with pytest.raises(ValueError):
            kvq_ops.kvquant_cuda(x, v, bits=2, group=16)


@pytest.mark.parametrize("pname", ["full", "kivi2"])
def test_reduced_prefix_engine_on_card_matches_cpu(cuda, pname):
    """`Engine(prefix_sharing=True)` on templated prompts, reduced
    granite-8b in f32: the card's streams and prefix counters equal the
    CPU's, warm hits happen, and under kivi2 every flush and quantized
    admission went through B6 in one launch a layer (the fused kvquant;
    no standalone kquant / vquant launch)."""
    cfg = reduced(GRANITE)
    pol = presets(24, 8)[pname]
    gen = torch.Generator().manual_seed(3)
    shared = torch.randint(0, cfg.vocab_size, (24,), generator=gen)
    reqs = [torch.cat([shared, torch.randint(0, cfg.vocab_size, (8,),
                                             generator=gen)]).numpy()
            for _ in range(4)]
    b6 = (kvq_ops.kvquant_kernel, kvq_ops.kquant_kernel,
          kvq_ops.vquant_kernel)
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(cfg, params, pol, prompt_len=32, max_new=12, slots=2,
                     device=dev, paged=True, block_len=8,
                     prefix_sharing=True)
        for k in b6:
            k.launches = 0
        out[dev] = eng.generate_continuous(
            [Request(tokens=r, max_new=12) for r in reqs])
        assert eng.last_audit["clean"]
    res = out["cuda"]
    assert res.prefix["warm_hits"] >= 1
    assert res.prefix == out["cpu"].prefix | {
        k: res.prefix[k] for k in ("warm_prefill_s", "cold_prefill_s")}
    want = ((res.kv_flush_steps + len(reqs)) * cfg.num_layers
            if pol.spec.quantized else 0)
    assert [k.launches for k in b6] == [want, 0, 0]
    for a, b in zip(out["cpu"].results, res.results):
        assert a.tokens.tolist() == b.tokens.tolist()


@pytest.mark.parametrize("pname", ["kivi4", "int8"])
def test_reduced_quantized_presets_on_card_match_cpu(cuda, pname):
    """The 4- and 8-bit KIVI presets, reduced granite-8b in f32: the
    card's streams equal the CPU's, and every flush and quantized
    admission went through the fused B6, once a layer."""
    cfg = reduced(GRANITE)
    pol = presets(16, 8)[pname]
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=torch.Generator()
                          .manual_seed(n)).numpy() for n in (32, 48, 32)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(cfg, params, pol, prompt_len=48, max_new=12, slots=2,
                     buckets=(32, 48), device=dev)
        kvq_ops.kvquant_kernel.launches = 0
        out[dev] = eng.generate_continuous(
            [Request(tokens=r, max_new=12) for r in reqs])
    res = out["cuda"]
    assert res.kv_flush_steps > 0
    assert kvq_ops.kvquant_kernel.launches == \
        (res.kv_flush_steps + len(reqs)) * cfg.num_layers
    for a, b in zip(out["cpu"].results, res.results):
        assert a.tokens.tolist() == b.tokens.tolist()


# (policy, engine options, ladder options): forced preemptions on the
# dense and the paged + chunked paths, lazy growth starving the pool
# (the CPU tests' cases, tests/test_torch_preempt.py)
OVERLOAD_CASES = {
    "full-dense-preempt_at": ("full", {}, dict(preempt_at=((3, 0), (5, 1)))),
    "kivi2-paged-chunked-preempt_at": (
        "kivi2", dict(paged=True, block_len=8, chunked_prefill=True,
                      chunk_len=16),
        dict(preempt_at=((3, 0), (5, 1)), audit_every=2)),
    "full-lazy-starved": (
        "full", dict(paged=True, block_len=8),
        dict(block_growth="lazy", preemption=True, pool_blocks=10,
             audit_every=2)),
}


@pytest.mark.parametrize("case", list(OVERLOAD_CASES))
def test_reduced_overload_engine_on_card_matches_cpu(cuda, case):
    """The overload ladder, reduced granite-8b: in f32 the card's streams,
    finish reasons and preemptions equal the CPU's; in bf16 the card's
    ladder run equals its unpreempted run token for token (replay repeats
    the same row operations at the same shapes). Paged, the periodic
    audits (device block table included, after lazy grants) are clean."""
    pname, opts, ladder = OVERLOAD_CASES[case]
    cfg = reduced(GRANITE)
    prompts = [torch.randint(0, cfg.vocab_size, (32,), generator=torch
                             .Generator().manual_seed(s)).numpy()
               for s in range(4)]

    def serve(c, dev, kw):
        params = M.init_params(c, seed=0, device="cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        eng = Engine(c, params, presets(32, 8)[pname], prompt_len=32,
                     max_new=10, slots=3 if "lazy" in case else 2,
                     device=dev, **opts, **kw)
        n_tbl = [0]
        audit = eng._run_audit

        def counted(sched, cache=None):
            n_tbl[0] += cache is not None
            return audit(sched, cache)

        eng._run_audit = counted
        res = eng.generate_continuous([Request(tokens=p, max_new=10)
                                       for p in prompts])
        if eng.paged:
            assert eng.last_audit["clean"]
            assert n_tbl[0] >= 1 or not eng.audit_every
        return res

    def streams(res):
        return [(r.tokens.tolist(), r.finish_reason, r.n_preemptions)
                for r in res.results]

    cpu, card = (serve(cfg, dev, ladder) for dev in ("cpu", "cuda"))
    assert streams(card) == streams(cpu)
    assert sum(r.n_preemptions for r in card.results) >= 1
    assert all(r.finish_reason == "length" for r in card.results)
    bf16 = cfg.replace(dtype=torch.bfloat16)
    twin = serve(bf16, "cuda", {})
    res = serve(bf16, "cuda", ladder)
    assert sum(r.n_preemptions for r in res.results) >= 1
    assert [r.tokens.tolist() for r in res.results] == \
        [r.tokens.tolist() for r in twin.results]


# (policy, top_k of the temperature sampler, or None for greedy)
NOISE_SAMPLER_CASES = {"nacl": ("nacl", None),
                       "keyformer": ("keyformer", None),
                       "temperature": ("full", 50)}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("case", list(NOISE_SAMPLER_CASES))
def test_noise_and_sampler_kernels_equal_plain_on_card(cuda, case, paged):
    """Reduced granite-8b in f32 on the card, one seed: the kernel path and
    use_kernels=False draw the same Gumbel noise (NACL's eviction,
    Keyformer's accumulation, the sampler's pick) from the engine's
    device generator in the same order, so their streams are equal; the
    kernel path went through B1 / B3 once per layer per decode step."""
    pname, top_k = NOISE_SAMPLER_CASES[case]
    cfg = reduced(GRANITE)
    params = M.init_params(cfg, seed=0, device="cuda")
    smp = (sampler_lib.greedy if top_k is None
           else sampler_lib.temperature(0.8, top_k))
    opts = (dict(paged=True, block_len=8, chunked_prefill=True, chunk_len=16)
            if paged else {})
    dec = dq_ops.decode_attn_paged_kernel if paged else dq_ops.decode_attn_kernel
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=torch
                             .Generator().manual_seed(n)).numpy()
               for n in (32, 48, 32, 48)]
    out = {}
    for uk in (True, False):
        dec.launches = 0
        # max_new 16: the `full` store, 48 + 16 rows, takes 8-row blocks
        eng = Engine(cfg, params, presets(16, 8)[pname], prompt_len=48,
                     max_new=16, slots=2, buckets=(32, 48), device="cuda",
                     use_kernels=uk, seed=3, sampler=smp, **opts)
        res = eng.generate_continuous([Request(tokens=p, max_new=16)
                                       for p in prompts])
        out[uk] = [r.tokens.tolist() for r in res.results]
        assert all(r.finish_reason == "length" for r in res.results)
        if uk:
            assert dec.launches == res.decode_steps * cfg.num_layers
    assert out[True] == out[False]


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def test_tracing_adds_no_sync_on_card(cuda):
    """A run with the Tracer and Metrics on streams what its untraced twin
    streams and synchronizes with the card exactly as often: torch.profiler
    counts the stream, device and event synchronizations of each run
    (kivi2, paged + chunked, forced preemptions spilled to the host tier
    and restored), trace on against trace off."""
    from repro_torch.obs import Metrics, Tracer
    cfg = reduced(GRANITE)
    params = M.init_params(cfg, seed=0, device="cuda")
    prompts = [torch.randint(0, cfg.vocab_size, (32,), generator=torch
                             .Generator().manual_seed(s)).numpy()
               for s in range(3)]
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]

    def run(tracer=None, metrics=None):
        eng = Engine(cfg, params, presets(32, 8)["kivi2"], prompt_len=32,
                     max_new=10, slots=2, buckets=(32,), device="cuda",
                     paged=True, block_len=8, chunked_prefill=True,
                     chunk_len=16, preempt_at=((3, 0), (5, 1)), tiering=True,
                     tracer=tracer, metrics=metrics)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            res = eng.generate_continuous([Request(tokens=p, max_new=10)
                                           for p in prompts])
        n = dict.fromkeys(SYNC_CALLS, 0)
        for e in prof.key_averages():
            if e.key in n:
                n[e.key] += e.count
        return res, n

    run()                                   # builds the kernels
    off, n_off = run()
    tr, mx = Tracer(), Metrics()
    on, n_on = run(tr, mx)
    assert [r.tokens.tolist() for r in on.results] == \
        [r.tokens.tolist() for r in off.results]
    assert on.tier["n_spills"] >= 1 and on.tier["n_fetches"] >= 1
    assert {"step", "restore", "spill", "fetch", "preempt"} <= {
        e[1] for e in tr.events()}
    assert mx.snapshot()["tier.spills"] == on.tier["n_spills"]
    assert sum(n_off.values()) > 0, n_off   # the profiler sees the syncs
    assert n_on == n_off


# ---------------------------------------------------------------------------
# The Mamba-2 mixer and the hybrid
# ---------------------------------------------------------------------------


def _ssd_sequential(x, dt, A, B_, C_):
    """The SSD as its recurrence, one token a step, in f32."""
    Bsz, T, H, P = x.shape
    rep = H // B_.shape[2]
    Bh = torch.repeat_interleave(B_, rep, dim=2)
    Ch = torch.repeat_interleave(C_, rep, dim=2)
    h = torch.zeros(Bsz, H, P, B_.shape[3], device=x.device)
    ys = torch.empty(Bsz, T, H, P, device=x.device)
    for t in range(T):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + (dt[:, t, :, None] * Bh[:, t])[:, :, None, :]
             * x[:, t, :, :, None])
        ys[:, t] = torch.einsum("bhn,bhpn->bhp", Ch[:, t], h)
    return ys, h


@pytest.mark.parametrize("T", [512, 600])
def test_ssd_chunked_on_card_matches_recurrence(cuda, T):
    """`ssd_chunked` at mamba2-130m's head shapes (H 24, P 64, N 128,
    chunk 256), whole and ragged T, against the sequential f32
    recurrence within tests/test_ssm.py's 2e-4 + 1e-3 |ref|."""
    from repro_torch.nn import ssm as ssm_lib
    g = torch.Generator(device="cuda").manual_seed(T)
    H, P, N = 24, 64, 128
    x = torch.randn(2, T, H, P, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(2, T, H, generator=g, device="cuda") - 1)
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    B_ = torch.randn(2, T, 1, N, generator=g, device="cuda") * 0.3
    C_ = torch.randn(2, T, 1, N, generator=g, device="cuda") * 0.3
    y, fin = ssm_lib.ssd_chunked(x, dt, A, B_, C_, 256)
    ys, hs = _ssd_sequential(x, dt, A, B_, C_)
    torch.testing.assert_close(y, ys, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(fin, hs, atol=2e-4, rtol=1e-3)


def test_mamba2_decode_continues_prefill_on_card(cuda):
    """Reduced mamba2 in f32 on the card: decoding prompt token T after a
    T-1 prefill gives a T prefill's last logits within 2e-3
    (tests/test_system.py's bound), and the card's logits equal the
    CPU's within 1e-4; no kernel launches."""
    from repro_torch.core.cache import CacheSpec
    cfg = reduced(get_config("mamba2-130m"))
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 45),
                         generator=torch.Generator().manual_seed(0))
    spec = CacheSpec(budget=64)
    kernels = (dq_ops.decode_attn_kernel, fp_ops.flash_prefill_kernel)
    for k in kernels:
        k.launches = 0
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        t = toks.to(dev)
        lg, c = M.prefill(p, cfg, {"tokens": t[:, :-1]}, spec)
        lg_dec, _ = M.decode_step(p, cfg, c, t[:, -1:], spec)
        lg_full, _ = M.prefill(p, cfg, {"tokens": t}, spec)
        torch.testing.assert_close(lg_dec, lg_full, atol=2e-3, rtol=0)
        out[dev] = lg_dec.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)
    assert all(k.launches == 0 for k in kernels)


@pytest.mark.parametrize("pname,paged", [("full", False), ("kivi2", True),
                                         ("h2o", False)])
def test_reduced_jamba_engine_kernels_match_reference(cuda, pname, paged):
    """Reduced jamba (f32, a Mamba-2 + dense layer and an attention + MoE
    layer a superblock, two superblocks) through the engine on the card:
    the kernels' streams equal use_kernels=False's and the CPU's, and the
    decode went through B1 / B3 once per attention layer a step."""
    cfg = reduced(get_config("jamba-v0.1-52b"), num_layers=4)
    pol = presets(32, 8)[pname]
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=torch
                          .Generator().manual_seed(n)).numpy()
            for n in (96, 80, 96)]
    params = M.init_params(cfg, seed=0, device="cpu")
    dec = (dq_ops.decode_attn_paged_kernel if paged
           else dq_ops.decode_attn_kernel)
    out = {}
    for dev, uk in (("cpu", False), ("cuda", False), ("cuda", True)):
        eng = Engine(cfg, _to(params, dev), pol, prompt_len=96, max_new=6,
                     slots=2, buckets=(80, 96), device=dev, paged=paged,
                     use_kernels=uk)
        dec.launches = 0
        out[(dev, uk)] = eng.generate_continuous(
            [Request(tokens=t, max_new=6) for t in reqs])
        if uk:
            assert dec.launches == (out[(dev, uk)].decode_steps
                                    * cfg.num_attn_layers())
    for a, b, c in zip(*(out[k].results for k in out)):
        assert a.tokens.tolist() == b.tokens.tolist() == c.tokens.tolist()


@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
def test_reduced_seamless_wave_path_on_card(cuda, pname):
    """Reduced seamless-m4t-large-v2 (f32, 2 encoder + 2 decoder layers)
    through `Engine.generate` on the card: the kernels' streams equal
    use_kernels=False's and the CPU's, with B1 once per decoder layer a
    decode step and B2 once per layer a wave for the policies that read
    no mass."""
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    pol = presets(32, 8)[pname]
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (3, 64), generator=g).numpy()
    src = torch.randn(3, 16, cfg.d_model, generator=g).numpy()
    params = M.init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev, uk in (("cpu", False), ("cuda", False), ("cuda", True)):
        eng = Engine(cfg, _to(params, dev), pol, prompt_len=64, max_new=6,
                     slots=2, device=dev, use_kernels=uk)
        dq_ops.decode_attn_kernel.launches = 0
        fp_ops.flash_prefill_kernel.launches = 0
        out[(dev, uk)] = eng.generate(prompts, src_embeds=src)
        if uk:
            assert dq_ops.decode_attn_kernel.launches == 2 * 5 * 2
            assert fp_ops.flash_prefill_kernel.launches == (
                0 if pol.spec.track_scores() else 2 * 2)
    a, b, c = (out[k] for k in out)
    assert a.tokens.tolist() == b.tokens.tolist() == c.tokens.tolist()
    assert a.cache_physical_bytes == c.cache_physical_bytes


def test_train_step_on_card_matches_cpu(cuda):
    """One `make_train_step` step of reduced seamless (f32) on the card
    against the CPU: loss, grad norm and the new params within 1e-4; no
    kernel launched; reduced seamless's f32 decode continues its
    `train_forward` logits within 2e-3 on the card (the JAX invariant of
    tests/test_system.py)."""
    from repro_torch.core.cache import CacheSpec
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.optim import cosine_schedule
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import loop as TL
    cfg = reduced(get_config("seamless-m4t-large-v2"), remat="block")
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = next(lm_batches(cfg, 2, 48, seed=0))
    kernels = (dq_ops.decode_attn_kernel, fp_ops.flash_prefill_kernel,
               kvq_ops.kvquant_kernel)
    for k in kernels:
        k.launches = 0
    out = {}
    for dev in ("cpu", "cuda"):
        init, step = TL.make_train_step(cfg, cosine_schedule(3e-4, 0, 4))
        # the step donates its state: each device steps its own copy
        st, m = step(init(tree_map(lambda x: x.to(dev, copy=True), params)),
                     {k: torch.as_tensor(v, device=dev)
                      for k, v in batch.items()})
        out[dev] = (m, st)
    assert all(k.launches == 0 for k in kernels)
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for f in ("loss", "ce_loss", "grad_norm", "lr"):
        assert abs(float(getattr(mg, f)) - float(getattr(mc, f))) <= 1e-4 * (
            1 + abs(float(getattr(mc, f)))), f
    for a, b in zip(_leaves_of(sc.params), _leaves_of(sg.params)):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    p = _to(params, "cuda")
    t = torch.as_tensor(batch["tokens"], device="cuda")
    src = torch.as_tensor(batch["src_embeds"], device="cuda")
    with torch.no_grad():
        full, _ = M.train_forward(p, cfg, {"tokens": t, "src_embeds": src})
    spec = CacheSpec(budget=64)
    lg, c = M.prefill(p, cfg, {"tokens": t[:, :40], "src_embeds": src}, spec)
    errs = [(lg - full[:, 39]).abs().max().item()]
    for i in range(40, 48):
        lg, c = M.decode_step(p, cfg, c, t[:, i:i + 1], spec)
        errs.append((lg - full[:, i]).abs().max().item())
    assert max(errs) < 2e-3, errs


def _leaves_of(tree):
    return [x for k in sorted(tree) for x in
            (_leaves_of(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


# ---------------------------------------------------------------------------
# The kernels on a rank's head shard (`nn.sharding.on_shards`, local_map):
# a fake 2-rank world (collectives return without moving data) over a
# (1, 2) mesh on the card, each rank's run against the kernel on every
# head, sliced to that rank's heads; the per-rank masses, partial sums
# over heads, summed against the full-heads mass.
# ---------------------------------------------------------------------------


def _fake_rank(rank):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=2)
    return init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))


def _heads_spec(t):
    return (None, None, "model") if t.dim() >= 3 else ()


@pytest.mark.parametrize("pname", ["full", "h2o+kivi2"])
def test_decode_kernel_on_head_shards_equals_full_heads(cuda, pname):
    import torch.distributed as dist
    from repro_torch.core import cache as kvcache
    from repro_torch.nn import attention as attn
    from repro_torch.nn import sharding as shd
    spec = presets(budget=512, window=128)[pname].spec
    B, T, Hq, Hkv, D = 4, 640, 32, 8, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    mass = torch.rand(B, T, generator=g, device=cuda)
    lc = kvcache.compress_prompt(spec, k, v, mass)
    q = torch.randn(B, 1, Hq, D, generator=g, device=cuda).to(torch.bfloat16)
    out, m = attn.decode_attention(q, lc, spec, q_pos=lc.pos)
    sums = torch.zeros_like(m)
    for r in range(2):
        mesh = _fake_rank(r)
        try:
            lc_d = type(lc)(*(shd.distribute_leaf(t, _heads_spec(t), mesh)
                              for t in lc))
            q_d = shd.distribute_leaf(q, _heads_spec(q), mesh)
            with shd.replicate_plain():
                o_d, m_d = attn.decode_attention(q_d, lc_d, spec,
                                                 q_pos=lc.pos)
            assert o_d.placements[1].is_shard(2)
            assert m_d.placements[1].is_partial()
            h = slice(r * Hq // 2, (r + 1) * Hq // 2)
            # the key split follows the kv heads: another summation order
            atol, rtol = TOL[torch.bfloat16]
            torch.testing.assert_close(o_d.to_local(), out[:, :, h],
                                       rtol=rtol, atol=atol)
            sums += m_d.to_local()
        finally:
            dist.destroy_process_group()
    torch.testing.assert_close(sums, m, atol=MASS_TOL[0], rtol=MASS_TOL[1])


@pytest.mark.parametrize("window", [0, 256])
def test_flash_prefill_on_head_shards_equals_full_heads(cuda, window):
    import torch.distributed as dist
    from repro_torch.nn import sharding as shd
    B, T, Hq, Hkv, D = 2, 1024, 32, 8, 128
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(B, T, Hq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    full = fp_ops.flash_attention(q, k, v, window=window)
    for r in range(2):
        mesh = _fake_rank(r)
        try:
            qd, kd, vd = (shd.distribute_leaf(t, _heads_spec(t), mesh)
                          for t in (q, k, v))
            o = shd.on_shards(
                lambda a, b, c: fp_ops.flash_attention(a, b, c,
                                                       window=window),
                shd.heads_layout(kd, Hkv), qd, kd, vd, out=(4,))
            h = slice(r * Hq // 2, (r + 1) * Hq // 2)
            atol, rtol = TOL[torch.bfloat16]
            torch.testing.assert_close(o.to_local(), full[:, :, h],
                                       rtol=rtol, atol=atol)
        finally:
            dist.destroy_process_group()
