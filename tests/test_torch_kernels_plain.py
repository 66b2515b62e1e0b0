"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode) and reference paths, on the CPU.

B1: `repro_torch.nn.attention.decode_attention(use_kernels=True)` runs
`decode_qattn.ref.decode_attn_ref` for CPU tensors; it is held against
`repro.nn.attention.decode_attention` with the Pallas kernel
(`use_kernels=True, interpret=True`) and with the materialize oracle, over
the lived-in caches of tests/test_decode_kernel_path.py. B2: the plain
flash prefill against `repro.kernels.flash_prefill.ops.flash_attention`.
B1w: the back-compat quantized wrapper against the JAX
`decode_qattn_ref` and the Pallas wrapper (interpret mode).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.cache import CacheSpec as JaxCacheSpec
from repro.kernels.decode_qattn import kernel as jax_dq_kernel
from repro.kernels.decode_qattn import ref as jax_dq_ref
from repro.kernels.flash_prefill import ops as jax_fp
from repro.nn import attention as JA
from repro_torch.bridge import layer_kv_from_numpy
from repro_torch.core.cache import CacheSpec
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.nn import attention as TA
from test_decode_kernel_path import _layer_kv

TOL = 2e-5
# the fast grid of tests/test_decode_kernel_path.py: (bits, ring, gq)
GRID = [(2, True, 1), (2, True, 4), (16, False, 1), (16, True, 4)]


@pytest.fixture(scope="module", params=GRID, ids=lambda c: str(c))
def case(request):
    """A lived-in cache (compressed prompt + decode appends) with ragged
    rows, a query, and the JAX package's outputs for it."""
    bits, ring, gq = request.param
    B, H, D, W = 2, 2, 32, 8
    kw = dict(budget=32, window=W if ring else 0, bits=bits,
              group=W if ring else 1, policy="h2o")
    jspec, spec = JaxCacheSpec(**kw), CacheSpec(**kw)
    lc = _layer_kv(jspec, B, 48, H, D, jnp.float32)
    lc = lc._replace(length=lc.length.at[0].set(jnp.int32(16)))
    if ring:
        lc = lc._replace(rlen=jnp.minimum(lc.rlen,
                                          jnp.asarray([2, W], jnp.int32)))
    q = jax.random.normal(jax.random.key(7), (B, 1, H * gq, D), jnp.float32)
    ref = JA.decode_attention(q, lc, jspec, dtype=jnp.float32,
                              use_kernels=False)
    pallas = JA.decode_attention(q, lc, jspec, dtype=jnp.float32,
                                 use_kernels=True, interpret=True)
    return (spec, layer_kv_from_numpy(jax.tree.map(np.asarray, lc)),
            torch.tensor(np.asarray(q)), ref, pallas, (jspec, lc, q))


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_decode_plain_matches_pallas_interpret(case):
    spec, lc, q, _, pallas, _ = case
    got = TA.decode_attention(q, lc, spec, dtype=torch.float32)
    # the Pallas kernel returns the mass only for mass-reading policies;
    # h2o reads it, so both outputs compare
    _check(got, pallas)


def test_decode_plain_matches_materialize_oracle(case):
    spec, lc, q, ref, _, _ = case
    _check(TA.decode_attention(q, lc, spec, dtype=torch.float32), ref)
    _check(TA.decode_attention(q, lc, spec, dtype=torch.float32,
                               use_kernels=False), ref)


def test_decode_plain_empty_slot_is_uniform(case):
    """An all-empty row (free slot under continuous batching) decodes with
    every key masked by the finite -1e30: a uniform softmax, no NaN."""
    spec, lc, q, _, _, _ = case
    lc = lc._replace(length=torch.zeros_like(lc.length),
                     rlen=torch.zeros_like(lc.rlen))
    out, mass = TA.decode_attention(q, lc, spec, dtype=torch.float32)
    assert torch.isfinite(out).all() and torch.isfinite(mass).all()
    n_keys = lc.scores.shape[1] + lc.rk.shape[1]
    np.testing.assert_allclose(mass.numpy(), q.shape[2] / n_keys, rtol=1e-5)


def test_decode_sliding_window_matches_jax(case):
    """A sliding window masks slots by absolute position on both paths."""
    spec, lc, q, _, _, (jspec, jlc, jq) = case
    want = JA.decode_attention(jq, jlc, jspec, window=24, dtype=jnp.float32,
                               use_kernels=False)
    for uk in (True, False):
        _check(TA.decode_attention(q, lc, spec, window=24,
                                   dtype=torch.float32, use_kernels=uk), want)


def test_decode_fused_skips_mass_when_untracked():
    """Policies that never read the mass get no mass from the wrapper."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((2, 4, 32)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((2, 16, 2, 32)),
                         dtype=torch.float32) for _ in range(2))
    bias = torch.zeros(2, 16)
    out, mass = dq_ops.decode_attention_fused(
        q, k, None, None, v, None, None, bias, None, None, None, bits=16,
        group=1, return_mass=False)
    assert mass is None and out.shape == q.shape


@pytest.mark.parametrize("T,window", [(64, 0), (96, 0), (64, 24)])
def test_flash_prefill_plain_matches_pallas_interpret(T, window):
    rng = np.random.default_rng(T + window)
    q = rng.standard_normal((2, T, 8, 32)).astype(np.float32)     # GQA 4
    k = rng.standard_normal((2, T, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, T, 2, 32)).astype(np.float32)
    want = jax_fp.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window, bq=32, bk=32,
                                  interpret=True)
    got = fp_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        flash_prefill_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          window=window).numpy(),
        got.numpy(), atol=0, rtol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only (no fallback)."""
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError):
        fp_ops.flash_prefill_cuda(x, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError):
        dq_ops.decode_attn_cuda(x[:, 0], x, None, None, x, None, None,
                                torch.zeros(1, 4), None, None, None, bits=16,
                                group=1)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_decode_attention_quantized_wrapper(bits):
    """B1w: quantized store, no ring, no mass, f32 compute; ragged rows
    and one all-empty row (bias -1e30 everywhere)."""
    rng = np.random.default_rng(bits)
    B, S, Hkv, Gq, D, G = 3, 32, 2, 2, 32, 8
    Dp = D * bits // 8
    q = rng.standard_normal((B, Hkv * Gq, D)).astype(np.float32)
    kq, vq = (rng.integers(-128, 128, (B, S, Hkv, Dp)).astype(np.int8)
              for _ in range(2))
    ks = (rng.random((B, S // G, Hkv, D)) * 0.1 + 0.01).astype(np.float32)
    kz = rng.standard_normal((B, S // G, Hkv, D)).astype(np.float32)
    vs = (rng.random((B, S, Hkv)) * 0.1 + 0.01).astype(np.float32)
    vz = rng.standard_normal((B, S, Hkv)).astype(np.float32)
    length = np.asarray([S, 13, 0])
    bias = np.where(np.arange(S)[None] < length[:, None], 0.0,
                    -1e30).astype(np.float32)
    args = (q, kq, ks, kz, vq, vs, vz, bias)
    kw = dict(bits=bits, group=G)
    got = dq_ops.decode_attention_quantized(*map(torch.tensor, args), **kw)
    want = jax_dq_ref.decode_qattn_ref(*map(jnp.asarray, args), **kw)
    pallas = jax_dq_kernel.decode_qattn_pallas(*map(jnp.asarray, args),
                                               block_s=16, interpret=True,
                                               **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="quantized"):
        dq_ops.decode_attention_quantized(*map(torch.tensor, args), bits=16,
                                          group=G)


# ---- the split-KV decode kernel's key split and combine ----


@pytest.mark.parametrize("B,Hkv,n_keys,n_sm", [
    (8, 8, 2112, 132), (8, 8, 640, 132), (8, 8, 33, 132), (1, 8, 16, 132),
    (1, 1, 1, 132), (64, 8, 2112, 132), (2, 2, 4000, 16), (3, 4, 95, 7),
    (1, 1, 32768, 132)])
def test_decode_splits_cover_the_keys(B, Hkv, n_keys, n_sm):
    """The splits cover [0, n_keys) exactly in whole tiles, none empty."""
    n_split, split_len = kbuild.decode_splits(B, Hkv, n_keys, n_sm)
    assert 1 <= n_split <= kbuild.SPLIT_MAX
    assert split_len % kbuild.SPLIT_TILE == 0
    starts = [s * split_len for s in range(n_split)]
    ends = [min(n_keys, s + split_len) for s in starts]
    assert starts[0] == 0 and ends[-1] == n_keys
    assert all(e > s for s, e in zip(starts, ends))          # none empty
    assert all(a == b for a, b in zip(ends, starts[1:]))     # contiguous
    if n_keys <= kbuild.SPLIT_TILE:
        assert n_split == 1
    # within one wave of CTAS_PER_SM a SM, unless one split is all there is
    assert n_split == 1 or B * Hkv * n_split <= kbuild.CTAS_PER_SM * n_sm


def test_decode_splits_fill_the_card_at_the_serve_shape():
    """granite-8b, 8 slots, the `full` cache of 2112 rows on 132 SMs:
    at least two CTAs an SM, where one per (slot, kv head) gave 64."""
    n_split, _ = kbuild.decode_splits(8, 8, 2112, 132)
    assert 8 * 8 * n_split >= 264


def _split_combine(q, kd, vd, bias, n_split, split_len):
    """The kernel's arithmetic in plain f32: per split, (m, l, acc) of the
    split's keys; merged in split order against the global max; the mass
    from the raw scores with the merged M and L. q [B, Hq, D], kd / vd
    [B, S, Hkv, D], bias [B, S] -> (out [B, Hq, D], mass [B, S])."""
    B, Hq, D = q.shape
    Hkv = kd.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, Hq // Hkv, D),
                     kd) / math.sqrt(D) + bias[:, None, None, :]
    parts = []
    for i in range(n_split):
        si = s[..., i * split_len:(i + 1) * split_len]
        m = si.amax(-1, keepdim=True)
        p = torch.exp(si - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum(
            "bhgs,bshd->bhgd", p,
            vd[:, i * split_len:(i + 1) * split_len])))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, lsum, acc in parts:                 # split-index order
        w = torch.exp(m - M)
        L = L + lsum * w
        O = O + acc * w
    out = (O / L).reshape(B, Hq, D)
    mass = (torch.exp(s - M) / L).sum(dim=(1, 2))
    return out, mass


@pytest.mark.parametrize("bits", [16, 2])
def test_split_combine_model_matches_plain(bits):
    """The split-and-combine arithmetic equals `decode_attn_ref` in f32 on
    ragged rows, an all-masked row (uniform softmax) and a row whose only
    valid keys lie in one split (the other splits all masked)."""
    from repro_torch.kernels.decode_qattn.ref import decode_attn_ref
    from repro_torch.kernels.kvquant import ref as qref
    rng = np.random.default_rng(bits)
    B, S, Hkv, Gq, D, G = 4, 256, 2, 4, 32, 32
    q = torch.tensor(rng.standard_normal((B, Hkv * Gq, D)),
                     dtype=torch.float32)
    if bits < 16:
        Dp = D * bits // 8
        k, v = (torch.tensor(rng.integers(-128, 128, (B, S, Hkv, Dp)),
                             dtype=torch.int8) for _ in range(2))
        ks = torch.tensor(rng.random((B, S // G, Hkv, D)) * 0.1 + 0.01,
                          dtype=torch.float32)
        kz = torch.tensor(rng.standard_normal((B, S // G, Hkv, D)),
                          dtype=torch.float32)
        vs = torch.tensor(rng.random((B, S, Hkv)) * 0.1 + 0.01,
                          dtype=torch.float32)
        vz = torch.tensor(rng.standard_normal((B, S, Hkv)),
                          dtype=torch.float32)
        kd = qref.dequant_k_ref(k, ks, kz, bits, G, torch.float32)
        vd = qref.dequant_v_ref(v, vs, vz, bits, torch.float32)
    else:
        k, v = (torch.tensor(rng.standard_normal((B, S, Hkv, D)),
                             dtype=torch.float32) for _ in range(2))
        ks = kz = vs = vz = None
        kd, vd = k, v
    idx = torch.arange(S)[None]
    valid = torch.stack([idx[0] < S, idx[0] < 77,            # ragged
                         idx[0] < 0,                          # all masked
                         (idx[0] >= 150) & (idx[0] < 160)])   # one split
    bias = torch.where(valid, 0.0, -1e30).float()
    want, want_mass = decode_attn_ref(q, k, ks, kz, v, vs, vz, bias, None,
                                      None, None, bits=bits, group=G)
    n_split, split_len = kbuild.decode_splits(B, Hkv, S, 8)
    assert n_split == 4 and split_len == 64
    got, mass = _split_combine(q, kd, vd, bias, n_split, split_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(mass.numpy(), want_mass.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(mass[2].numpy(), Hkv * Gq / S, rtol=1e-6)


# ---- the split-KV verify kernel's key split and combine ----


@pytest.mark.parametrize("B,Hkv,n_rows,Tk,n_sm", [
    (8, 8, 20, 2112, 132), (8, 8, 20, 640, 132), (8, 8, 64, 2112, 132),
    (8, 8, 20, 32, 132), (8, 8, 20, 257, 132), (6, 1, 20, 2048, 132),
    (1, 8, 20, 77, 132), (3, 2, 256, 5000, 16), (2, 4, 5, 1, 132)])
def test_verify_splits_cover_the_keys(B, Hkv, n_rows, Tk, n_sm):
    """The verify kernel's grid: row tiles cover the packed rows, the
    splits cover [0, Tk) in whole tiles with none empty, within one wave
    of CTAS_PER_SM CTAs an SM unless one split is all there is."""
    n_rt, n_split, split_len = fp_ops.verify_splits(B, Hkv, n_rows, Tk, n_sm)
    assert (n_rt - 1) * fp_ops.VERIFY_ROWS < n_rows <= n_rt * fp_ops.VERIFY_ROWS
    assert 1 <= n_split <= kbuild.SPLIT_MAX
    assert split_len % kbuild.SPLIT_TILE == 0
    starts = [s * split_len for s in range(n_split)]
    ends = [min(Tk, s + split_len) for s in starts]
    assert starts[0] == 0 and ends[-1] == Tk
    assert all(e > s for s, e in zip(starts, ends))          # none empty
    assert all(a == b for a, b in zip(ends, starts[1:]))     # contiguous
    ctas = B * Hkv * n_rt * n_split
    assert n_split == 1 or ctas <= kbuild.CTAS_PER_SM * n_sm


def test_verify_splits_fill_one_wave_at_the_serve_shape():
    """granite-8b, 8 slots, gamma 4 (Gq 4 x L 5 = 20 rows, one row tile),
    the `full` view of 2112 keys on 132 SMs: 8 splits of 288 keys, 512
    CTAs in one wave of 4 an SM, where one CTA per row tile gave 64."""
    assert fp_ops.verify_splits(8, 8, 20, 2112, 132) == (1, 8, 288)
    assert fp_ops.verify_splits(6, 1, 20, 2048, 132)[1] == kbuild.SPLIT_MAX


def test_shape_plans_make_each_plan_once():
    """A wrapper's per-shape plan is made (and its checks run) at the first
    call with its key only; a refused shape raises every time and leaves
    no plan behind."""
    made = []

    def make(n):
        if n < 0:
            raise ValueError(n)
        made.append(n)
        return (n, 2 * n)

    plans = kbuild.ShapePlans(make)
    assert plans(("a", 3), 3) == (3, 6)
    assert plans(("a", 3), 3) is plans(("a", 3), 3)
    assert plans(("b", 4), 4) == (4, 8)
    assert made == [3, 4]
    for _ in range(2):
        with pytest.raises(ValueError):
            plans(("c", -1), -1)
    assert made == [3, 4]


def _verify_split_combine(q, k, v, kv_pos, bias, q_pos, window, n_split,
                          split_len, tile=32):
    """The verify kernel's arithmetic in plain f32: per split and per
    16-key half of each tile (one warp each), an online softmax from
    m = -1e30 in which a masked key scores -1e30 and a key past the split
    takes no part; the halves merged, then the splits in split order."""
    B, L, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    neg = -1e30
    s = torch.einsum("bthgd,bshd->bhgts",
                     q.reshape(B, L, Hkv, Hq // Hkv, D), k) / math.sqrt(D)
    s = s + bias[:, None, None, None, :]
    ok = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        ok = ok & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    s = s.masked_fill(~ok[:, None, None], neg)

    def state(keys):
        if not keys:
            shape = s.shape[:-1] + (1,)
            return (torch.full(shape, neg), torch.zeros(shape),
                    torch.zeros(s.shape[:-1] + (D,)))
        si = s[..., keys]
        m = torch.clamp(si.amax(-1, keepdim=True), min=neg)
        p = torch.exp(si - m)
        return m, p.sum(-1, keepdim=True), torch.einsum(
            "bhgts,bshd->bhgtd", p, v[:, keys])

    def merge(parts):
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        Ls, O = torch.zeros_like(M), 0.0
        for m, ls, acc in parts:
            w = torch.exp(m - M)
            Ls, O = Ls + ls * w, O + acc * w
        return M, Ls, O

    parts = []
    for i in range(n_split):
        lo, hi = i * split_len, min(Tk, (i + 1) * split_len)
        halves = [[j for j in range(lo, hi) if (j - lo) % tile < 16],
                  [j for j in range(lo, hi) if (j - lo) % tile >= 16]]
        parts.append(merge([state(h) for h in halves]))
    _, Ls, O = merge(parts)
    return (O / Ls).permute(0, 3, 1, 2, 4).reshape(B, L, Hq, D)


@pytest.mark.parametrize("Tk,window", [(33, 0), (257, 0), (200, 16)])
def test_verify_split_combine_model_matches_plain(Tk, window):
    """The split-and-combine arithmetic equals `flash_verify_ref` in f32
    on rows that see every key, a row that sees none (uniform over exactly
    Tk keys), rows whose visible keys lie in the last split or the first
    (the other splits masked for every row) and a row whose keys are all
    invalid by the bias; Tk = 33 and 257 leave one key in the last
    split."""
    from repro_torch.kernels.flash_prefill.ref import flash_verify_ref
    rng = np.random.default_rng(Tk)
    B, L, Hq, Hkv, D = 5, 3, 4, 2, 16
    n_rt, n_split, split_len = fp_ops.verify_splits(B, Hkv, 2 * L, Tk, 132)
    assert n_split > 1
    q, k, v = (torch.tensor(rng.standard_normal(sh), dtype=torch.float32)
               for sh in ((B, L, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))
    idx = torch.arange(Tk)
    far = 2 ** 30
    last = (n_split - 1) * split_len
    kv_pos = torch.stack([idx, idx, torch.where(idx >= last, idx, far),
                          torch.where(idx < split_len, idx, far),
                          idx]).to(torch.int32)
    bias = torch.zeros(B, Tk)
    bias[4] = -1e30
    q_pos = (Tk + torch.arange(L))[None].repeat(B, 1)
    q_pos[1] = -1 - torch.arange(L)                 # sees no key
    q_pos = q_pos.to(torch.int32)
    want = flash_verify_ref(q, k, v, kv_pos, bias, q_pos, window=window)
    got = _verify_split_combine(q, k, v, kv_pos, bias, q_pos, window,
                                n_split, split_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    uniform = v.mean(1).repeat_interleave(Hq // Hkv, 1)     # [B, Hq, D]
    for b in (1, 4):
        np.testing.assert_allclose(got[b].numpy(),
                                   uniform[b][None].expand(L, -1, -1).numpy(),
                                   atol=1e-5, rtol=1e-5)
