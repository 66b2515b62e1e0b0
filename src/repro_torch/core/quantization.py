"""Quantization-family compression (counterpart of
`repro.core.quantization`): KIVI quantization of the main store
(asymmetric min/max, keys per channel over sequence groups, values per
token; codes bit-packed into int8 lanes), QAQ-style mixed bit widths and
the GEAR low-rank + sparse-outlier residual. SSM-state quantization waits
for the SSM mixer.

GEAR's power iteration starts from a Gaussian draw; it goes through
`normal` (as `lexico`'s dictionary does), where the JAX function draws
from ``key``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Quantized(NamedTuple):
    q: torch.Tensor       # uint8 codes in [0, 2^bits - 1] (or packed int8)
    scale: torch.Tensor   # f32, broadcastable against q
    zero: torch.Tensor    # f32 (the minimum), broadcastable against q

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale + self.zero).to(dtype)


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes in [0, 2^bits) along the last axis into int8 lanes
    (little-endian in bit order; biased by -128). [..., D] -> [..., D*bits/8]."""
    f = 8 // bits
    *lead, D = q.shape
    qf = q.to(torch.int32).reshape(*lead, D // f, f)
    shifts = torch.arange(f, dtype=torch.int32, device=q.device) * bits
    packed = (qf << shifts).sum(dim=-1)
    return (packed - 128).to(torch.int8)


def unpack_codes(p: torch.Tensor, bits: int, D: int) -> torch.Tensor:
    """Inverse of `pack_codes`. [..., D*bits/8] int8 -> [..., D] int32."""
    f = 8 // bits
    x = p.to(torch.int32) + 128
    shifts = torch.arange(f, dtype=torch.int32, device=p.device) * bits
    codes = (x[..., None] >> shifts) & ((1 << bits) - 1)
    return codes.reshape(*p.shape[:-1], D)


def _minmax_quant(x: torch.Tensor, bits: int, dims) -> Quantized:
    """Asymmetric min/max quantization reducing over `dims`."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits={bits}")
    xf = x.float()
    lo = xf.amin(dim=dims, keepdim=True)
    hi = xf.amax(dim=dims, keepdim=True)
    levels = (1 << bits) - 1
    # a 0-d divisor on the device: PyTorch's CUDA division by a Python
    # number multiplies by its reciprocal, one bit off the IEEE quotient
    # of the JAX package and of the fused kernel (`kernels/kvquant`)
    scale = torch.clamp(hi - lo, min=1e-8) / torch.full(
        (), levels, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round((xf - lo) / scale), 0, levels).to(torch.uint8)
    return Quantized(q, scale, lo)


def quantize_k_per_channel(k: torch.Tensor, bits: int, group: int) -> Quantized:
    """KIVI key layout. k: [..., S, H, D]; scales per (group, H, D).
    Returns q with k's shape; scale/zero [..., S/g, 1, H, D]."""
    *lead, S, H, D = k.shape
    if S % group:
        raise ValueError(f"S={S} not a multiple of group={group}")
    kg = k.reshape(*lead, S // group, group, H, D)
    qz = _minmax_quant(kg, bits, dims=(-3,))
    return Quantized(qz.q.reshape(*lead, S, H, D), qz.scale, qz.zero)


def dequantize_k_per_channel(qz: Quantized, group: int,
                             dtype=torch.bfloat16) -> torch.Tensor:
    *lead, S, H, D = qz.q.shape
    qg = qz.q.reshape(*lead, S // group, group, H, D)
    return Quantized(qg, qz.scale, qz.zero).dequantize(dtype).reshape(
        *lead, S, H, D)


def quantize_v_per_token(v: torch.Tensor, bits: int) -> Quantized:
    """KIVI value layout. v: [..., S, H, D]; scales per (S, H)."""
    return _minmax_quant(v, bits, dims=(-1,))


def dequantize_v_per_token(qz: Quantized,
                           dtype=torch.bfloat16) -> torch.Tensor:
    return qz.dequantize(dtype)


def quant_error_bound(x: torch.Tensor, bits: int, dims) -> torch.Tensor:
    """Tight per-group error bound: |x - deq(q(x))| <= scale/2 elementwise."""
    xf = x.float()
    lo = xf.amin(dim=dims, keepdim=True)
    hi = xf.amax(dim=dims, keepdim=True)
    return torch.clamp(hi - lo, min=1e-8) / ((1 << bits) - 1) / 2.0


# ---------------------------------------------------------------------------
# QAQ-style mixed precision (survey [19]): per-(layer, head) bit widths from
# a sensitivity signal (attention mass), mapped onto {8, 4, 2} bits.
# ---------------------------------------------------------------------------


def qaq_bit_allocation(sensitivity: torch.Tensor, budget_bits: float,
                       choices=(2, 4, 8)) -> torch.Tensor:
    """sensitivity: [...]; returns same-shape int32 bit widths whose mean
    is <= budget_bits, giving more bits to more sensitive groups. Ranks
    come from stable sorts, so tied sensitivities rank in index order,
    as JAX's stable argsort ranks them."""
    flat = sensitivity.reshape(-1)
    order = torch.argsort(torch.argsort(flat, stable=True), stable=True)
    frac = (order + 0.5) / flat.numel()
    lo_b, mid_b, hi_b = choices
    # thresholds chosen so mean(bits) == budget_bits for uniform ranks;
    # c and a are f32 as JAX's clipped weak floats are
    f32 = dict(dtype=torch.float32, device=flat.device)
    c = torch.clamp(torch.tensor((budget_bits - mid_b) / (hi_b - mid_b),
                                 **f32), 0.0, 1.0)
    a = torch.clamp(torch.tensor((mid_b - budget_bits) / (mid_b - lo_b),
                                 **f32), 0.0, 1.0)
    bits = torch.where(frac >= 1.0 - c, hi_b,
                       torch.where(frac < a, lo_b, mid_b))
    return bits.reshape(sensitivity.shape).to(torch.int32)


# ---------------------------------------------------------------------------
# GEAR (survey [29]): quantize, then approximate the residual with a low-rank
# term (subspace/power iteration) + a sparse outlier term.
# ---------------------------------------------------------------------------


def normal(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard normal draws, f32, of `shape` on `device` from `generator`
    (GEAR's start vectors, the Lexico dictionary's atoms; the values
    differ from `jax.random.normal`'s)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


class GearCompressed(NamedTuple):
    base: Quantized              # quantized main term
    u: torch.Tensor              # [..., M, r]
    vt: torch.Tensor             # [..., r, N]
    outlier_vals: torch.Tensor   # [..., k] top-|residual| entries
    outlier_idx: torch.Tensor    # [..., k] flat indices into (M*N)


def gear_compress(x: torch.Tensor, bits: int, rank: int, n_outliers: int,
                  n_iter: int = 2, *,
                  generator: Optional[torch.Generator] = None
                  ) -> GearCompressed:
    """x: [..., M, N]. base-quant (per-token over last axis) + rank-r power
    iteration on the residual + top-k sparse outliers of what remains.
    `generator` None: a generator seeded 0 (JAX's default key(0))."""
    base = _minmax_quant(x, bits, dims=(-1,))
    resid = x.float() - base.dequantize(torch.float32)
    *lead, M, N = resid.shape
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    v = normal((*lead, N, rank), generator, x.device)
    for _ in range(n_iter):
        u, _ = torch.linalg.qr(resid @ v)                     # [..., M, r]
        v, _ = torch.linalg.qr(resid.transpose(-1, -2) @ u)   # [..., N, r]
    u = resid @ v                                             # [..., M, r]
    vt = v.transpose(-1, -2)                                  # [..., r, N]
    flat = (resid - u @ vt).reshape(*lead, M * N)
    _, idx = torch.topk(flat.abs(), n_outliers, dim=-1)
    return GearCompressed(base, u, vt, torch.gather(flat, -1, idx), idx)


def gear_decompress(c: GearCompressed, shape,
                    dtype=torch.bfloat16) -> torch.Tensor:
    *lead, M, N = shape
    x = c.base.dequantize(torch.float32) + c.u @ c.vt
    flat = _scatter_last(x.reshape(*lead, M * N), c.outlier_idx,
                         c.outlier_vals)
    return flat.reshape(*shape).to(dtype)


def _scatter_last(x: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Add vals at idx along the last axis (residual correction)."""
    *lead, N = x.shape
    k = idx.shape[-1]
    out = x.reshape(-1, N).clone()
    out.scatter_add_(1, idx.reshape(-1, k), vals.reshape(-1, k).to(out.dtype))
    return out.reshape(*lead, N)


def kv_logical_bytes(
    seq: int, heads: int, head_dim: int, *, bits: int, group: int,
    residual_window: int, base_bytes: float = 2.0,
) -> float:
    """Logical bytes per layer per sequence of a quantized KV cache
    (codes + scales/zeros + full-precision residual window)."""
    quant_tokens = max(seq - residual_window, 0)
    code = 2 * quant_tokens * heads * head_dim * bits / 8.0
    k_meta = (quant_tokens / max(group, 1)) * heads * head_dim * 2 * 4.0
    v_meta = quant_tokens * heads * 2 * 4.0
    resid = 2 * min(residual_window, seq) * heads * head_dim * base_bytes
    return code + k_meta + v_meta + resid
