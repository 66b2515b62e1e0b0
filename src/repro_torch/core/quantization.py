"""KIVI quantization of the main store (counterpart of
`repro.core.quantization`, main-path functions only): asymmetric min/max,
keys per channel over sequence groups, values per token; codes bit-packed
into int8 lanes. GEAR / QAQ / SSM-state quantization are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

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


def quantize_v_per_token(v: torch.Tensor, bits: int) -> Quantized:
    """KIVI value layout. v: [..., S, H, D]; scales per (S, H)."""
    return _minmax_quant(v, bits, dims=(-1,))


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
