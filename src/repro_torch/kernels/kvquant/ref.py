"""Plain PyTorch KIVI quantize-and-pack and dequantization (counterpart
of `repro.kernels.kvquant.ref`): the functions the CUDA kernels of
`kvquant.cu` compute — `core.quantization`'s, in the Pallas kernels'
layouts: codes ``[B, S, H, D*bits/8]`` int8; K scale / zero
``[B, S/G, H, D]`` f32, V ``[B, S, H]`` f32. Used for CPU tensors and,
on the card, by the tests and chip_smoke.py only."""
from __future__ import annotations

import torch

from repro_torch.core import quantization as qz


# the packed layout is `core.quantization`'s (the JAX package keeps the
# same two functions in both places)
pack_ref = qz.pack_codes
unpack_ref = qz.unpack_codes


def kquant_ref(k: torch.Tensor, bits: int, group: int):
    """K per channel over `group`-row groups: k [B, S, H, D] -> (packed,
    scale [B, S/G, H, D], zero [B, S/G, H, D]), by
    `quantization.quantize_k_per_channel` + `pack_codes`."""
    q = qz.quantize_k_per_channel(k, bits, group)
    return pack_ref(q.q, bits), q.scale[:, :, 0], q.zero[:, :, 0]


def vquant_ref(v: torch.Tensor, bits: int):
    """V per token over the head dim: v [B, S, H, D] -> (packed, scale
    [B, S, H], zero [B, S, H]), by `quantization.quantize_v_per_token`
    + `pack_codes`."""
    q = qz.quantize_v_per_token(v, bits)
    return pack_ref(q.q, bits), q.scale[..., 0], q.zero[..., 0]


def dequant_k_ref(packed, scale, zero, bits: int, group: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """K per channel: packed [B, S, H, Dp], scale/zero [B, S/G, H, D]."""
    B, S, H = packed.shape[:3]
    D = packed.shape[3] * 8 // bits
    codes = unpack_ref(packed, bits, D).reshape(B, S // group, group, H, D)
    x = codes.to(torch.float32) * scale[:, :, None] + zero[:, :, None]
    return x.reshape(B, S, H, D).to(dtype)


def dequant_v_ref(packed, scale, zero, bits: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """V per token: packed [B, S, H, Dp], scale/zero [B, S, H]."""
    D = packed.shape[-1] * 8 // bits
    codes = unpack_ref(packed, bits, D)
    return (codes.to(torch.float32) * scale[..., None]
            + zero[..., None]).to(dtype)
