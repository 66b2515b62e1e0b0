"""Plain PyTorch dequantization of the KIVI packed layout (the helpers
the decode plain version uses). Counterpart of
`repro.kernels.kvquant.ref`; the fused quantize kernel itself
(`kquant_pallas` / `vquant_pallas`) is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import unpack_codes


def dequant_k_ref(packed, scale, zero, bits: int, group: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """K per channel: packed [B, S, H, Dp], scale/zero [B, S/G, H, D]."""
    B, S, H = packed.shape[:3]
    D = packed.shape[3] * 8 // bits
    codes = unpack_codes(packed, bits, D).reshape(B, S // group, group, H,
                                                 D)
    x = codes.to(torch.float32) * scale[:, :, None] + zero[:, :, None]
    return x.reshape(B, S, H, D).to(dtype)


def dequant_v_ref(packed, scale, zero, bits: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """V per token: packed [B, S, H, Dp], scale/zero [B, S, H]."""
    D = packed.shape[-1] * 8 // bits
    codes = unpack_codes(packed, bits, D)
    return (codes.to(torch.float32) * scale[..., None]
            + zero[..., None]).to(dtype)
