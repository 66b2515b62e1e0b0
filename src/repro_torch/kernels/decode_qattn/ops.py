"""Fused decode attention over [main store | residual ring]: the CUDA
kernel's wrapper, and the device dispatch.

`decode_attention_fused` runs the plain version (`ref.decode_attn_ref`)
for tensors on the CPU and the CUDA kernel (`decode_attn_cuda`) for
tensors on the card; on the card there is no other path — a shape or
type the kernel does not take raises."""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle
from repro_torch.kernels.decode_qattn import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

decode_attn_kernel = CudaKernel(
    Path(__file__).parent / "csrc" / "decode_attn.cu", "decode_attn_launch",
    [_P] * 14 + [_I] * 10 + [_F, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX, GQ_MAX = 128, 16


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_attn_cuda(q, k, k_scale, k_zero, v, v_scale, v_zero, bias_main,
                     rk, rv, bias_ring, *, bits: int, group: int,
                     return_mass: bool = False, compute_dtype=None):
    """Launch the CUDA kernel (tensors on the card, contiguous).

    q: [B, Hq, D] f32|bf16. Main store, bits < 16: k/v [B, S, Hkv,
    D*bits/8] int8 packed codes, k_scale/k_zero [B, S/group, Hkv, D] f32,
    v_scale/v_zero [B, S, Hkv] f32; bits == 16: k/v [B, S, Hkv, D] in
    q's dtype and the scales None. bias_main [B, S] f32. Ring (or all
    None): rk/rv [B, W, Hkv, D] in q's dtype, bias_ring [B, W] f32.
    compute_dtype bf16 rounds dequantized K/V through bf16 (the model
    dtype); None/f32 keeps them in f32.

    Returns (out [B, Hq, D] in q.dtype, mass [B, S+W] f32 | None)."""
    if q.device.type != "cuda":
        raise ValueError("decode_attn_cuda takes CUDA tensors")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported q dtype {q.dtype}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    W = rk.shape[1] if rk is not None else 0
    Gq = Hq // Hkv if Hkv else 0
    quant = bits < 16
    if Hkv < 1 or Hq % Hkv or Gq > GQ_MAX or D > D_MAX or S < 1:
        raise ValueError(f"shape out of range: Hq={Hq} Hkv={Hkv} D={D} "
                         f"S={S} (Gq <= {GQ_MAX}, D <= {D_MAX})")
    if quant:
        if bits not in (2, 4, 8) or D % (8 // bits) or S % group:
            raise ValueError(f"bits={bits} group={group} D={D} S={S} "
                             "not tileable")
        packed = (B, S, Hkv, D * bits // 8)
        kmeta, vmeta = (B, S // group, Hkv, D), (B, S, Hkv)
        tensors = [(k, torch.int8, packed), (v, torch.int8, packed),
                   (k_scale, torch.float32, kmeta),
                   (k_zero, torch.float32, kmeta),
                   (v_scale, torch.float32, vmeta),
                   (v_zero, torch.float32, vmeta)]
    else:
        if bits != 16:
            raise ValueError(f"bits={bits}")
        tensors = [(k, q.dtype, (B, S, Hkv, D)), (v, q.dtype, (B, S, Hkv, D))]
    tensors.append((bias_main, torch.float32, (B, S)))
    if W:
        tensors += [(rk, q.dtype, (B, W, Hkv, D)), (rv, q.dtype, (B, W, Hkv, D)),
                    (bias_ring, torch.float32, (B, W))]
    for t, dt, shape in tensors:
        if (t.device != q.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} "
                             f"{t.device}: want contiguous {shape} {dt} "
                             f"on {q.device}")
    q = q.contiguous()
    out = torch.empty_like(q)
    scores = mass_h = None
    if return_mass:
        scores = torch.empty((B, Hkv, Gq, S + W), dtype=torch.float32,
                             device=q.device)
        mass_h = torch.empty((B, Hkv, S + W), dtype=torch.float32,
                             device=q.device)
    decode_attn_kernel(
        _ptr(q), _ptr(k), _ptr(k_scale if quant else None),
        _ptr(k_zero if quant else None), _ptr(v),
        _ptr(v_scale if quant else None), _ptr(v_zero if quant else None),
        _ptr(bias_main), _ptr(rk if W else None), _ptr(rv if W else None),
        _ptr(bias_ring if W else None), _ptr(out), _ptr(scores),
        _ptr(mass_h), B, S, W, Hkv, Gq, D, group if quant else 1, bits,
        _DTYPES[q.dtype], int(compute_dtype == torch.bfloat16),
        1.0 / math.sqrt(D), stream_handle(q.device))
    return out, (mass_h.sum(dim=1) if return_mass else None)


def decode_attention_fused(q, k, k_scale, k_zero, v, v_scale, v_zero,
                           bias_main, rk, rv, bias_ring, *, bits: int,
                           group: int, return_mass: bool = False,
                           compute_dtype=None):
    """Decode attention over [main store | ring] (shapes as
    `decode_attn_cuda`): the kernel on the card, the plain version on
    the CPU. Returns (out, mass | None)."""
    if q.device.type == "cpu":
        out, mass = ref.decode_attn_ref(
            q, k, k_scale, k_zero, v, v_scale, v_zero, bias_main, rk, rv,
            bias_ring, bits=bits, group=group,
            compute_dtype=compute_dtype or torch.float32)
        return out, (mass if return_mass else None)
    return decode_attn_cuda(q, k, k_scale, k_zero, v, v_scale, v_zero,
                            bias_main, rk, rv, bias_ring, bits=bits,
                            group=group, return_mass=return_mass,
                            compute_dtype=compute_dtype)
