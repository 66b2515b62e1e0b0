"""Fused KIVI quantize-and-pack: the CUDA kernels' wrappers and the
device dispatch (plain versions for CPU tensors, the kernels on the card
— no other path there)."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, CudaSource, stream_handle
from repro_torch.kernels.kvquant import ref

_P, _I = ctypes.c_void_p, ctypes.c_int

SOURCE = CudaSource(Path(__file__).parent / "csrc" / "kvquant.cu")
kquant_kernel = CudaKernel(SOURCE, "kquant_launch", [_P] * 4 + [_I] * 7
                           + [_P])
vquant_kernel = CudaKernel(SOURCE, "vquant_launch", [_P] * 4 + [_I] * 6
                           + [_P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BITS = (2, 4, 8)


def _check(x, bits: int, group: int, what: str):
    if (x.device.type != "cuda" or x.dtype not in _DTYPES or x.dim() != 4
            or bits not in BITS or group < 1 or x.shape[1] % group
            or (x.shape[3] * bits) % 8 or 0 in x.shape):
        raise ValueError(f"{what}: x {tuple(x.shape)} {x.dtype} {x.device}, "
                         f"bits {bits}, group {group} (CUDA f32 / bf16 "
                         f"[B, S, H, D], bits in {BITS}, S % group == 0, "
                         f"D * bits % 8 == 0)")
    return x.contiguous()


def kquant_cuda(k, *, bits: int, group: int):
    """k: [B, S, H, D] (CUDA, f32 / bf16). KIVI keys, per channel over
    each `group`-row group: returns (packed int8 [B, S, H, D*bits/8],
    scale [B, S/G, H, D] f32, zero [B, S/G, H, D] f32)."""
    k = _check(k, bits, group, "kquant_cuda")
    B, S, H, D = k.shape
    packed = torch.empty((B, S, H, D * bits // 8), dtype=torch.int8,
                         device=k.device)
    scale = torch.empty((B, S // group, H, D), dtype=torch.float32,
                        device=k.device)
    zero = torch.empty_like(scale)
    kquant_kernel(k.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  zero.data_ptr(), B, S, H, D, group, bits,
                  _DTYPES[k.dtype], stream_handle(k.device))
    return packed, scale, zero


def vquant_cuda(v, *, bits: int, group: int):
    """v: [B, S, H, D] (CUDA, f32 / bf16; S % group == 0, as the TPU
    kernel's grid requires). KIVI values, per token over D: returns
    (packed int8 [B, S, H, D*bits/8], scale [B, S, H] f32, zero
    [B, S, H] f32)."""
    v = _check(v, bits, group, "vquant_cuda")
    B, S, H, D = v.shape
    packed = torch.empty((B, S, H, D * bits // 8), dtype=torch.int8,
                         device=v.device)
    scale = torch.empty((B, S, H), dtype=torch.float32, device=v.device)
    zero = torch.empty_like(scale)
    vquant_kernel(v.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  zero.data_ptr(), B, S, H, D, bits, _DTYPES[v.dtype],
                  stream_handle(v.device))
    return packed, scale, zero


def quantize_k(k, *, bits: int, group: int):
    """KIVI keys (shapes as `kquant_cuda`): the kernel on the card, the
    plain version on the CPU."""
    if k.device.type == "cpu":
        return ref.kquant_ref(k, bits, group)
    return kquant_cuda(k, bits=bits, group=group)


def quantize_v(v, *, bits: int, group: int):
    """KIVI values (shapes as `vquant_cuda`): the kernel on the card, the
    plain version on the CPU."""
    if v.device.type == "cpu":
        return ref.vquant_ref(v, bits)
    return vquant_cuda(v, bits=bits, group=group)
