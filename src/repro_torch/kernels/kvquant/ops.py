"""Fused KIVI quantize-and-pack: the CUDA kernels' wrappers and the
device dispatch (plain versions for CPU tensors, the kernels on the card
— no other path there)."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (CudaKernel, CudaSource, ShapePlans,
                                      stream_handle)
from repro_torch.kernels.kvquant import ref

_P, _I = ctypes.c_void_p, ctypes.c_int

SOURCE = CudaSource(Path(__file__).parent / "csrc" / "kvquant.cu")
kquant_kernel = CudaKernel(SOURCE, "kquant_launch", [_P] * 4 + [_I] * 7
                           + [_P])
vquant_kernel = CudaKernel(SOURCE, "vquant_launch", [_P] * 4 + [_I] * 6
                           + [_P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BITS = (2, 4, 8)


def _check(x, bits: int, group: int, what: str) -> None:
    """Raise unless the kernel takes `x` (run once per shape, from a
    plan)."""
    if (x.device.type != "cuda" or x.dtype not in _DTYPES or x.dim() != 4
            or bits not in BITS or group < 1 or x.shape[1] % group
            or (x.shape[3] * bits) % 8 or 0 in x.shape):
        raise ValueError(f"{what}: x {tuple(x.shape)} {x.dtype} {x.device}, "
                         f"bits {bits}, group {group} (CUDA f32 / bf16 "
                         f"[B, S, H, D], bits in {BITS}, S % group == 0, "
                         f"D * bits % 8 == 0)")


def _make_kquant_plan(k, bits: int, group: int):
    """`kquant_cuda`'s constants for one (shape, dtype, device, bits,
    group), checked once: the bytes of its one output allocation, the
    geometry of the three views into it (codes, then scale and zero at
    16-byte-aligned offsets) and the kernel's int arguments."""
    _check(k, bits, group, "kquant_cuda")
    B, S, H, D = k.shape
    Dp = D * bits // 8
    n_codes = -(-B * S * H * Dp // 16) * 16
    n_meta = -(-B * (S // group) * H * D * 4 // 16) * 16
    shape = (B, S // group, H, D)
    stride = ((S // group) * H * D, H * D, D, 1)
    return (n_codes + 2 * n_meta,
            ((B, S, H, Dp), (S * H * Dp, H * Dp, Dp, 1)),
            (shape, stride, n_codes // 4),
            (shape, stride, (n_codes + n_meta) // 4),
            n_codes, n_codes + n_meta,
            (B, S, H, D, group, bits, _DTYPES[k.dtype]))


def _make_vquant_plan(v, bits: int, group: int):
    """`vquant_cuda`'s constants, checked once: the codes' shape, the
    scale / zero shape and the kernel's int arguments."""
    _check(v, bits, group, "vquant_cuda")
    B, S, H, D = v.shape
    return ((B, S, H, D * bits // 8), (B, S, H),
            (B, S, H, D, bits, _DTYPES[v.dtype]))


_KQ_PLANS = ShapePlans(_make_kquant_plan)
_VQ_PLANS = ShapePlans(_make_vquant_plan)


def kquant_cuda(k, *, bits: int, group: int):
    """k: [B, S, H, D] (CUDA, f32 / bf16). KIVI keys, per channel over
    each `group`-row group: returns (packed int8 [B, S, H, D*bits/8],
    scale [B, S/G, H, D] f32, zero [B, S/G, H, D] f32), views of one
    allocation."""
    n_bytes, pk, sc, zr, o_scale, o_zero, args = _KQ_PLANS(
        (k.shape, k.dtype, k.device, bits, group), k, bits, group)
    k = k.contiguous()
    buf = torch.empty(n_bytes, dtype=torch.int8, device=k.device)
    meta = buf.view(torch.float32)
    base = buf.data_ptr()
    kquant_kernel(k.data_ptr(), base, base + o_scale, base + o_zero, *args,
                  stream_handle(k.device))
    return buf.as_strided(*pk), meta.as_strided(*sc), meta.as_strided(*zr)


def vquant_cuda(v, *, bits: int, group: int):
    """v: [B, S, H, D] (CUDA, f32 / bf16; S % group == 0, as the TPU
    kernel's grid requires). KIVI values, per token over D: returns
    (packed int8 [B, S, H, D*bits/8], scale [B, S, H] f32, zero
    [B, S, H] f32)."""
    pk, sz, args = _VQ_PLANS((v.shape, v.dtype, v.device, bits, group), v,
                             bits, group)
    v = v.contiguous()
    packed = torch.empty(pk, dtype=torch.int8, device=v.device)
    scale = torch.empty(sz, dtype=torch.float32, device=v.device)
    zero = torch.empty_like(scale)
    vquant_kernel(v.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  zero.data_ptr(), *args, stream_handle(v.device))
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
