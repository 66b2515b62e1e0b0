"""Fused KIVI quantize-and-pack: the CUDA kernels' wrappers and the
device dispatch (plain versions for CPU tensors, the kernels on the card
— no other path there)."""
from __future__ import annotations

import ctypes
import math
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
kvquant_kernel = CudaKernel(SOURCE, "kvquant_launch", [_P] * 8 + [_I] * 7
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


def _layout(*parts):
    """One int8 allocation for a wrapper's outputs: `parts` are (shape,
    element bytes: 1 int8, 4 f32), laid end to end, each at a
    16-byte-aligned offset. Returns (bytes, the byte offsets, per part
    (shape, stride, offset in elements, element bytes))."""
    n, offs, views = 0, [], []
    for shape, esize in parts:
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        offs.append(n)
        views.append((tuple(shape), stride, n // esize, esize))
        n += -(-math.prod(shape) * esize // 16) * 16
    return n, tuple(offs), tuple(views)


def _k_parts(B, S, H, D, bits, group):
    return (((B, S, H, D * bits // 8), 1), ((B, S // group, H, D), 4),
            ((B, S // group, H, D), 4))


def _v_parts(B, S, H, D, bits):
    return ((B, S, H, D * bits // 8), 1), ((B, S, H), 4), ((B, S, H), 4)


def _make_kquant_plan(k, bits: int, group: int):
    """`kquant_cuda`'s constants for one (shape, dtype, device, bits,
    group), checked once: the output layout (codes, scale, zero) and the
    kernel's int arguments."""
    _check(k, bits, group, "kquant_cuda")
    B, S, H, D = k.shape
    return (*_layout(*_k_parts(B, S, H, D, bits, group)),
            (B, S, H, D, group, bits, _DTYPES[k.dtype]))


def _make_vquant_plan(v, bits: int, group: int):
    """`vquant_cuda`'s constants, checked once: the output layout (codes,
    scale, zero) and the kernel's int arguments."""
    _check(v, bits, group, "vquant_cuda")
    B, S, H, D = v.shape
    return (*_layout(*_v_parts(B, S, H, D, bits)),
            (B, S, H, D, bits, _DTYPES[v.dtype]))


def _make_kvquant_plan(k, v, bits: int, group: int):
    """`kvquant_cuda`'s constants, checked once: k and v alike, the
    layout of the six outputs (K codes, scale, zero, then V's) and the
    kernel's int arguments."""
    _check(k, bits, group, "kvquant_cuda")
    _check(v, bits, group, "kvquant_cuda")
    if k.shape != v.shape or k.dtype != v.dtype or k.device != v.device:
        raise ValueError(f"kvquant_cuda: k {tuple(k.shape)} {k.dtype} "
                         f"{k.device} and v {tuple(v.shape)} {v.dtype} "
                         f"{v.device} differ")
    B, S, H, D = k.shape
    return (*_layout(*_k_parts(B, S, H, D, bits, group),
                     *_v_parts(B, S, H, D, bits)),
            (B, S, H, D, group, bits, _DTYPES[k.dtype]))


_KQ_PLANS = ShapePlans(_make_kquant_plan)
_VQ_PLANS = ShapePlans(_make_vquant_plan)
_KVQ_PLANS = ShapePlans(_make_kvquant_plan)


def _launch(kernel, plan, inputs, device):
    """One allocation for the plan's outputs, `kernel` on `inputs` (data
    pointers of contiguous tensors) and their int arguments; returns the
    outputs as views of the allocation."""
    n_bytes, offs, views, args = plan
    buf = torch.empty(n_bytes, dtype=torch.int8, device=device)
    base = buf.data_ptr()
    kernel(*inputs, *[base + o for o in offs], *args, stream_handle(device))
    f32 = buf.view(torch.float32)
    return [(buf if esize == 1 else f32).as_strided(shape, stride, off)
            for shape, stride, off, esize in views]


def kquant_cuda(k, *, bits: int, group: int):
    """k: [B, S, H, D] (CUDA, f32 / bf16). KIVI keys, per channel over
    each `group`-row group: returns (packed int8 [B, S, H, D*bits/8],
    scale [B, S/G, H, D] f32, zero [B, S/G, H, D] f32), views of one
    allocation."""
    plan = _KQ_PLANS((k.shape, k.dtype, k.device, bits, group), k, bits,
                     group)
    k = k.contiguous()
    return tuple(_launch(kquant_kernel, plan, (k.data_ptr(),), k.device))


def vquant_cuda(v, *, bits: int, group: int):
    """v: [B, S, H, D] (CUDA, f32 / bf16; S % group == 0, as the TPU
    kernel's grid requires). KIVI values, per token over D: returns
    (packed int8 [B, S, H, D*bits/8], scale [B, S, H] f32, zero
    [B, S, H] f32), views of one allocation."""
    plan = _VQ_PLANS((v.shape, v.dtype, v.device, bits, group), v, bits,
                     group)
    v = v.contiguous()
    return tuple(_launch(vquant_kernel, plan, (v.data_ptr(),), v.device))


def kvquant_cuda(k, v, *, bits: int, group: int):
    """k, v: [B, S, H, D] (CUDA, one shape and dtype, f32 / bf16). KIVI
    keys and values of one flush or admission in one launch: returns
    ((K packed, scale, zero) as `kquant_cuda`, (V packed, scale, zero) as
    `vquant_cuda`), views of one allocation."""
    plan = _KVQ_PLANS((k.shape, k.dtype, k.device, v.shape, v.dtype,
                       v.device, bits, group), k, v, bits, group)
    k, v = k.contiguous(), v.contiguous()
    out = _launch(kvquant_kernel, plan, (k.data_ptr(), v.data_ptr()),
                  k.device)
    return tuple(out[:3]), tuple(out[3:])


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


def quantize_kv_pair(k, v, *, bits: int, group: int):
    """KIVI keys and values of one flush or admission (shapes as
    `kvquant_cuda`): one kernel launch on the card, the plain versions on
    the CPU. Returns ((K packed, scale, zero), (V packed, scale, zero))."""
    if k.device.type == "cpu":
        return ref.kquant_ref(k, bits, group), ref.vquant_ref(v, bits)
    return kvquant_cuda(k, v, bits=bits, group=group)
