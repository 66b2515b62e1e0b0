"""Causal flash prefill: the CUDA kernel's wrapper, and the device
dispatch (plain version for CPU tensors, the kernel on the card — no
other path there)."""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle
from repro_torch.kernels.flash_prefill import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

flash_prefill_kernel = CudaKernel(
    Path(__file__).parent / "csrc" / "flash_prefill.cu",
    "flash_prefill_launch", [_P] * 4 + [_I] * 7 + [_F, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def flash_prefill_cuda(q, k, v, *, window: int = 0):
    """q: [B, T, Hq, D]; k, v: [B, T, Hkv, D] (CUDA, one dtype of f32 /
    bf16, D in HEAD_DIMS). Causal, optionally sliding-window attention;
    returns [B, T, Hq, D] in q.dtype."""
    if q.device.type != "cuda":
        raise ValueError("flash_prefill_cuda takes CUDA tensors")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or D not in HEAD_DIMS or Hkv < 1 or Hq % Hkv
            or tuple(k.shape) != (B, T, Hkv, D) or k.shape != v.shape
            or k.device != q.device or v.device != q.device):
        raise ValueError(f"flash_prefill_cuda: q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v "
                         f"{tuple(v.shape)} {v.dtype} (D in {HEAD_DIMS})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    flash_prefill_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, T, Hq, Hkv, D, int(window),
                         _DTYPES[q.dtype], 1.0 / math.sqrt(D),
                         stream_handle(q.device))
    return out


def flash_attention(q, k, v, *, window: int = 0):
    """Causal flash attention (shapes as `flash_prefill_cuda`): the
    kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, window=window)
    return flash_prefill_cuda(q, k, v, window=window)
