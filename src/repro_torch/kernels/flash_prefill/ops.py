"""Causal flash prefill, monolithic and chunked, and the speculative-verify
attention: the CUDA kernels' wrappers, and the device dispatch (plain
versions for CPU tensors, the kernels on the card — no other path
there)."""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import (CudaKernel, CudaSource,
                                      DeviceScratch, ShapePlans,
                                      decode_splits, sm_count, stream_handle)
from repro_torch.kernels.flash_prefill import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SOURCE = CudaSource(Path(__file__).parent / "csrc" / "flash_prefill.cu")
flash_prefill_kernel = CudaKernel(SOURCE, "flash_prefill_launch",
                                  [_P] * 4 + [_I] * 7 + [_F, _P])
flash_prefill_chunk_kernel = CudaKernel(SOURCE, "flash_prefill_chunk_launch",
                                        [_P] * 4 + [_I] * 9 + [_F, _P])
flash_verify_kernel = CudaKernel(SOURCE, "flash_verify_launch",
                                 [_P] * 9 + [_I] * 10 + [_F, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
VERIFY_L_MAX = 16
VERIFY_ROWS = 32   # packed query rows (t*Gq + g) per CTA of the verify kernel


def _check(q, k, v, what):
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if (q.device.type != "cuda" or q.dtype not in _DTYPES
            or k.dtype != q.dtype or v.dtype != q.dtype
            or D not in HEAD_DIMS or Hkv < 1 or Hq % Hkv
            or tuple(k.shape) != (B, Tk, Hkv, D) or k.shape != v.shape
            or k.device != q.device or v.device != q.device):
        raise ValueError(f"{what}: q {tuple(q.shape)} {q.dtype} {q.device}, "
                         f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} (CUDA, D in {HEAD_DIMS})")


def _aligned(*ts):
    """The tensors, each copied where its data is not 16-byte aligned:
    the kernels move rows in 16-byte pieces."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def flash_prefill_cuda(q, k, v, *, window: int = 0):
    """q: [B, T, Hq, D]; k, v: [B, T, Hkv, D] (CUDA, one dtype of f32 /
    bf16, D in HEAD_DIMS). Causal, optionally sliding-window attention;
    returns [B, T, Hq, D] in q.dtype."""
    _check(q, k, v, "flash_prefill_cuda")
    B, T, Hq, D = q.shape
    if k.shape[1] != T:
        raise ValueError(f"flash_prefill_cuda: {T} queries, {k.shape[1]} keys")
    q, k, v = _aligned(q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    flash_prefill_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, T, Hq, k.shape[2], D,
                         int(window), _DTYPES[q.dtype], 1.0 / math.sqrt(D),
                         stream_handle(q.device))
    return out


def flash_prefill_chunk_cuda(q, k, v, *, q_offset: int, window: int = 0):
    """q: [B, Tq, Hq, D], one prompt segment at absolute rows q_offset ..
    q_offset+Tq-1; k, v: [B, Tk, Hkv, D], the prompt scratch (rows past
    the segment may hold anything: they are masked by position).
    q_offset is a host int with q_offset + Tq <= Tk. Returns
    [B, Tq, Hq, D] in q.dtype."""
    _check(q, k, v, "flash_prefill_chunk_cuda")
    B, Tq, Hq, D = q.shape
    Tk = k.shape[1]
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset + Tq > Tk:
        raise ValueError(f"flash_prefill_chunk_cuda: segment {q_offset}+"
                         f"{Tq} outside the {Tk}-row scratch")
    q, k, v = _aligned(q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    flash_prefill_chunk_kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
        q_offset, Hq, k.shape[2], D, int(window), _DTYPES[q.dtype],
        1.0 / math.sqrt(D), stream_handle(q.device))
    return out


def verify_splits(B: int, Hkv: int, n_rows: int, Tk: int, n_sm: int):
    """Grid of the verify kernel: (n_row_tiles, n_split, split_len). It
    runs one CTA per (sequence, kv head, VERIFY_ROWS-row tile of the
    n_rows = Gq*L packed query rows, split of the Tk keys); the splits are
    `decode_splits`' for B*n_row_tiles sequences: one wave of
    CTAS_PER_SM CTAs on each of `n_sm` SMs, whole SPLIT_TILE-key tiles
    (the verify kernel's key tile too), at most SPLIT_MAX, covering
    [0, Tk) with none empty."""
    n_rt = -(-n_rows // VERIFY_ROWS)
    return (n_rt, *decode_splits(B * n_rt, Hkv, Tk, n_sm))


def _make_verify_plan(q, k, v, kv_pos, bias, q_pos):
    """`flash_verify_cuda`'s launch constants for these operands' shapes,
    dtypes and device, checked once: (partials floats, tickets, the
    kernel's int arguments B .. D, dtype, n_split, split_len, scale)."""
    _check(q, k, v, "flash_verify_cuda")
    B, L, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if not 1 <= L <= VERIFY_L_MAX:
        raise ValueError(f"flash_verify_cuda: segment length {L} not in "
                         f"1..{VERIFY_L_MAX}")
    for t, dt, shape, what in ((kv_pos, torch.int32, (B, Tk), "kv_pos"),
                               (bias, torch.float32, (B, Tk), "bias"),
                               (q_pos, torch.int32, (B, L), "q_pos")):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"flash_verify_cuda: {what} {tuple(t.shape)} "
                             f"{t.dtype} {t.device}, want {shape} {dt}")
    n_rt, n_split, split_len = verify_splits(B, Hkv, (Hq // Hkv) * L, Tk,
                                             sm_count(q.device))
    # per (sequence, kv head, row tile, split, row): acc[D], m, l, 2 pad
    return (B * Hkv * n_rt * n_split * VERIFY_ROWS * (D + 4), B * Hkv * n_rt,
            (B, L, Tk, Hq, Hkv, D), _DTYPES[q.dtype], n_split, split_len,
            1.0 / math.sqrt(D))


_VERIFY_PLANS = ShapePlans(_make_verify_plan)
# B5's own partials scratch and zeroed ticket counters (one per (sequence,
# kv head, row tile)), apart from the decode kernels'
_VERIFY_PARTIALS = DeviceScratch("float32")
_VERIFY_TICKETS = DeviceScratch("int32", zeroed=True)


def flash_verify_cuda(q, k, v, kv_pos, bias, q_pos, *, window: int = 0):
    """q: [B, L, Hq, D] (L <= VERIFY_L_MAX), one speculated segment per
    row at absolute positions q_pos [B, L] int32; k, v: [B, Tk, Hkv, D],
    the materialized cache view, its rows at kv_pos [B, Tk] int32 with the
    additive validity bias [B, Tk] f32 (CUDA, one dtype of f32 / bf16, D
    in HEAD_DIMS). Returns [B, L, Hq, D] in q.dtype (`ref.flash_verify_ref`)."""
    key = (q.shape, k.shape, v.shape, kv_pos.shape, bias.shape, q_pos.shape,
           q.dtype, k.dtype, v.dtype, kv_pos.dtype, bias.dtype, q_pos.dtype,
           q.device, k.device, v.device, kv_pos.device, bias.device,
           q_pos.device)
    n_part, n_tickets, dims, dtype, n_split, split_len, scale = \
        _VERIFY_PLANS(key, q, k, v, kv_pos, bias, q_pos)
    part = _VERIFY_PARTIALS(q.device, n_part)
    tickets = _VERIFY_TICKETS(q.device, n_tickets)
    q, k, v = _aligned(q.contiguous(), k.contiguous(), v.contiguous())
    kv_pos, bias, q_pos = (kv_pos.contiguous(), bias.contiguous(),
                           q_pos.contiguous())
    out = torch.empty_like(q)
    flash_verify_kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        bias.data_ptr(), q_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), *dims, int(window), dtype, n_split, split_len,
        scale, stream_handle(q.device))
    return out


def flash_attention(q, k, v, *, window: int = 0):
    """Causal flash attention (shapes as `flash_prefill_cuda`): the
    kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, window=window)
    return flash_prefill_cuda(q, k, v, window=window)


def flash_attention_chunk(q, k, v, *, q_offset: int, window: int = 0):
    """Chunked-prefill flash attention (shapes as
    `flash_prefill_chunk_cuda`): the kernel on the card, the plain
    version on the CPU."""
    if q.device.type == "cpu":
        return ref.flash_prefill_chunk_ref(q, k, v, q_offset=q_offset,
                                           window=window)
    return flash_prefill_chunk_cuda(q, k, v, q_offset=q_offset, window=window)


def flash_verify(q, k, v, kv_pos, bias, q_pos, *, window: int = 0):
    """Speculative-verify attention (shapes as `flash_verify_cuda`): the
    kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return ref.flash_verify_ref(q, k, v, kv_pos, bias, q_pos,
                                    window=window)
    return flash_verify_cuda(q, k, v, kv_pos, bias, q_pos, window=window)
