"""Fused decode attention over [main store | residual ring]: the CUDA
kernels' wrappers, and the device dispatch.

`decode_attention_fused` (dense store) and `decode_attention_paged`
(paged pool through a block table) run the plain versions
(`ref.decode_attn_ref`, `ref.decode_attn_paged_ref`) for tensors on the
CPU and the CUDA kernels (`decode_attn_cuda`, `decode_attn_paged_cuda`,
one source) for tensors on the card; on the card there is no other path
— a shape or type a kernel does not take raises.
`decode_attention_quantized` is the JAX package's back-compat wrapper
over the dense kernel (`decode_qattn_pallas`)."""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import (CudaKernel, CudaSource,
                                      DeviceScratch, LaunchCount,
                                      decode_splits, sm_count, stream_handle)
from repro_torch.kernels.decode_qattn import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SOURCE = CudaSource(Path(__file__).parent / "csrc" / "decode_attn.cu")
decode_attn_kernel = CudaKernel(SOURCE, "decode_attn_launch",
                                [_P] * 16 + [_I] * 12 + [_F, _P])
decode_attn_paged_kernel = CudaKernel(SOURCE, "decode_attn_paged_launch",
                                      [_P] * 17 + [_I] * 14 + [_F, _P])
# B1w launches through decode_attn_kernel; this counts them on their own
decode_qattn_count = LaunchCount()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS, GQ_MAX = (64, 128), 16
# the split-KV launches' partials scratch and zeroed ticket counters
# (int32, one per (sequence, kv head)), one of each per device; the verify
# kernel keeps its own
_PARTIALS = DeviceScratch("float32")
_TICKETS = DeviceScratch("int32", zeroed=True)


def _launch_scratch(device, B, Hkv, Gq, D, n_keys):
    """(n_split, split_len, partials scratch, tickets) of one launch."""
    n_split, split_len = decode_splits(B, Hkv, n_keys, sm_count(device))
    # per (sequence, kv head, split, query head): acc[D], m, l, 2 pad
    part = _PARTIALS(device, B * Hkv * n_split * Gq * (D + 4))
    return n_split, split_len, part, _TICKETS(device, B * Hkv)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    """`t` itself when its data is 16-byte aligned (the kernel copies rows
    in 16-byte pieces), else an aligned copy."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _check(tensors, device) -> None:
    for t, dt, shape in tensors:
        if (t.device != device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} "
                             f"{t.device}: want contiguous {shape} {dt} "
                             f"on {device}")


def _check_q(q, compute_dtype):
    if q.device.type != "cuda":
        raise ValueError("the decode kernels take CUDA tensors")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported q dtype {q.dtype}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")


def _check_heads(Hq, Hkv, D, S):
    if (Hkv < 1 or Hq % Hkv or Hq // Hkv > GQ_MAX or D not in HEAD_DIMS
            or S < 1):
        raise ValueError(f"shape out of range: Hq={Hq} Hkv={Hkv} D={D} "
                         f"S={S} (Gq <= {GQ_MAX}, D in {HEAD_DIMS})")


def _ring_and_mass(q, rk, rv, bias_ring, B, Hkv, Stot, return_mass):
    """Ring operand checks, the output and the mass scratch."""
    W = rk.shape[1] if rk is not None else 0
    tensors = []
    if W:
        D = q.shape[2]
        tensors = [(rk, q.dtype, (B, W, Hkv, D)), (rv, q.dtype, (B, W, Hkv, D)),
                   (bias_ring, torch.float32, (B, W))]
    scores = mass_h = None
    if return_mass:
        scores = torch.empty((B, Hkv, q.shape[1] // Hkv, Stot + W),
                             dtype=torch.float32, device=q.device)
        mass_h = torch.empty((B, Hkv, Stot + W), dtype=torch.float32,
                             device=q.device)
    return W, tensors, torch.empty_like(q), scores, mass_h


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
    _check_q(q, compute_dtype)
    q = q.contiguous()
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check_heads(Hq, Hkv, D, S)
    quant = bits < 16
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
    W, ring, out, scores, mass_h = _ring_and_mass(q, rk, rv, bias_ring, B,
                                                  Hkv, S, return_mass)
    _check(tensors + ring, q.device)
    k, v = _aligned(k), _aligned(v)
    rk, rv = (_aligned(rk), _aligned(rv)) if W else (None, None)
    n_split, split_len, part, tickets = _launch_scratch(
        q.device, B, Hkv, Hq // Hkv, D, S + W)
    decode_attn_kernel(
        _ptr(q), _ptr(k), _ptr(k_scale if quant else None),
        _ptr(k_zero if quant else None), _ptr(v),
        _ptr(v_scale if quant else None), _ptr(v_zero if quant else None),
        _ptr(bias_main), _ptr(rk), _ptr(rv), _ptr(bias_ring if W else None),
        _ptr(out), _ptr(scores), _ptr(mass_h), _ptr(part), _ptr(tickets), B,
        S, W, Hkv, Hq // Hkv, D, group if quant else 1, bits,
        _DTYPES[q.dtype], int(compute_dtype == torch.bfloat16), n_split,
        split_len, 1.0 / math.sqrt(D), stream_handle(q.device))
    return out, (mass_h.sum(dim=1) if return_mass else None)


def decode_attn_paged_cuda(q, block_tbl, pk, pk_scale, pk_zero, pv,
                           pv_scale, pv_zero, bias_main, rk, rv, bias_ring,
                           *, bits: int, group: int,
                           return_mass: bool = False, compute_dtype=None):
    """Launch the paged CUDA kernel (tensors on the card, contiguous).

    As `decode_attn_cuda`, but the main store is a shared pool walked
    through `block_tbl` [B, n_max] int32 (-1 = unmapped, read as block
    0 and masked by the bias): pk/pv [nb, bl, Hkv, D*bits/8] int8 codes
    or [nb, bl, Hkv, D] in q's dtype, pk_scale/pk_zero [nb, bl/group,
    Hkv, D] f32, pv_scale/pv_zero [nb, bl, Hkv] f32 (bits < 16);
    bias_main [B, n_max*bl] f32. Returns (out [B, Hq, D] in q.dtype,
    mass [B, n_max*bl + W] f32 | None)."""
    _check_q(q, compute_dtype)
    q = q.contiguous()
    B, Hq, D = q.shape
    nb, bl, Hkv = pk.shape[0], pk.shape[1], pk.shape[2]
    n_max = block_tbl.shape[-1]
    S = n_max * bl
    _check_heads(Hq, Hkv, D, S)
    quant = bits < 16
    if quant:
        if bits not in (2, 4, 8) or D % (8 // bits) or bl % group:
            raise ValueError(f"bits={bits} group={group} D={D} block={bl} "
                             "not tileable")
        packed = (nb, bl, Hkv, D * bits // 8)
        kmeta, vmeta = (nb, bl // group, Hkv, D), (nb, bl, Hkv)
        tensors = [(pk, torch.int8, packed), (pv, torch.int8, packed),
                   (pk_scale, torch.float32, kmeta),
                   (pk_zero, torch.float32, kmeta),
                   (pv_scale, torch.float32, vmeta),
                   (pv_zero, torch.float32, vmeta)]
    else:
        if bits != 16:
            raise ValueError(f"bits={bits}")
        tensors = [(pk, q.dtype, (nb, bl, Hkv, D)),
                   (pv, q.dtype, (nb, bl, Hkv, D))]
    tensors += [(block_tbl, torch.int32, (B, n_max)),
                (bias_main, torch.float32, (B, S))]
    W, ring, out, scores, mass_h = _ring_and_mass(q, rk, rv, bias_ring, B,
                                                  Hkv, S, return_mass)
    _check(tensors + ring, q.device)
    pk, pv = _aligned(pk), _aligned(pv)
    rk, rv = (_aligned(rk), _aligned(rv)) if W else (None, None)
    n_split, split_len, part, tickets = _launch_scratch(
        q.device, B, Hkv, Hq // Hkv, D, S + W)
    decode_attn_paged_kernel(
        _ptr(q), _ptr(block_tbl), _ptr(pk),
        _ptr(pk_scale if quant else None), _ptr(pk_zero if quant else None),
        _ptr(pv), _ptr(pv_scale if quant else None),
        _ptr(pv_zero if quant else None), _ptr(bias_main), _ptr(rk),
        _ptr(rv), _ptr(bias_ring if W else None), _ptr(out), _ptr(scores),
        _ptr(mass_h), _ptr(part), _ptr(tickets), B, n_max, bl, nb, W, Hkv,
        Hq // Hkv, D, group if quant else 1, bits, _DTYPES[q.dtype],
        int(compute_dtype == torch.bfloat16), n_split, split_len,
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


def decode_attention_paged(q, block_tbl, pk, pk_scale, pk_zero, pv,
                           pv_scale, pv_zero, bias_main, rk, rv, bias_ring,
                           *, bits: int, group: int,
                           return_mass: bool = False, compute_dtype=None):
    """Decode attention over [paged main store | ring] (shapes as
    `decode_attn_paged_cuda`): the kernel on the card, the plain version
    on the CPU. Returns (out, mass | None)."""
    if q.device.type == "cpu":
        out, mass = ref.decode_attn_paged_ref(
            q, block_tbl, pk, pk_scale, pk_zero, pv, pv_scale, pv_zero,
            bias_main, rk, rv, bias_ring, bits=bits, group=group,
            compute_dtype=compute_dtype or torch.float32)
        return out, (mass if return_mass else None)
    return decode_attn_paged_cuda(
        q, block_tbl, pk, pk_scale, pk_zero, pv, pv_scale, pv_zero,
        bias_main, rk, rv, bias_ring, bits=bits, group=group,
        return_mass=return_mass, compute_dtype=compute_dtype)


def decode_attention_quantized(q, kq, ks, kz, vq, vs, vz, bias, *,
                               bits: int, group: int):
    """Back-compat wrapper over the fused decode kernel (counterpart of
    `repro.kernels.decode_qattn.kernel.decode_qattn_pallas`): a quantized
    main store only (shapes as `decode_attn_cuda`, bits < 16), no ring,
    no mass, f32 compute. Returns out [B, Hq, D] in q.dtype."""
    if bits >= 16:
        raise ValueError(f"decode_attention_quantized: bits={bits} (the "
                         "wrapper takes a quantized store)")
    out, _ = decode_attention_fused(q, kq, ks, kz, vq, vs, vz, bias, None,
                                    None, None, bits=bits, group=group,
                                    return_mass=False,
                                    compute_dtype=torch.float32)
    if q.device.type != "cpu":
        decode_qattn_count.launches += 1
    return out
