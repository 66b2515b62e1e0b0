"""Plain version of the fused decode kernel: dequantize, concatenate the
residual ring, attend (counterpart of `repro.kernels.decode_qattn.ref`).
The CPU path and the tests run it; on the card nothing on the main path
calls it."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.kvquant import ref as qref


def decode_qattn_ref(q, kq, ks, kz, vq, vs, vz, bias, *, bits: int,
                     group: int) -> torch.Tensor:
    """Same signature as `ops.decode_attention_quantized`. q: [B, Hq, D];
    kq/vq: [B, S, Hkv, Dp] packed; returns [B, Hq, D]."""
    out, _ = decode_attn_ref(q, kq, ks, kz, vq, vs, vz, bias, None, None,
                             None, bits=bits, group=group)
    return out


def decode_attn_ref(q, k, k_scale, k_zero, v, v_scale, v_zero, bias_main,
                    rk, rv, bias_ring, *, bits: int, group: int,
                    compute_dtype=torch.float32):
    """Same contract as `ops.decode_attn_cuda`; returns (out [B, Hq, D]
    in q.dtype, mass [B, S+W] f32)."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    Gq = Hq // Hkv
    if bits < 16:
        kd = qref.dequant_k_ref(k, k_scale, k_zero, bits, group,
                                compute_dtype).float()
        vd = qref.dequant_v_ref(v, v_scale, v_zero, bits,
                                compute_dtype).float()
    else:
        kd, vd = k.float(), v.float()
    bias = bias_main
    if rk is not None and rk.shape[1] > 0:
        kd = torch.cat([kd, rk.float()], dim=1)
        vd = torch.cat([vd, rv.float()], dim=1)
        bias = torch.cat([bias_main, bias_ring], dim=1)
    qf = q.float().reshape(B, Hkv, Gq, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, kd) / math.sqrt(D)
    s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vd)
    mass = p.sum(dim=(1, 2))                     # [B, S+W]
    return o.reshape(B, Hq, D).to(q.dtype), mass


def gather_pool(pool, block_tbl):
    """[nb, r, ...] pool rows in `block_tbl` [B, n_max] order ->
    [B, n_max*r, ...]; -1 entries read block 0 (out-of-range ids clamp,
    as a JAX gather does)."""
    B, n_max = block_tbl.shape
    tbl = block_tbl.clamp(0, pool.shape[0] - 1).long()
    return pool[tbl].reshape(B, n_max * pool.shape[1], *pool.shape[2:])


def decode_attn_paged_ref(q, block_tbl, pk, pk_scale, pk_zero, pv, pv_scale,
                          pv_zero, bias_main, rk, rv, bias_ring, *,
                          bits: int, group: int, compute_dtype=torch.float32):
    """Same contract as `ops.decode_attn_paged_cuda`: gather each slot's
    blocks (-1 clamped to block 0, masked by the bias), then
    `decode_attn_ref` — the JAX tests' own oracle for the paged kernel."""
    def g(pool):
        return None if pool is None else gather_pool(pool, block_tbl)

    return decode_attn_ref(q, g(pk), g(pk_scale), g(pk_zero), g(pv),
                           g(pv_scale), g(pv_zero), bias_main, rk, rv,
                           bias_ring, bits=bits, group=group,
                           compute_dtype=compute_dtype)
