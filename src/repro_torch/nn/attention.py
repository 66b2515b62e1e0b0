"""GQA attention (counterpart of `repro.nn.attention`): chunked
full-sequence attention with the per-key attention mass for prefill,
cache-aware single-token decode, and the speculative verify segment.

Decode has two implementations of one contract:

  * the **reference path** (`use_kernels=False`): `materialize_kv`
    dequantizes the whole main store, concatenates the ring, and runs
    plain attention — tests and the on-card comparison only;
  * the **kernel path** (`use_kernels=True`, the default): the fused
    decode kernel reads the packed codes directly (`decode_qattn.ops`;
    its plain version when the tensors lie on the CPU) — from the dense
    store, or from a paged pool through the block table.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.nn import layers as L
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30

# Masses are folded over fixed MASS_GROUP-row groups *sequentially* (left
# to right), the JAX package's association order (float addition is not
# associative; H2O's victims depend on these sums).
MASS_GROUP = 8


def qkv(p: dict, x: torch.Tensor, cfg, positions: Optional[torch.Tensor],
        *, rope: bool = True):
    """x: [B, T, d_model] -> q [B,T,Hq,D], k,v [B,T,Hkv,D] (rotated)."""
    B, T, _ = x.shape
    q = L.linear(p["wq"], x).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = L.linear(p["wk"], x).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = L.linear(p["wv"], x).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if rope:
        if positions is None:
            positions = torch.arange(T, device=x.device)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend_block(q, k, v, mask_bias, scale):
    """q: [B,Tq,Hkv,G,D]; k/v: [B,Tk,Hkv,D]; mask_bias: [B,1,1,Tq,Tk].
    Returns (out, row_mass [B, Tq, Tk]) — per-query-row mass summed over
    heads."""
    s = torch.einsum("btkgd,bskd->bkgts", q, k).float() * scale
    s = s + mask_bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)
    return o, p.sum(dim=(1, 2))


def _fold_mass(carry: torch.Tensor, row_mass: torch.Tensor,
               group: Optional[int]) -> torch.Tensor:
    """Accumulate per-row masses into `carry` [B, Tk]: one reduce over
    rows (group None), or `group`-row partial sums folded into the carry
    strictly left to right."""
    B, Tq, Tk = row_mass.shape
    if group is None:
        return carry + row_mass.sum(dim=1)
    pad = (-Tq) % group
    if pad:
        row_mass = torch.cat([row_mass, row_mass.new_zeros(B, pad, Tk)], 1)
    g_mass = row_mass.reshape(B, -1, group, Tk).sum(dim=2)   # [B, nG, Tk]
    for i in range(g_mass.shape[1]):
        carry = carry + g_mass[:, i]
    return carry


def gqa_attention(q, k, v, *, causal: bool, window: int = 0,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  kv_bias: Optional[torch.Tensor] = None, q_chunk: int = 512,
                  return_mass: bool = False, mass_group: Optional[int] = None,
                  mass_init: Optional[torch.Tensor] = None):
    """q: [B, Tq, Hq, D]; k, v: [B, Tk, Hkv, D]; kv_bias: [B, Tk].
    Chunked over Tq (scores never exceed [.., q_chunk, Tk]). Returns out
    [B, Tq, Hq, D] (+ attention mass [B, Tk] if requested).

    `mass_init` seeds the mass fold: chunked prefill passes the running
    mass, so a prompt split across calls accumulates the association
    chain of one monolithic call."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Tq, Hkv, G, D)
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)[None].expand(B, Tq)
    if kv_positions is None:
        kv_positions = torch.arange(Tk, device=dev)[None].expand(B, Tk)

    def bias_for(qpos):                                   # [B, 1, 1, tq, Tk]
        kp = kv_positions[:, None, None, None, :]
        qp = qpos[:, None, None, :, None]
        ok = torch.ones((B, 1, 1, qpos.shape[1], Tk), dtype=torch.bool,
                        device=dev)
        if causal:
            ok = ok & (kp <= qp)
        if window > 0:
            ok = ok & (kp > qp - window)
        b = torch.where(ok, 0.0, NEG_INF).float()
        if kv_bias is not None:
            b = b + kv_bias[:, None, None, None, :]
        return b

    mass = (mass_init if mass_init is not None
            else torch.zeros((B, Tk), dtype=torch.float32, device=dev))
    outs = []
    if Tq > q_chunk and Tq % q_chunk and return_mass:
        raise ValueError("return_mass requires Tq % q_chunk == 0")
    for c0 in range(0, Tq, q_chunk):
        c1 = min(c0 + q_chunk, Tq)
        o, row_mass = _attend_block(qg[:, c0:c1], k, v,
                                    bias_for(q_positions[:, c0:c1]), scale)
        outs.append(o)
        if return_mass:
            mass = _fold_mass(mass, row_mass, mass_group)
    out = torch.cat(outs, dim=1).reshape(B, Tq, Hq, D)
    return (out, mass) if return_mass else out


def _kernel_supported(lc, spec: CacheSpec) -> bool:
    S = lc.scores.shape[1]
    if spec.quantized:
        return S % spec.group == 0 and spec.bits in (2, 4, 8)
    return True


def decode_attention(q: torch.Tensor, lc, spec: CacheSpec, *,
                     window: int = 0, dtype=torch.bfloat16,
                     q_pos: Optional[torch.Tensor] = None,
                     use_kernels: bool = True):
    """q: [B, 1, Hq, D] rotated at absolute position `q_pos` [B]
    (default lc.pos - 1: append-first, the token attends to itself).
    `lc` is a dense `LayerKV` or a `paging.PagedLayerKV`.

    Returns (out [B, 1, Hq, D], attn_mass [B, S+W]) with the mass aligned
    to `materialize_kv` ordering; the kernel computes the mass only when
    the policy reads it (zeros otherwise)."""
    if q_pos is None:
        q_pos = lc.pos - 1
    B = q.shape[0]
    S, W = lc.scores.shape[1], lc.rk.shape[1]
    bias = kvcache.validity_bias(lc)
    if window > 0 or not use_kernels:
        ring_pos = (lc.pos[:, None] - lc.rlen[:, None]
                    + torch.arange(W, device=q.device)[None])
        kv_positions = (torch.cat([lc.slot_pos, ring_pos.to(torch.int32)], 1)
                        if W else lc.slot_pos)
    if window > 0:  # sliding-window models: mask stale slots
        bias = bias + torch.where(kv_positions > (q_pos[:, None] - window),
                                  0.0, NEG_INF)

    if use_kernels:
        if not _kernel_supported(lc, spec):
            raise ValueError(f"decode kernel cannot tile S={S} with "
                             f"group={spec.group} bits={spec.bits}")
        quant = spec.quantized
        ring = ((lc.rk, lc.rv, bias[:, S:].contiguous()) if W
                else (None, None, None))
        kw = dict(bits=spec.bits if quant else 16, group=spec.group,
                  return_mass=spec.track_scores(), compute_dtype=dtype)
        if isinstance(lc, LayerKV):
            out, mass = dq_ops.decode_attention_fused(
                q[:, 0].contiguous(),
                lc.k, lc.k_scale if quant else None,
                lc.k_zero if quant else None,
                lc.v, lc.v_scale if quant else None,
                lc.v_zero if quant else None,
                bias[:, :S].contiguous(), *ring, **kw)
        else:
            # block-table walk over the shared pool: never gathered
            out, mass = dq_ops.decode_attention_paged(
                q[:, 0].contiguous(), lc.block_tbl,
                lc.pk, lc.pk_scale if quant else None,
                lc.pk_zero if quant else None,
                lc.pv, lc.pv_scale if quant else None,
                lc.pv_zero if quant else None,
                bias[:, :S].contiguous(), *ring, **kw)
        if mass is None:
            mass = torch.zeros((B, S + W), dtype=torch.float32,
                               device=q.device)
        return out[:, None].to(dtype), mass

    k, v = kvcache.materialize_kv(lc, spec, dtype)
    return gqa_attention(q, k, v, causal=False, kv_positions=kv_positions,
                         kv_bias=bias, q_positions=q_pos[:, None],
                         return_mass=True)


# ---------------------------------------------------------------------------
# Speculative verify: a rectangular segment of queries over the cache
# ---------------------------------------------------------------------------
#
# The verify step appends the whole speculated segment (last committed
# token + drafts) with `cache.append_segment`, then every segment row
# attends the cache in one pass. The speculative loop's depth cap keeps
# the drafts' appends free of evictions and flushes, so the cache each row
# sees equals what sequential decode would see at that sub-step plus the
# later drafts' rows, which the causal test on absolute positions masks
# to an exact 0.0: each row reproduces the decode step it replaces.


def verify_attention(q: torch.Tensor, lc, spec: CacheSpec, *,
                     q_pos: torch.Tensor, window: int = 0,
                     dtype=torch.bfloat16, use_kernels: bool = True):
    """q: [B, L, Hq, D] rotated at absolute positions q_pos [B, L]; the
    segment's K/V are already appended (rows past a slot's ragged length
    carry positions the causal test masks). `lc` is a dense `LayerKV` or
    a `paging.PagedLayerKV`.

    Returns (out [B, L, Hq, D], row_mass [B, L, S+W]): the per-row mass,
    aligned with `materialize_kv` ordering and not summed over rows (the
    caller accumulates only the accepted rows'). The kernel route (policies
    that read no mass) reports zeros."""
    B, L, Hq, D = q.shape
    S, W = lc.scores.shape[1], lc.rk.shape[1]
    dev = q.device
    ring_pos = (lc.pos[:, None] - lc.rlen[:, None]
                + torch.arange(W, device=dev)[None]).to(torch.int32)
    # Causal-test positions. Main-store rows carry their true position in
    # `slot_pos`. A quantized ring is the live tail (it holds the
    # segment's own drafts): its `pos - rlen + arange` labels are true
    # positions. A dense ring is frozen at prefill and decode reads all
    # of it: an impossible-low label keeps every ring row visible.
    ring_causal = (ring_pos if spec.quantized
                   else torch.full((B, W), -(2 ** 30), dtype=torch.int32,
                                   device=dev))
    causal_pos = (torch.cat([lc.slot_pos, ring_causal], 1) if W
                  else lc.slot_pos)
    bias = kvcache.validity_bias(lc)                         # [B, S+W]
    k, v = kvcache.materialize_kv(lc, spec, dtype)
    if use_kernels and not spec.track_scores() and (window == 0
                                                    or spec.quantized):
        # the flash rule: policies that never read the mass take the
        # verify kernel over the materialized view (a sliding window over
        # a dense frozen ring needs two position sets: reference route)
        out = fp_ops.flash_verify(q.contiguous(), k, v,
                                  causal_pos.contiguous(), bias,
                                  q_pos.to(torch.int32), window=window)
        return out.to(dtype), torch.zeros((B, L, S + W), dtype=torch.float32,
                                          device=dev)
    # per-row additive bias: validity + causal by absolute position (+ the
    # sliding window on decode's ring labels). A visible key adds an exact
    # 0.0, so each row's bias is bit-equal to `decode_attention`'s.
    ok = causal_pos[:, None, :] <= q_pos[:, :, None]         # [B, L, S+W]
    if window > 0:
        win_pos = (torch.cat([lc.slot_pos, ring_pos], 1) if W
                   else lc.slot_pos)
        ok = ok & (win_pos[:, None, :] > (q_pos[:, :, None] - window))
    full_bias = bias[:, None, :] + torch.where(ok, 0.0, NEG_INF)
    Hkv = k.shape[2]
    out, row_mass = _attend_block(q.reshape(B, L, Hkv, Hq // Hkv, D), k, v,
                                  full_bias[:, None, None],
                                  1.0 / math.sqrt(D))
    return out.reshape(B, L, Hq, D), row_mass
