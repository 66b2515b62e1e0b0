"""Plain version of the flash prefill kernels: materialized causal
attention in f32 (counterpart of `repro.kernels.flash_prefill.ref`)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_prefill_chunk_ref(q, k, v, *, q_offset: int, window: int = 0):
    """q: [B, Tq, Hq, D], one prompt segment at absolute rows q_offset ..
    q_offset+Tq-1; k, v: [B, Tk, Hkv, D], the prompt scratch. A key is
    visible iff kpos <= q_offset + t (and inside the window) ->
    [B, Tq, Hq, D] in q.dtype."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    Gq = Hq // Hkv
    qf = q.float().reshape(B, Tq, Hkv, Gq, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tk, device=q.device)
    ok = kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(B, Tq, Hq, D).to(q.dtype)


def flash_prefill_ref(q, k, v, *, window: int = 0):
    """q: [B, T, Hq, D]; k, v: [B, T, Hkv, D] -> [B, T, Hq, D] q.dtype:
    the whole prompt as one segment at offset 0."""
    return flash_prefill_chunk_ref(q, k, v, q_offset=0, window=window)
