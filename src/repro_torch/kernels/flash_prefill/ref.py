"""Plain version of the flash prefill and speculative-verify kernels:
materialized causal attention in f32 (counterpart of
`repro.kernels.flash_prefill.ref`)."""
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


def flash_verify_ref(q, k, v, kv_pos, bias, q_pos, *, window: int = 0):
    """q: [B, L, Hq, D], one speculated segment per row at absolute
    positions q_pos [B, L]; k, v: [B, Tk, Hkv, D], the materialized cache
    view, its rows at absolute positions kv_pos [B, Tk] with the additive
    validity bias [B, Tk] f32. Key s is visible to query t iff
    kv_pos[s] <= q_pos[t] (and kv_pos[s] > q_pos[t] - window); a row
    with no visible key softmaxes uniformly over all Tk keys (finite
    -1e30 mask) -> [B, L, Hq, D] in q.dtype."""
    B, L, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, L, Hkv, Hq // Hkv, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) / math.sqrt(D)
    s = s + bias.float()[:, None, None, None, :]
    ok = kv_pos[:, None, :] <= q_pos[:, :, None]            # [B, L, Tk]
    if window > 0:
        ok = ok & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    s = s.masked_fill(~ok[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(B, L, Hq, D).to(q.dtype)
