"""Plain version of the flash prefill kernel: materialized causal
attention in f32 (counterpart of `repro.kernels.flash_prefill.ref`)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_prefill_ref(q, k, v, *, window: int = 0):
    """q: [B, T, Hq, D]; k, v: [B, T, Hkv, D] -> [B, T, Hq, D] q.dtype."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    Gq = Hq // Hkv
    qf = q.float().reshape(B, T, Hkv, Gq, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window > 0:
        ok = ok & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(B, T, Hq, D).to(q.dtype)
