"""Selective-compression extras beyond the in-cache policies (counterpart
of `repro.core.eviction`; `core.cache` implements streaming / H2O / NACL /
Keyformer victim selection natively; this module adds the merge-based
variants).

* EMS [11] / CacheBlend-style **evict-then-merge**: evicted tokens are not
  discarded but merged into compensation slots (attention-mass weighted).
* RazorAttention [13]: retrieval heads keep the full cache; non-retrieval
  heads keep sinks+window plus one **compensation token** absorbing what
  was dropped.
* LOOK-M (survey [30]): modality-aware eviction scores for early-fusion
  VLMs.
"""
from __future__ import annotations

import torch


def merge_evicted(k: torch.Tensor, v: torch.Tensor, keep_mask: torch.Tensor,
                  weights: torch.Tensor):
    """Compute one compensation token per head from the evicted set.

    k, v: [B, S, H, D]; keep_mask: [B, S] bool; weights: [B, S]
    (attention mass). Returns (k_comp, v_comp): [B, H, D] — the
    weight-averaged evicted KV (RazorAttention's compensation token /
    EMS merge step)."""
    w = torch.where(keep_mask, 0.0, weights.float())             # evicted only
    denom = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)    # [B, 1]
    wn = (w / denom)[..., None, None]                            # [B, S, 1, 1]
    k_comp = (k.float() * wn).sum(dim=1)
    v_comp = (v.float() * wn).sum(dim=1)
    return k_comp.to(k.dtype), v_comp.to(v.dtype)


def retrieval_head_scores(attn_mass_per_head: torch.Tensor,
                          positions: torch.Tensor,
                          window: int) -> torch.Tensor:
    """RazorAttention's retrieval-head detector (proxy): heads that put
    significant attention mass *outside* the local window are retrieval
    heads. attn_mass_per_head: [B, H, S]; positions: [B, S] absolute;
    returns [H] long-range mass fraction."""
    cur = positions.amax(dim=1, keepdim=True)                    # [B, 1]
    far = (positions < cur - window)[:, None, :]                 # [B, 1, S]
    m = attn_mass_per_head.float()
    frac = (m * far).sum(-1) / torch.clamp(m.sum(-1), min=1e-9)  # [B, H]
    return frac.mean(0)


def razor_head_budgets(retrieval_frac: torch.Tensor, full_budget: int,
                       small_budget: int, thresh: float = 0.1
                       ) -> torch.Tensor:
    """[H] per-head budgets: retrieval heads keep `full_budget`, echo
    heads keep `small_budget` (+ compensation token handled by caller)."""
    return torch.where(retrieval_frac > thresh, full_budget, small_budget)


def lookm_scores(attn_mass: torch.Tensor, is_image: torch.Tensor,
                 text_boost: float = 4.0) -> torch.Tensor:
    """attn_mass: [B, S]; is_image: [B, S] bool (VQ-token positions).
    Returns modality-weighted eviction scores: text tokens' attention
    mass is boosted so image tokens fall below them at equal mass
    (LOOK-M's text-prior merge order)."""
    m = attn_mass.float()
    return torch.where(is_image, m, m * text_boost)


def vq_token_mask(tokens: torch.Tensor, vq_lo: int, vq_hi: int) -> torch.Tensor:
    """Early-fusion VLMs put image VQ codes in a reserved id range."""
    return (tokens >= vq_lo) & (tokens < vq_hi)
