"""Decoder blocks: attention mixer + dense SwiGLU FFN, pre-norm residual
(counterpart of `repro.nn.blocks` for `attn` mixers with a dense FFN)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L


def _ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x, cfg.norm_eps))


def block_prefill(p: dict, x: torch.Tensor, cfg, spec: CacheSpec, *,
                  logical_budget: Optional[int] = None):
    """x: [B, T, d_model], positions 0..T-1. Returns (x, LayerKV)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["attn"], h, cfg, None)
    if cfg.use_kernels and not spec.track_scores():
        # policies that never read the mass statistic take the flash
        # kernel; their prompt selection uses recency, so zero mass is
        # exact for them
        o = fp_ops.flash_attention(q, k, v, window=cfg.sliding_window)
        mass = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    else:
        o, mass = attn.gqa_attention(
            q, k, v, causal=True, window=cfg.sliding_window,
            return_mass=True, mass_group=attn.MASS_GROUP)
    B, T, _ = x.shape
    x = x + L.linear(p["attn"]["wo"], o.reshape(B, T, -1))
    lc = kvcache.compress_prompt(spec, k, v, mass, dtype=cfg.dtype,
                                 logical_budget=logical_budget)
    return _ffn(p, x, cfg), lc


def block_decode(p: dict, x: torch.Tensor, cfg, spec: CacheSpec,
                 lc: LayerKV, *, ring_full: Optional[bool] = None):
    """x: [B, 1, d_model]. Appends this token's K/V to `lc` (in place),
    attends over the cache, accumulates the mass. Returns x."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    pos = lc.pos[:, None].clone()   # [B, 1]; the append advances lc.pos
    q, k_new, v_new = attn.qkv(p["attn"], h, cfg, pos)
    # append-first: the new token attends to itself through the cache
    kvcache.append_token(lc, spec, k_new[:, 0], v_new[:, 0],
                         ring_full=ring_full)
    o, mass = attn.decode_attention(
        q, lc, spec, window=cfg.sliding_window, dtype=cfg.dtype,
        q_pos=pos[:, 0], use_kernels=cfg.use_kernels)
    kvcache.accumulate_scores(lc, spec, mass)
    B = x.shape[0]
    x = x + L.linear(p["attn"]["wo"], o.reshape(B, 1, -1))
    return _ffn(p, x, cfg)
