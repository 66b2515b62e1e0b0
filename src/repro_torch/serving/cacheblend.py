"""CacheBlend (survey [12]): fused KV reuse for multi-chunk prompts with
selective recomputation (counterpart of `repro.serving.cacheblend`).

A prompt is a concatenation of chunks whose KV caches were computed
independently (chunk-local attention, global positions). Reusing them as
they are loses cross-chunk attention; a full prefill wastes the reuse.
CacheBlend recomputes the KV of only the top `recompute_frac` tokens —
those whose chunk-local KV deviates most from the true KV (HKVD tokens,
chosen at layer 1, where the first cross-token divergence appears) — and
keeps the cached KV of the rest.

The JAX package computes this with plain attention outside any Pallas
kernel, and so does the port: matmul attention in the model dtype with
an f32 softmax. Attention-only dense decoders (every layer the same).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.nn import attention as attn
from repro_torch.nn import blocks as BL
from repro_torch.nn import layers as L
from repro_torch.nn import model as M

NEG_INF = -1e30


def _layer(params, i: int) -> dict:
    return M._layer(params["blocks"]["sub0"], i)


def _attend(cfg, q, k, v, bias):
    """q [B, Tq, Hq, D] against k / v [B, S, Hkv, D] under the additive
    bias [B or 1, Tq, S]; returns [B, Tq, Hq*D]."""
    B, Tq = q.shape[:2]
    Hkv = cfg.num_kv_heads
    qg = q.reshape(B, Tq, Hkv, cfg.num_heads // Hkv, cfg.head_dim)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k) / math.sqrt(cfg.head_dim)
    pr = torch.softmax(s.float() + bias[:, None, None], dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", pr.to(v.dtype), v)
    return o.reshape(B, Tq, cfg.num_heads * cfg.head_dim)


def chunked_kv(params, cfg, tokens: torch.Tensor, bounds: Sequence[int]):
    """Per-chunk independent KV (global RoPE positions, chunk-local causal
    attention). tokens: [B, S]; bounds: chunk start offsets (0
    included). Returns per-layer K, V [L, B, S, Hkv, D]."""
    M._check_chunkable(cfg)
    B, S = tokens.shape
    dev = tokens.device
    x = L.embed(params["embed"], tokens)
    edges = list(bounds) + [S]
    chunk_id = torch.zeros(S, dtype=torch.int32, device=dev)
    for c, lo in enumerate(edges[:-1]):
        chunk_id[lo:edges[c + 1]] = c
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    bias = torch.where(causal & (chunk_id[None] == chunk_id[:, None]), 0.0,
                       NEG_INF)[None]
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        q, k, v = attn.qkv(p["attn"], h, cfg, positions)
        x = x + L.linear(p["attn"]["wo"], _attend(cfg, q, k, v, bias))
        x = BL._ffn(p, x, cfg)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _true_layer1_kv(params, cfg, tokens: torch.Tensor):
    """Exact K / V of layer 1 (one full causal layer-0 pass)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    p0 = _layer(params, 0)
    h = L.rmsnorm(p0["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p0["attn"], h, cfg, positions)
    o = attn.gqa_attention(q, k, v, causal=True, window=cfg.sliding_window,
                           q_positions=positions, kv_positions=positions)
    x = x + L.linear(p0["attn"]["wo"], o.reshape(B, S, -1))
    x = BL._ffn(p0, x, cfg)
    p1 = _layer(params, min(1, cfg.num_layers - 1))
    h = L.rmsnorm(p1["norm1"], x, cfg.norm_eps)
    _, k1, v1 = attn.qkv(p1["attn"], h, cfg, positions)
    return k1, v1


def select_hkvd(params, cfg, tokens: torch.Tensor, cached_k1: torch.Tensor,
                cached_v1: torch.Tensor, n_recompute: int) -> torch.Tensor:
    """Top-n tokens by layer-1 KV deviation, the last token always in (it
    is the generation query). Ties go to the lower index, as
    `jax.lax.top_k` breaks them. Returns sorted indices [B, n]."""
    k1, v1 = _true_layer1_kv(params, cfg, tokens)
    dev = ((k1 - cached_k1).float().square().sum(dim=(-1, -2))
           + (v1 - cached_v1).float().square().sum(dim=(-1, -2)))  # [B, S]
    dev[:, -1] = float("inf")
    idx = torch.sort(dev, dim=-1, descending=True,
                     stable=True).indices[:, :n_recompute]
    return torch.sort(idx, dim=-1).values


def blend_prefill(params, cfg, tokens: torch.Tensor, bounds: Sequence[int],
                  recompute_frac: float = 0.15):
    """Returns (last-token logits [B, V] f32, blended per-layer (K, V)
    [L, B, S, Hkv, D], the recomputed indices [B, n])."""
    B, S = tokens.shape
    n_re = max(int(S * recompute_frac), 1)
    ks, vs = chunked_kv(params, cfg, tokens, bounds)
    l1 = min(1, cfg.num_layers - 1)
    sel = select_hkvd(params, cfg, tokens, ks[l1], vs[l1], n_re)   # [B, n]
    rows = torch.arange(B, device=tokens.device)[:, None]
    x_sel = L.embed(params["embed"], tokens)[rows, sel]             # [B,n,d]
    all_pos = torch.arange(S, device=tokens.device)
    bias = torch.where(all_pos[None, None] <= sel[..., None], 0.0,
                       NEG_INF)                                     # [B,n,S]
    new_ks, new_vs = [], []
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        h = L.rmsnorm(p["norm1"], x_sel, cfg.norm_eps)
        q, k_new, v_new = attn.qkv(p["attn"], h, cfg, sel)
        k_l, v_l = ks[i].clone(), vs[i].clone()
        k_l[rows, sel] = k_new.to(k_l.dtype)                       # blended
        v_l[rows, sel] = v_new.to(v_l.dtype)
        x_sel = x_sel + L.linear(p["attn"]["wo"],
                                 _attend(cfg, q, k_l, v_l, bias))
        x_sel = BL._ffn(p, x_sel, cfg)
        new_ks.append(k_l)
        new_vs.append(v_l)
    logits = M._logits(params, cfg, x_sel[:, -1:])[:, 0]
    return logits, (torch.stack(new_ks), torch.stack(new_vs)), sel
