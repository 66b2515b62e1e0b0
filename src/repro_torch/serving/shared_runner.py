"""KVSharer serving path (survey [10]): layer-wise KV cache sharing
(counterpart of `repro.serving.shared_runner`).

Sharing crosses layer boundaries, so this runner unrolls the layer loop
in Python. A shared layer attends with its own queries over its
*source* layer's cache and neither computes nor stores its own K/V,
saving cache memory (and the K/V use) for `len(mapping)/L` of the
layers. Every other layer runs the model's own blocks: `block_prefill`
(the flash-prefill kernel for policies that read no mass) and
`block_decode` (the fused decode kernel), which update that layer's
cache in place. A shared layer's prefill attention is the plain
`gqa_attention` over the source's materialized cache, as in the JAX
runner; its decode attention is `decode_attention`, the decode kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core import sharing as sharing_lib
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.nn import attention as attn
from repro_torch.nn import blocks as B
from repro_torch.nn import layers as L
from repro_torch.nn import model as M


def _layer_params(params, i: int) -> dict:
    return M._layer(params["blocks"]["sub0"], i)


def calibrate_sharing(params, cfg, tokens: torch.Tensor,
                      n_share: int) -> dict[int, int]:
    """Run a short calibration prefill collecting per-layer K/V summaries,
    then build the KVSharer dissimilarity map."""
    spec = CacheSpec(budget=tokens.shape[1] + 1)
    _, cache = M.prefill(params, cfg, {"tokens": tokens}, spec)
    ks = cache.attn.k[:, 0]           # [L, B, S, H, D] (nA=1 squeezed)
    vs = cache.attn.v[:, 0]
    summaries = sharing_lib.calibration_summaries(ks, vs)
    return sharing_lib.build_sharing_map(summaries, n_share)


def shared_prefill(params, cfg, batch: dict, spec: CacheSpec,
                   mapping: dict[int, int]):
    """Unrolled prefill; shared layers get no cache entry (None).
    Returns (last-token logits [B, V] f32, per-layer caches)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    Bsz, T = tokens.shape
    positions = torch.arange(T, device=x.device)[None].expand(Bsz, T)
    caches: list[Optional[LayerKV]] = []
    for i in range(cfg.num_layers):
        p = _layer_params(params, i)
        if i in mapping:
            # attend with this layer's queries over the source layer's
            # prompt K/V (at prefill both hold the full prompt)
            src = caches[mapping[i]]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            q, _, _ = attn.qkv(p["attn"], h, cfg, positions)
            k, v, bias = kvcache.materialize(src, spec, cfg.dtype)
            o = attn.gqa_attention(q, k, v, causal=True,
                                   q_positions=positions,
                                   kv_positions=src.slot_pos, kv_bias=bias)
            x = x + L.linear(p["attn"]["wo"], o.reshape(Bsz, T, -1))
            x = B._ffn(p, x, cfg)
            caches.append(None)
        else:
            x, piece = B.block_prefill(p, x, cfg, spec)
            caches.append(piece)
    return _final_logits(params, cfg, x[:, -1:]), caches


def shared_decode_step(params, cfg, caches, token: torch.Tensor,
                       spec: CacheSpec, mapping: dict[int, int]):
    """token: [B, 1] int. Appends to every unshared layer's cache (in
    place) and returns (logits [B, V] f32, the caches as a new list)."""
    x = L.embed(params["embed"], token)
    Bsz = token.shape[0]
    new_caches = list(caches)
    for i in range(cfg.num_layers):
        p = _layer_params(params, i)
        if i in mapping:
            src = new_caches[mapping[i]]   # source already appended this step
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            pos = (src.pos - 1)[:, None]
            q, _, _ = attn.qkv(p["attn"], h, cfg, pos)
            o, _ = attn.decode_attention(q, src, spec, dtype=cfg.dtype,
                                         q_pos=pos[:, 0],
                                         use_kernels=cfg.use_kernels)
            x = x + L.linear(p["attn"]["wo"], o.reshape(Bsz, 1, -1))
            x = B._ffn(p, x, cfg)
        else:
            x = B.block_decode(p, x, cfg, spec, new_caches[i])
    return _final_logits(params, cfg, x), new_caches


def _final_logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    return M._logits(params, cfg, x)[:, 0]


def cache_bytes_saved(mapping: dict[int, int], n_layers: int) -> float:
    return 1.0 - sharing_lib.shared_bytes_fraction(mapping, n_layers)
