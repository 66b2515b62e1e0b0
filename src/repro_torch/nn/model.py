"""The LM: init_params / prefill / decode_step / init_cache (counterpart of
`repro.nn.model` for attention-only dense decoders).

Parameters keep the JAX package's tree: ``blocks/sub0/...`` leaves carry
a leading ``[n_sb]`` layer dim (one layer per superblock: n_sb is the
number of layers for these attention-only decoders), linear weights
are ``[d_in, d_out]``. The cache is a `ModelCache` whose `LayerKV` leaves
carry leading ``[n_sb, nA]`` dims (nA = 1), also the JAX layout. A Python
loop over layers takes the place of `lax.scan`; decode updates the cache
in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.nn import blocks as B
from repro_torch.nn import layers as L


class ModelCache(NamedTuple):
    attn: LayerKV    # leaves [n_sb, nA, B, ...]


def _block_shapes(cfg) -> dict:
    d, D = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads * D, cfg.num_kv_heads * D

    def lin(d_in, d_out, bias):
        p = {"w": ((d_in, d_out), d_in)}
        if bias:
            p["b"] = ((d_out,), 0)
        return p

    return {
        "norm1": {"scale": ((d,), -1)},
        "attn": {"wq": lin(d, hq, cfg.qkv_bias), "wk": lin(d, hkv, cfg.qkv_bias),
                 "wv": lin(d, hkv, cfg.qkv_bias),
                 "wo": lin(hq, d, cfg.attn_out_bias)},
        "norm2": {"scale": ((d,), -1)},
        "mlp": {"gate": lin(d, cfg.d_ff, cfg.mlp_bias),
                "up": lin(d, cfg.d_ff, cfg.mlp_bias),
                "down": lin(cfg.d_ff, d, cfg.mlp_bias)},
    }


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random parameters drawn on `device` (None: the card, raising
    without one) from a `torch.Generator`:
    normal(0, 1/fan_in) weights (drawn in f32, cast to cfg.dtype), unit
    norms, zero biases — the JAX package's init scheme, not its numbers.
    Layers are drawn one at a time, so the f32 draw never holds more than
    one layer's largest leaf."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n_sb = cfg.num_layers

    def make(spec, lead=()):
        shape, fan_in = spec
        out = torch.empty(*lead, *shape, dtype=cfg.dtype, device=device)
        if fan_in < 0:
            out.fill_(1)
        elif fan_in == 0:
            out.zero_()
        else:
            for idx in ([()] if not lead else [(i,) for i in range(lead[0])]):
                w = torch.randn(shape, generator=g, dtype=torch.float32,
                                device=device)
                out[idx] = w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)
        return out

    def tree(shapes, lead=()):
        return {k: (tree(v, lead) if isinstance(v, dict) else make(v, lead))
                for k, v in shapes.items()}

    params = {
        "embed": {"table": make(((cfg.vocab_size, cfg.d_model), cfg.d_model))},
        "final_norm": {"scale": make(((cfg.d_model,), -1))},
        "blocks": {"sub0": tree(_block_shapes(cfg), (n_sb,))},
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": make(((cfg.d_model, cfg.vocab_size),
                                     cfg.d_model))}
    return params


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.linear(params["head"], x).float()


def prefill(params, cfg, batch: dict, spec: CacheSpec, *,
            layer_budgets: Optional[Sequence[int]] = None):
    """batch: {"tokens": [B, T] int}. Returns (last-token logits [B, V]
    f32, ModelCache of the compressed prompt)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    T = tokens.shape[1]
    if layer_budgets is None:
        layer_budgets = [spec.main_store_len(T)] * cfg.num_layers
    pieces = []
    for i in range(cfg.num_layers):
        x, lc = B.block_prefill(_layer(params["blocks"]["sub0"], i), x, cfg,
                                spec, logical_budget=int(layer_budgets[i]))
        pieces.append(lc)
    attn_c = LayerKV(*(torch.stack(leaves)[:, None]
                       for leaves in zip(*pieces)))
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, ModelCache(attn_c)


def decode_step(params, cfg, cache: ModelCache, token: torch.Tensor,
                spec: CacheSpec, *, ring_full: Optional[bool] = None):
    """token: [B, 1] int. Appends one token to every layer's cache (in
    place) and returns (logits [B, V] f32, the same ModelCache).

    ring_full: host-side knowledge of whether any row's quantized ring is
    full this step (see `cache.append_token_quantized`); None asks the
    device once per layer."""
    x = L.embed(params["embed"], token)
    for i in range(cfg.num_layers):
        x = B.block_decode(_layer(params["blocks"]["sub0"], i), x, cfg, spec,
                           kvcache.layer_view(cache.attn, i, 0),
                           ring_full=ring_full)
    return _logits(params, cfg, x)[:, 0], cache


def init_cache(cfg, spec: CacheSpec, batch: int, max_len: int, *,
               layer_budgets: Optional[Sequence[int]] = None,
               device=None) -> ModelCache:
    n_sb = cfg.num_layers
    attn_c = kvcache.init_layer_kv(spec, batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.dtype, device=device,
                                   lead=(n_sb, 1))
    if layer_budgets is not None:
        attn_c.budget.copy_(torch.as_tensor(
            [int(b) for b in layer_budgets], dtype=torch.int32).view(n_sb, 1))
    return ModelCache(attn_c)
