"""Decoder blocks: attention mixer + (dense SwiGLU | MoE) FFN, pre-norm
residual (counterpart of `repro.nn.blocks` for `attn` mixers):
monolithic prefill, one chunked-prefill segment, speculative verify, and
decode. `generator` (a `torch.Generator` on the block's device, or None)
feeds the NACL / Keyformer noise where the JAX blocks take `key`."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib


def _ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The FFN residual. An MoE FFN routes the call's tokens together
    (capacity is per call); serving discards its `MoEAux`, as the JAX
    engine does."""
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, _ = moe_lib.moe_apply(p["moe"], h,
                                 top_k=cfg.moe.num_experts_per_tok,
                                 capacity_factor=cfg.moe.capacity_factor)
        return x + y
    return x + L.mlp(p["mlp"], h)


def block_prefill(p: dict, x: torch.Tensor, cfg, spec: CacheSpec, *,
                  logical_budget: Optional[int] = None,
                  generator: Optional[torch.Generator] = None):
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
                                 logical_budget=logical_budget,
                                 use_kernels=cfg.use_kernels,
                                 generator=generator)
    return _ffn(p, x, cfg), lc


def block_prefill_chunk(p: dict, x: torch.Tensor, cfg, spec: CacheSpec,
                        k_scr: torch.Tensor, v_scr: torch.Tensor,
                        mass_scr: torch.Tensor, c0: int) -> torch.Tensor:
    """One attention layer's step of a chunked prefill.

    x: [1, C, d_model], the segment at absolute prompt rows c0..c0+C-1
    (c0 a host int, MASS_GROUP-aligned). k_scr/v_scr: [1, T, Hkv, D]
    full-precision prompt K/V scratch (rows past this segment still
    zero); mass_scr: [1, T] running attention mass. The segment's K/V go
    into the scratch first (in place), then its queries attend the whole
    scratch under the causal test on absolute positions — the prefix in
    full, causal within the segment — so activations, and the scratch
    `compress_prompt` sees at finalize, are those of a monolithic
    `block_prefill`. Policies that read the mass fold it into `mass_scr`
    in place. Returns x."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    C = x.shape[1]
    positions = torch.arange(c0, c0 + C, device=x.device)[None]
    q, k, v = attn.qkv(p["attn"], h, cfg, positions)
    k_scr[:, c0:c0 + C] = k.to(k_scr.dtype)
    v_scr[:, c0:c0 + C] = v.to(v_scr.dtype)
    if _use_flash_prefill_chunk(cfg, spec):
        # same rule as the monolithic path: policies that never read the
        # mass take the flash kernel and keep zero mass
        o = fp_ops.flash_attention_chunk(q, k_scr, v_scr, q_offset=c0,
                                         window=cfg.sliding_window)
    else:
        o, mass = attn.gqa_attention(
            q, k_scr, v_scr, causal=True, window=cfg.sliding_window,
            q_positions=positions, return_mass=True,
            mass_group=attn.MASS_GROUP, mass_init=mass_scr)
        mass_scr.copy_(mass)
    x = x + L.linear(p["attn"]["wo"], o.reshape(1, C, -1))
    return _ffn(p, x, cfg)


def _use_flash_prefill_chunk(cfg, spec: CacheSpec) -> bool:
    """Chunk twin of the monolithic dispatch: the kernel path, for
    policies that read no attention mass."""
    return cfg.use_kernels and not spec.track_scores()


def block_verify(p: dict, x: torch.Tensor, cfg, spec: CacheSpec, lc,
                 valid_len: torch.Tensor, *, ring_full=None,
                 generator: Optional[torch.Generator] = None):
    """One attention layer's step of a speculative verify. x: [B, L,
    d_model], the segment (last committed token + drafts, row b ragged at
    `valid_len[b]`). The segment's K/V are appended first (in place,
    `cache.append_segment`: L sequential masked appends), then every row
    attends the cache in one pass. The mass is not accumulated here:
    `verify_step` applies the accepted rows' once acceptance is known.
    `ring_full`: one host flag per sub-step. Returns (x, row_mass
    [B, L, S+W])."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    B, Lseg, _ = x.shape
    # absolute positions, snapshotted before the append advances lc.pos
    positions = lc.pos[:, None] + torch.arange(Lseg, device=x.device)[None]
    q, k_new, v_new = attn.qkv(p["attn"], h, cfg, positions)
    kvcache.append_segment(lc, spec, k_new, v_new, valid_len=valid_len,
                           ring_full=ring_full, use_kernels=cfg.use_kernels,
                           generator=generator)
    o, row_mass = attn.verify_attention(
        q, lc, spec, q_pos=positions, window=cfg.sliding_window,
        dtype=cfg.dtype, use_kernels=cfg.use_kernels)
    x = x + L.linear(p["attn"]["wo"], o.reshape(B, Lseg, -1))
    return _ffn(p, x, cfg), row_mass


def block_decode(p: dict, x: torch.Tensor, cfg, spec: CacheSpec, lc, *,
                 ring_full: Optional[bool] = None,
                 append_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """x: [B, 1, d_model]. Appends this token's K/V to `lc` (a dense or
    paged layer cache, in place), attends over the cache, accumulates
    the mass. `append_mask` [B] bool: rows where it is False leave the
    cache untouched (their output is computed and discarded by the
    caller: the speculative drafter's ragged depths). One Gumbel draw
    from `generator` serves the layer (NACL's eviction, Keyformer's
    accumulation), as one key serves the JAX block; it is applied after
    the attention returns the mass. Returns x."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    pos = lc.pos[:, None].clone()   # [B, 1]; the append advances lc.pos
    q, k_new, v_new = attn.qkv(p["attn"], h, cfg, pos)
    noise = kvcache.policy_noise(spec, lc.scores.shape, generator, x.device)
    # append-first: the new token attends to itself through the cache
    kvcache.append_token(lc, spec, k_new[:, 0], v_new[:, 0],
                         ring_full=ring_full, mask=append_mask,
                         use_kernels=cfg.use_kernels, noise=noise)
    o, mass = attn.decode_attention(
        q, lc, spec, window=cfg.sliding_window, dtype=cfg.dtype,
        q_pos=pos[:, 0], use_kernels=cfg.use_kernels)
    kvcache.accumulate_scores(lc, spec, mass, gate=append_mask, noise=noise)
    B = x.shape[0]
    x = x + L.linear(p["attn"]["wo"], o.reshape(B, 1, -1))
    return _ffn(p, x, cfg)
