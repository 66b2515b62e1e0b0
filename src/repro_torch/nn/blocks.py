"""Decoder / encoder blocks: (attention | Mamba-2) mixer, an
encoder-decoder's cross-attention, (dense SwiGLU | MoE | no) FFN,
pre-norm residual (counterpart of `repro.nn.blocks`): the full-sequence
forward (training, the encoder), monolithic prefill, one chunked-prefill
segment, speculative verify, and decode (the chunked and verify steps
attention-only, as in JAX). `generator` (a `torch.Generator` on the
block's device, or None) feeds the NACL / Keyformer noise where the JAX
blocks take `key`. `memory_kv` is an encoder-decoder layer's cross
memory ``(k, v, bias)``, k / v [B, Ts, Hkv, D] (bias [B, Ts] f32 or
None); None in a decoder-only model."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, SSMState
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import sharding as shd
from repro_torch.nn import ssm as ssm_lib
from repro_torch.obs.trace import model_range


class BlockAux(NamedTuple):
    lb_loss: torch.Tensor
    z_loss: torch.Tensor


def _ffn_aux(p: dict, x: torch.Tensor, cfg):
    """The FFN residual and, for an MoE FFN, its `BlockAux` (None for a
    dense FFN or none). An MoE FFN routes the call's tokens together
    (capacity is per call). A block with neither (mamba2, d_ff 0) passes
    x on."""
    if "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"],
                                   L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                                   top_k=cfg.moe.num_experts_per_tok,
                                   capacity_factor=cfg.moe.capacity_factor)
        return x + y, BlockAux(aux.load_balance_loss, aux.router_z_loss)
    if "mlp" in p:
        return (x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x, cfg.norm_eps)),
                None)
    return x, None


def _ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The FFN residual; serving discards an MoE FFN's aux losses, as the
    JAX engine does."""
    return _ffn_aux(p, x, cfg)[0]


def _cross_attend(p: dict, x: torch.Tensor, memory_kv, cfg) -> torch.Tensor:
    """Pre-norm cross-attention over the encoder memory (an
    encoder-decoder layer; x unchanged otherwise): the query gets no
    RoPE, every memory row is visible."""
    if "xattn" not in p or memory_kv is None:
        return x
    mk, mv, mbias = memory_kv
    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    q = shd.split_last(L.linear(p["xattn"]["wq"], h), cfg.num_heads,
                       cfg.head_dim)
    o = attn.gqa_attention(q, mk, mv, causal=False, kv_bias=mbias)
    return x + L.linear(p["xattn"]["wo"], shd.merge_last(o))


def cross_kv(p: dict, memory: torch.Tensor, cfg):
    """Cross-attention K / V [B, Ts, Hkv, D] of the encoder output
    `memory` [B, Ts, d_model] (no RoPE on the memory)."""
    k = shd.split_last(L.linear(p["xattn"]["wk"], memory), cfg.num_kv_heads,
                       cfg.head_dim)
    v = shd.split_last(L.linear(p["xattn"]["wv"], memory), cfg.num_kv_heads,
                       cfg.head_dim)
    return k, v


def block_train(p: dict, x: torch.Tensor, cfg, kind: str = "attn", *,
                causal: bool = True, memory_kv=None):
    """Full-sequence forward over positions 0..T-1 (training; the
    encoder with `causal` False, its q and k still rotated). It runs
    under autograd, so attention stays plain PyTorch whatever
    `cfg.use_kernels` says: the CUDA kernels have no backward, as the
    JAX package's `pallas_call` has no AD rule. Returns (x, `BlockAux`
    of an MoE FFN or None)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        q, k, v = attn.qkv(p["attn"], h, cfg, None)
        o = attn.gqa_attention(q, k, v, causal=causal,
                               window=cfg.sliding_window)
        x = x + L.linear(p["attn"]["wo"], shd.merge_last(o))
    else:
        o, _ = ssm_lib.mamba2_forward(p["ssm"], h, cfg)
        x = x + o
    x = _cross_attend(p, x, memory_kv, cfg)
    return _ffn_aux(p, x, cfg)


def block_prefill(p: dict, x: torch.Tensor, cfg, spec: CacheSpec, *,
                  kind: str = "attn", logical_budget: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  memory_kv=None):
    """x: [B, T, d_model], positions 0..T-1. Returns (x, LayerKV), or for
    a Mamba-2 mixer (`kind` "ssm") (x, its final SSMState)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "ssm":
        o, st = ssm_lib.mamba2_forward(p["ssm"], h, cfg)
        return _ffn(p, _cross_attend(p, x + o, memory_kv, cfg), cfg), st
    q, k, v = attn.qkv(p["attn"], h, cfg, None)

    def attend(q, k, v):
        if cfg.use_kernels and not spec.track_scores():
            # policies that never read the mass statistic take the flash
            # kernel; their prompt selection uses recency, so zero mass
            # is exact for them
            o = fp_ops.flash_attention(q, k, v, window=cfg.sliding_window)
            return o, torch.zeros(q.shape[:2], dtype=torch.float32,
                                  device=q.device)
        return attn.gqa_attention(
            q, k, v, causal=True, window=cfg.sliding_window,
            return_mass=True, mass_group=attn.MASS_GROUP)

    # sharded: each rank attends and compresses its own rows and kv
    # heads; the mass, a partial sum over the tp ranks' heads, is
    # all-reduced before the selection reads it
    layout = (shd.heads_layout(k, cfg.num_kv_heads) if shd.is_dtensor(k)
              else None)
    o, mass = shd.on_shards(attend, layout, q, k, v, out=(4, ("sum", 2)))
    x = x + L.linear(p["attn"]["wo"], shd.merge_last(o))
    lc = shd.on_shards(
        lambda k_, v_, m_: kvcache.compress_prompt(
            spec, k_, v_, m_, dtype=cfg.dtype, logical_budget=logical_budget,
            use_kernels=cfg.use_kernels, generator=generator),
        layout, k, v, mass, out=shd.LAYER_KV_NDIMS)
    return _ffn(p, _cross_attend(p, x, memory_kv, cfg), cfg), lc


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
                 kind: str = "attn", ring_full: Optional[bool] = None,
                 append_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 memory_kv=None):
    """x: [B, 1, d_model]. For a Mamba-2 mixer (`kind` "ssm") `lc` is the
    layer's `SSMState` (views into the model's stacks), advanced one step
    in place. Otherwise appends this token's K/V to `lc` (a dense or
    paged layer cache, in place), attends over the cache, accumulates
    the mass. `append_mask` [B] bool: rows where it is False leave the
    cache untouched (their output is computed and discarded by the
    caller: the speculative drafter's ragged depths). One Gumbel draw
    from `generator` serves the layer (NACL's eviction, Keyformer's
    accumulation), as one key serves the JAX block; it is applied after
    the attention returns the mass. Under the engine's tracer
    (`obs.trace.model_tracing`) the layer's ranges nest as ``attn`` (norm1,
    qkv and RoPE, wo) over ``kv`` (the append with its flush, the noise,
    the mass accumulation) over ``attend`` (the attention kernel), then
    ``mlp`` (norm2 and the FFN); ``ssm`` for a Mamba-2 mixer. Returns x."""
    if kind == "ssm":
        with model_range("ssm"):
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            st: SSMState = lc
            o, new = ssm_lib.mamba2_decode_step(p["ssm"], h, st, cfg)
            st.conv.copy_(new.conv)
            st.state.copy_(new.state)
        x = _cross_attend(p, x + o, memory_kv, cfg)
        with model_range("mlp"):
            return _ffn(p, x, cfg)
    with model_range("attn"):
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        pos = lc.pos[:, None].clone()   # [B, 1]; the append advances lc.pos
        q, k_new, v_new = attn.qkv(p["attn"], h, cfg, pos)
        with model_range("kv"):
            noise = kvcache.policy_noise(spec, lc.scores.shape, generator,
                                         x.device)
            # append-first: the new token attends to itself through the
            # cache. On a sharded cache the in-place updates run on each
            # rank's own rows and heads (`sharding.on_shards`); the mass is
            # all-reduced over the tp ranks before it is accumulated, so
            # every rank evicts alike.
            ref = getattr(lc, "k", None)     # a sharded store is dense
            shd.on_shards(
                lambda lc_, k_, v_, m_, n_: kvcache.append_token(
                    lc_, spec, k_[:, 0], v_[:, 0], ring_full=ring_full,
                    mask=m_, use_kernels=cfg.use_kernels, noise=n_),
                ref, lc, k_new, v_new, append_mask, noise, writes=(0,))
            with model_range("attend"):
                o, mass = attn.decode_attention(
                    q, lc, spec, window=cfg.sliding_window, dtype=cfg.dtype,
                    q_pos=pos[:, 0], use_kernels=cfg.use_kernels)
            shd.on_shards(
                lambda lc_, m_, g_, n_: kvcache.accumulate_scores(
                    lc_, spec, m_, gate=g_, noise=n_),
                ref, lc, mass, append_mask, noise, writes=(0,))
        x = x + L.linear(p["attn"]["wo"], shd.merge_last(o))
    x = _cross_attend(p, x, memory_kv, cfg)
    with model_range("mlp"):
        return _ffn(p, x, cfg)
