"""The LM: init_params / prefill / chunked prefill / decode_step /
verify_step / init_cache (counterpart of `repro.nn.model` for
attention-only decoders over token ids).

Parameters keep the JAX package's tree: ``blocks/sub0/...`` leaves carry
a leading ``[n_sb]`` layer dim (one layer per superblock: n_sb is the
number of layers for these attention-only decoders), linear weights
are ``[d_in, d_out]``. The cache is a `ModelCache` whose `LayerKV` (or
paged `PagedLayerKV`) leaves carry leading ``[n_sb, nA]`` dims (nA = 1),
also the JAX layout. A Python loop over layers takes the place of
`lax.scan`; decode and the chunked-prefill segments update the cache and
the prompt scratch in place.

Where the JAX functions take ``key=`` (the NACL / Keyformer noise), these
take ``generator=``, a `torch.Generator` on the model's device (None:
no noise). Each layer draws from it in layer order where the JAX
function hands that layer its split key: once per layer per call in
`prefill`, `prefill_finalize` and `decode_step`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.core import cache as kvcache
from repro_torch.core import paging
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.nn import blocks as B
from repro_torch.nn import layers as L


class ModelCache(NamedTuple):
    attn: Union[LayerKV, paging.PagedLayerKV]    # leaves [n_sb, nA, ...]


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
            layer_budgets: Optional[Sequence[int]] = None,
            generator: Optional[torch.Generator] = None):
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
                                spec, logical_budget=int(layer_budgets[i]),
                                generator=generator)
        pieces.append(lc)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, _stack_layers(pieces)


def _stack_layers(pieces) -> ModelCache:
    """Per-layer batch caches -> one `ModelCache` with [n_sb, nA] dims."""
    return ModelCache(LayerKV(*(torch.stack(leaves)[:, None]
                                for leaves in zip(*pieces))))


# ---------------------------------------------------------------------------
# Chunked prefill: a prompt admitted in segments
# ---------------------------------------------------------------------------
#
# An admission streams its prompt in MASS_GROUP-aligned segments. Each
# segment runs every layer against a per-admission scratch of the exact
# prompt K/V and the running attention mass (`PrefillState`): its K/V are
# written into the scratch, its queries attend the whole scratch under the
# causal test on absolute positions, and the mass folds in the canonical
# grouped order (`nn.attention.MASS_GROUP`). `prefill_finalize` then runs
# the same per-layer `compress_prompt` as the monolithic `prefill`, on the
# same scratch, so the admitted cache and the first token are those of a
# monolithic admission (the JAX package's contract, held against it by
# the tests).


class PrefillState(NamedTuple):
    """Per-admission scratch, layer-stacked like `ModelCache.attn`."""

    k: torch.Tensor      # [n_sb, nA, 1, T, Hkv, D] model dtype
    v: torch.Tensor      # [n_sb, nA, 1, T, Hkv, D]
    mass: torch.Tensor   # [n_sb, nA, 1, T] f32


def _check_chunkable(cfg) -> None:
    """The JAX package's gate refuses SSM positions, experts and
    encoder-decoders; `ModelConfig.__post_init__` refuses those arch kinds
    until their modules are ported, so every config that builds chunks."""


def init_prefill_state(cfg, prompt_len: int, *, device=None) -> PrefillState:
    _check_chunkable(cfg)
    n_sb, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kv = (n_sb, 1, 1, prompt_len, H, D)
    return PrefillState(
        k=torch.zeros(kv, dtype=cfg.dtype, device=device),
        v=torch.zeros(kv, dtype=cfg.dtype, device=device),
        mass=torch.zeros((n_sb, 1, 1, prompt_len), dtype=torch.float32,
                         device=device))


def prefill_chunk(params, cfg, st: PrefillState, tokens: torch.Tensor,
                  c0: int, spec: CacheSpec):
    """Run one prompt segment. tokens: [1, C] (C MASS_GROUP-aligned except
    a final ragged segment); c0: host int absolute start. Updates `st` in
    place; returns (logits [1, V] of the segment's last token, st)."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.num_layers):
        x = B.block_prefill_chunk(_layer(params["blocks"]["sub0"], i), x,
                                  cfg, spec, st.k[i, 0], st.v[i, 0],
                                  st.mass[i, 0], c0)
    return _logits(params, cfg, x[:, -1:])[:, 0], st


def prefill_finalize(cfg, st: PrefillState, spec: CacheSpec, *,
                     layer_budgets: Optional[Sequence[int]] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> ModelCache:
    """Compress the completed scratch into a batch-1 `ModelCache`: the
    monolithic `prefill`'s per-layer `compress_prompt` calls."""
    T = st.mass.shape[-1]
    if layer_budgets is None:
        layer_budgets = [spec.main_store_len(T)] * cfg.num_layers
    return _stack_layers([
        kvcache.compress_prompt(spec, st.k[i, 0], st.v[i, 0], st.mass[i, 0],
                                dtype=cfg.dtype,
                                logical_budget=int(layer_budgets[i]),
                                use_kernels=cfg.use_kernels,
                                generator=generator)
        for i in range(cfg.num_layers)])


def prefill_finalize_meta(cfg, st: PrefillState, spec: CacheSpec, *,
                          layer_budgets: Optional[Sequence[int]] = None
                          ) -> ModelCache:
    """Metadata-only finalize for the paged prefill-direct path: a policy
    that keeps every prompt row verbatim (no quantization, no window,
    budget covering the prompt — `compress_prompt`'s no-selection branch)
    has had each segment's K/V streamed straight into the pool
    (`paging.write_prefill_rows`), so only the dense metadata that branch
    builds is left. K/V leaves are zero-width: the insert runs with
    ``pool_write=False`` and never reads them."""
    n_sb = cfg.num_layers
    T = st.mass.shape[-1]
    S = spec.main_store_len(T)
    if not (S >= T and not spec.quantized and spec.window == 0):
        raise ValueError("prefill-direct needs the verbatim prompt branch "
                         "(budget >= prompt, fp, no window)")
    if layer_budgets is None:
        layer_budgets = [S] * n_sb
    H, D = cfg.num_kv_heads, cfg.head_dim
    dev = st.mass.device
    lead = (n_sb, 1, 1)

    def z(*shape, dt):
        return torch.zeros(*lead, *shape, dtype=dt, device=dev)

    i32 = torch.int32
    scores = z(S, dt=torch.float32)
    scores[..., :T] = st.mass
    slot_pos = torch.full((*lead, S), -1, dtype=i32, device=dev)
    slot_pos[..., :T] = torch.arange(T, dtype=i32, device=dev)
    return ModelCache(LayerKV(
        k=z(0, H, D, dt=cfg.dtype), v=z(0, H, D, dt=cfg.dtype),
        k_scale=z(0, H, D, dt=torch.float32),
        k_zero=z(0, H, D, dt=torch.float32),
        v_scale=z(0, H, dt=torch.float32), v_zero=z(0, H, dt=torch.float32),
        rk=z(0, H, D, dt=cfg.dtype), rv=z(0, H, D, dt=cfg.dtype),
        r_scores=z(0, dt=torch.float32), scores=scores, slot_pos=slot_pos,
        length=torch.full(lead, T, dtype=i32, device=dev),
        rlen=z(dt=i32), pos=torch.full(lead, T, dtype=i32, device=dev),
        budget=torch.as_tensor([int(b) for b in layer_budgets], dtype=i32,
                               device=dev).view(n_sb, 1)))


def prefill_from_kv(cfg, spec: CacheSpec, ks: torch.Tensor,
                    vs: torch.Tensor, *,
                    layer_budgets: Optional[Sequence[int]] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> ModelCache:
    """An insert-ready prefill cache from externally computed per-layer
    K / V ``[L, B, S, Hkv, D]`` (CacheBlend's blended prompt KV): the
    finalize of a chunked admission over that scratch, attention mass
    zero — legal only for policies whose selection ignores the mass (the
    engine routes near-hits for policy "none" only)."""
    _check_chunkable(cfg)
    st = PrefillState(k=ks[:, None].to(cfg.dtype), v=vs[:, None].to(cfg.dtype),
                      mass=torch.zeros((ks.shape[0], 1, *ks.shape[1:3]),
                                       dtype=torch.float32,
                                       device=ks.device))
    return prefill_finalize(cfg, st, spec, layer_budgets=layer_budgets,
                            generator=generator)


def decode_step(params, cfg, cache: ModelCache, token: torch.Tensor,
                spec: CacheSpec, *, ring_full: Optional[bool] = None,
                append_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """token: [B, 1] int. Appends one token to every layer's cache (in
    place) and returns (logits [B, V] f32, the same ModelCache).

    ring_full: host-side knowledge of whether any row's quantized ring
    flushes this step (see `cache.append_token_quantized`); None asks the
    device once per layer. append_mask: [B] bool, rows where it is False
    leave the cache untouched (the speculative drafter's ragged depths)."""
    x = L.embed(params["embed"], token)
    for i in range(cfg.num_layers):
        x = B.block_decode(_layer(params["blocks"]["sub0"], i), x, cfg, spec,
                           kvcache.layer_view(cache.attn, i, 0),
                           ring_full=ring_full, append_mask=append_mask,
                           generator=generator)
    return _logits(params, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Speculative verify: score a drafted segment in one forward, commit the
# accepted prefix, roll the rest back
# ---------------------------------------------------------------------------
#
# Self-speculative decoding (serving/speculative.py) drafts gamma tokens
# against a cheap cache view of the same weights, then `verify_step`
# scores the whole segment (last committed token + drafts) in ONE forward
# over the real cache: the segment is appended (`append_segment`), every
# row attends in one pass (`verify_attention`), and greedy acceptance is
# match-and-truncate. Rejected rows are un-appended (`truncate_rows`) and
# only the accepted rows' masses are accumulated, in sequential order with
# exact-zero padding, so the cache is that of the sequential decode steps
# the segment replaces.


def _check_speculable(cfg) -> None:
    try:
        _check_chunkable(cfg)
    except ValueError as e:
        raise ValueError(f"speculative decoding: {e}") from None


def verify_step(params, cfg, cache: ModelCache, tokens: torch.Tensor,
                valid_len: torch.Tensor, spec: CacheSpec, *,
                ring_full: Optional[Sequence[bool]] = None,
                generator: Optional[torch.Generator] = None):
    """tokens: [B, L] int, per row [last committed token, draft_1 ..
    draft_g, padding]; valid_len: [B] int segment lengths (1 + g; 0 for
    a slot that must not step). ring_full: one host flag per sub-step
    (`cache.append_segment`). `generator`: NACL draws once per sub-step's
    eviction in each layer's append, Keyformer once per layer for every
    accepted row's accumulation (one key serves the JAX layer's rows).

    Returns (y [B, L], accepted [B], the same ModelCache): y[b, t] is the
    greedy token after row b's tokens 0..t; accepted[b] counts the
    leading drafts that match y, so y[b, 0..accepted[b]] commit. The
    cache, updated in place, holds exactly the committed rows."""
    _check_speculable(cfg)
    x = L.embed(params["embed"], tokens)
    Lseg = tokens.shape[1]
    valid_len = valid_len.to(torch.int32)
    masses = []
    for i in range(cfg.num_layers):
        x, rm = B.block_verify(_layer(params["blocks"]["sub0"], i), x, cfg,
                               spec, kvcache.layer_view(cache.attn, i, 0),
                               valid_len, ring_full=ring_full,
                               generator=generator)
        masses.append(rm)
    y = torch.argmax(_logits(params, cfg, x), dim=-1).to(torch.int32)

    # the longest accepted draft prefix: draft i (tokens[:, i]) must equal
    # the target's y[:, i-1] for every i up to the cut
    if Lseg > 1:
        match = tokens[:, 1:].to(torch.int32) == y[:, :-1]
        valid_draft = (torch.arange(Lseg - 1, device=x.device)[None]
                       < (valid_len[:, None] - 1))
        accepted = torch.cumprod((match & valid_draft).to(torch.int32),
                                 dim=1).sum(dim=1).to(torch.int32)
    else:
        accepted = torch.zeros_like(valid_len)
    n_drop = torch.clamp(valid_len - 1 - accepted, min=0)

    # pass 2 (no attention): the accepted rows' masses in sequential
    # order, then un-append the rejects
    for i, mi in enumerate(masses):
        lc = kvcache.layer_view(cache.attn, i, 0)
        if spec.track_scores():
            noise = (kvcache.policy_noise(spec, lc.scores.shape, generator,
                                          x.device)
                     if spec.policy == "keyformer" else None)
            for t in range(Lseg):
                gate = (t <= accepted) & (t < valid_len)
                kvcache.accumulate_scores(lc, spec, mi[:, t], gate=gate,
                                          noise=noise)
        kvcache.truncate_rows(lc, spec, n_drop)
    return y, accepted, cache


def init_cache(cfg, spec: CacheSpec, batch: int, max_len: int, *,
               layer_budgets: Optional[Sequence[int]] = None,
               device=None, paged: bool = False, block_len: int = 16,
               pool_blocks: Optional[int] = None) -> ModelCache:
    """The serving cache: dense `LayerKV` leaves, or with `paged` one
    block pool per layer plus a shared table (`core.paging`; the default
    pool is capacity parity with the dense layout)."""
    n_sb = cfg.num_layers
    if paged:
        S = spec.main_store_len(max_len)
        bl = paging.resolve_block_len(spec, S, block_len)
        attn_c = paging.init_paged_kv(
            spec, batch, max_len, cfg.num_kv_heads, cfg.head_dim,
            n_blocks=pool_blocks or batch * (S // bl), block_len=bl,
            dtype=cfg.dtype, device=device, lead=(n_sb, 1))
    else:
        attn_c = kvcache.init_layer_kv(spec, batch, max_len,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       cfg.dtype, device=device,
                                       lead=(n_sb, 1))
    if layer_budgets is not None:
        attn_c.budget.copy_(torch.as_tensor(
            [int(b) for b in layer_budgets], dtype=torch.int32).view(n_sb, 1))
    return ModelCache(attn_c)
