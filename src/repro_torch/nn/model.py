"""The LM: init_params / encode / train_forward / prefill / chunked
prefill / decode_step / verify_step / init_cache (counterpart of
`repro.nn.model`: decoders over token ids with attention, Mamba-2 or
hybrid mixers and dense, MoE or no FFNs, and the encoder-decoder, whose
bidirectional encoder reads stubbed frame embeddings and whose decoder
layers cross-attend its output).

Layers are organized into **superblocks** of ``lcm(attn_layer_period,
moe.layer_period)`` layers (1 for uniform models, 8 for Jamba), the JAX
package's layout: parameters keep its tree, ``blocks/sub{i}/...`` leaves
carry a leading ``[n_sb]`` dim, linear weights are ``[d_in, d_out]``, an
MoE FFN's ``moe/{router,gate,up,down}`` the JAX leaves, a Mamba-2
mixer's ``ssm/...`` those of `nn.ssm.ssm_shapes`. The cache is a
`ModelCache`: `LayerKV` (or paged `PagedLayerKV`) leaves for the
attention layers with leading ``[n_sb, nA]`` dims, `SSMState` leaves for
the Mamba-2 layers with ``[n_sb, nS]``, and for an encoder-decoder the
cross memory ``cross_k`` / ``cross_v`` [L, B, Ts, Hkv, D] with
``cross_bias`` [B, Ts]. An encoder-decoder's parameters add
``enc_blocks`` (leading ``[num_encoder_layers]``), ``enc_norm`` and
each decoder layer's ``norm_x`` / ``xattn``. A Python loop over
superblocks, then sublayers, takes the place of `lax.scan`; decode and
the chunked-prefill segments update the cache and the prompt scratch in
place. The chunked and verify paths are attention-only decoders
(uniform, sb 1), gated as in JAX. `train_forward` is differentiable
(`torch.autograd`) and launches no kernel; with ``cfg.remat ==
"block"`` each superblock and encoder layer recomputes its activations
in the backward pass (`torch.utils.checkpoint`, as `jax.checkpoint`).

Where the JAX functions take ``key=`` (the NACL / Keyformer noise), these
take ``generator=``, a `torch.Generator` on the model's device (None:
no noise). Each attention layer draws from it where the JAX function
hands that layer its split key, superblock-major then attention
position: once per attention layer per call in `prefill`,
`prefill_finalize` and `decode_step`.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import cache as kvcache
from repro_torch.core import paging
from repro_torch.core.cache import CacheSpec, LayerKV, SSMState
from repro_torch.nn import blocks as B
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import sharding as shd
from repro_torch.nn import ssm as ssm_lib


class ModelCache(NamedTuple):
    # leaves [n_sb, nA, ...]; None without attention layers (mamba2)
    attn: Optional[Union[LayerKV, paging.PagedLayerKV]]
    ssm: Optional[SSMState] = None   # leaves [n_sb, nS, ...]; None if none
    cross_k: Optional[torch.Tensor] = None   # [L, B, Ts, Hkv, D] enc-dec
    cross_v: Optional[torch.Tensor] = None
    cross_bias: Optional[torch.Tensor] = None   # [B, Ts] f32


class TrainAux(NamedTuple):
    lb_loss: torch.Tensor
    z_loss: torch.Tensor


# ---------------------------------------------------------------------------
# Superblock layout
# ---------------------------------------------------------------------------


def sb_layout(cfg):
    """Returns (sb, n_sb, kinds) where kinds[i] = (mixer_kind, ffn_kind):
    superblocks of lcm(attention period, MoE period) layers."""
    p1 = cfg.attn_layer_period if cfg.attn_layer_period > 0 else 1
    p2 = cfg.moe.layer_period if cfg.is_moe else 1
    sb = math.lcm(p1, p2)
    assert cfg.num_layers % sb == 0, (cfg.num_layers, sb)
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(sb)]
    return sb, cfg.num_layers // sb, kinds


def attn_positions(cfg):
    sb, n_sb, kinds = sb_layout(cfg)
    return [i for i, (k, _) in enumerate(kinds) if k == "attn"]


def ssm_positions(cfg):
    sb, n_sb, kinds = sb_layout(cfg)
    return [i for i, (k, _) in enumerate(kinds) if k == "ssm"]


def _sublayer_shapes(cfg, kind: str, ffn_kind: str, *,
                     cross: bool = False) -> dict:
    """Leaf specs of one layer, the JAX `block_init` tree (`cross`: an
    encoder-decoder's decoder layer, whose cross-attention leaves have
    the self-attention's shapes and biases)."""
    d, D = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads * D, cfg.num_kv_heads * D

    def lin(d_in, d_out, bias):
        p = {"w": ((d_in, d_out), d_in)}
        if bias:
            p["b"] = ((d_out,), 0)
        return p

    p = {"norm1": {"scale": ((d,), -1)}}
    if kind == "attn":
        p["attn"] = {"wq": lin(d, hq, cfg.qkv_bias),
                     "wk": lin(d, hkv, cfg.qkv_bias),
                     "wv": lin(d, hkv, cfg.qkv_bias),
                     "wo": lin(hq, d, cfg.attn_out_bias)}
    else:
        p["ssm"] = ssm_lib.ssm_shapes(cfg)
    if cfg.d_ff > 0 or ffn_kind == "moe":
        p["norm2"] = {"scale": ((d,), -1)}
        if ffn_kind == "moe":
            p["moe"] = moe_lib.moe_shapes(d, cfg.moe.d_expert,
                                          cfg.moe.num_experts)
        else:
            p["mlp"] = {"gate": lin(d, cfg.d_ff, cfg.mlp_bias),
                        "up": lin(d, cfg.d_ff, cfg.mlp_bias),
                        "down": lin(cfg.d_ff, d, cfg.mlp_bias)}
    if cross:
        p["norm_x"] = {"scale": ((d,), -1)}
        p["xattn"] = {"wq": lin(d, hq, cfg.qkv_bias),
                      "wk": lin(d, hkv, cfg.qkv_bias),
                      "wv": lin(d, hkv, cfg.qkv_bias),
                      "wo": lin(hq, d, cfg.attn_out_bias)}
    return p


def _block_shapes(cfg) -> dict:
    """Leaf specs of one superblock: ``sub{i}`` per sublayer."""
    sb, _, kinds = sb_layout(cfg)
    return {f"sub{i}": _sublayer_shapes(cfg, *kinds[i],
                                        cross=cfg.is_encoder_decoder)
            for i in range(sb)}


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random parameters drawn on `device` (None: the card, raising
    without one) from a `torch.Generator`:
    normal(0, 1/fan_in) weights (drawn in f32, cast to cfg.dtype; an MoE
    router kept in f32, as in JAX), unit norms, zero biases; a Mamba-2
    mixer's A_log = log(1..H), D = 1 and dt_bias the inverse softplus of
    a log-uniform draw in [dt_min, dt_max], all three f32 — the JAX
    package's init scheme, not its numbers. On the "meta" device the
    leaves are shapes and dtypes only (the dry run's stand-in for
    `jax.eval_shape`), nothing drawn. Layers are drawn one at a
    time, and expert leaves one expert at a time, so the f32 draw never
    holds more than one layer's largest dense leaf or one expert's
    matrix."""
    device = resolve_device(device)
    meta = device.type == "meta"
    g = None if meta else torch.Generator(device=device).manual_seed(seed)
    _, n_sb, _ = sb_layout(cfg)
    lo, hi = math.log(cfg.ssm.dt_min), math.log(cfg.ssm.dt_max)

    def make(spec, lead=()):
        shape, init, dtype = (*spec, cfg.dtype)[:3]
        out = torch.empty(*lead, *shape, dtype=dtype, device=device)
        if meta:
            return out
        if init == "a_log":
            out.copy_(torch.log(torch.arange(1, shape[0] + 1,
                                             dtype=torch.float32)))
        elif init == "dt_bias":
            for idx in itertools.product(*map(range, lead)):
                u = torch.rand(shape, generator=g, dtype=torch.float32,
                               device=device)
                dt = torch.exp(u * (hi - lo) + lo)
                out[idx] = dt + torch.log(-torch.expm1(-dt))
        elif init < 0:
            out.fill_(1)
        elif init == 0:
            out.zero_()
        else:
            # [E, d_in, d_out] expert leaves: one expert a draw
            per = shape[1:] if len(shape) == 3 else shape
            n_lead = len(lead) + len(shape) - len(per)
            for idx in itertools.product(*map(range, out.shape[:n_lead])):
                w = torch.randn(per, generator=g, dtype=torch.float32,
                                device=device)
                out[idx] = w.mul_(1.0 / math.sqrt(init)).to(dtype)
        return out

    def tree(shapes, lead=()):
        return {k: (tree(v, lead) if isinstance(v, dict) else make(v, lead))
                for k, v in shapes.items()}

    params = {
        "embed": {"table": make(((cfg.vocab_size, cfg.d_model), cfg.d_model))},
        "final_norm": {"scale": make(((cfg.d_model,), -1))},
        "blocks": tree(_block_shapes(cfg), (n_sb,)),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": make(((cfg.d_model, cfg.vocab_size),
                                     cfg.d_model))}
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = tree(_sublayer_shapes(cfg, "attn", "dense"),
                                    (cfg.num_encoder_layers,))
        params["enc_norm"] = {"scale": make(((cfg.d_model,), -1))}
    return params


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _stack(pieces, cls, n_sb: int):
    """Per-layer batch pieces in superblock-major order -> one `cls`
    (LayerKV or SSMState) with leading [n_sb, n_per_sb] dims; None for no
    pieces."""
    if not pieces:
        return None
    return cls(*(torch.stack(leaves).unflatten(0, (n_sb, -1))
                 for leaves in zip(*pieces)))


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.linear(params["head"], x).float()


def _maybe_remat(cfg, fn, *args):
    """fn(*args), its activations recomputed in the backward pass when
    ``cfg.remat == "block"`` and autograd records (`jax.checkpoint`'s
    place; without a backward it changes nothing)."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Encoder (enc-dec archs; bidirectional over stubbed frame embeddings)
# ---------------------------------------------------------------------------


def encode(params, cfg, src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds: [B, Ts, d_model] from the stubbed modality frontend,
    in the model dtype. Returns the normed encoder output."""
    def layer(x, p):
        return B.block_train(p, x, cfg, "attn", causal=False)[0]

    x = src_embeds
    for i in range(cfg.num_encoder_layers):
        x = _maybe_remat(cfg, layer, x, _layer(params["enc_blocks"], i))
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_memory(params, cfg, memory: torch.Tensor):
    """Per-decoder-layer cross K / V [L, B, Ts, Hkv, D] of the encoder
    output and a zero bias [B, Ts] f32."""
    sb, n_sb, _ = sb_layout(cfg)
    assert sb == 1, "enc-dec assumes uniform decoder layers"
    kv = [B.cross_kv(_layer(params["blocks"]["sub0"], i), memory, cfg)
          for i in range(n_sb)]
    bias = torch.zeros(memory.shape[:2], dtype=torch.float32,
                       device=memory.device)
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]),
            bias)


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------


@shd.replicates_plain
def train_forward(params, cfg, batch: dict):
    """batch: {"tokens": [B, S]} (+ "src_embeds" [B, Ts, d_model] for an
    encoder-decoder). Returns (logits [B, S, V] f32, TrainAux: the MoE
    load-balance and router-z losses summed over layers, zeros without
    MoE). Every block runs `block_train`: no kernel is launched."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, batch["src_embeds"].to(cfg.dtype))
    sb, n_sb, kinds = sb_layout(cfg)

    def superblock(x, lb, zl, memory, p_sb):
        for i in range(sb):
            mk = None
            if memory is not None:
                mk = (*B.cross_kv(p_sb[f"sub{i}"], memory, cfg), None)
            x, aux = B.block_train(p_sb[f"sub{i}"], x, cfg, kinds[i][0],
                                   memory_kv=mk)
            if aux is not None:
                lb, zl = lb + aux.lb_loss, zl + aux.z_loss
        return x, lb, zl

    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(n_sb):
        x, lb, zl = _maybe_remat(cfg, superblock, x, lb, zl, memory,
                                 _layer(params["blocks"], s))
    return _logits(params, cfg, x), TrainAux(lb, zl)


@shd.replicates_plain
def prefill(params, cfg, batch: dict, spec: CacheSpec, *,
            layer_budgets: Optional[Sequence[int]] = None,
            generator: Optional[torch.Generator] = None):
    """batch: {"tokens": [B, T] int} (+ "src_embeds" [B, Ts, d_model]
    for an encoder-decoder: encoded once, its cross memory kept in the
    cache). Returns (last-token logits [B, V] f32, ModelCache of the
    compressed prompt, the SSM states and the cross memory).
    `layer_budgets`: one per attention layer, superblock-major."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    T = tokens.shape[1]
    sb, n_sb, kinds = sb_layout(cfg)
    aps = attn_positions(cfg)
    nA = len(aps)
    cross = (None, None, None)
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, batch["src_embeds"].to(cfg.dtype))
        cross = _cross_memory(params, cfg, memory)
    if layer_budgets is None:
        layer_budgets = [spec.main_store_len(T)] * (n_sb * nA)
    attn_pieces, ssm_pieces = [], []
    for s in range(n_sb):
        # the prefill attends the memory with no bias, as in JAX
        mkv = None if cross[0] is None else (cross[0][s], cross[1][s], None)
        for i, (kind, _) in enumerate(kinds):
            p = _layer(params["blocks"][f"sub{i}"], s)
            if kind == "attn":
                x, lc = B.block_prefill(
                    p, x, cfg, spec,
                    logical_budget=int(layer_budgets[s * nA + aps.index(i)]),
                    generator=generator, memory_kv=mkv)
                attn_pieces.append(lc)
            else:
                x, st = B.block_prefill(p, x, cfg, spec, kind="ssm",
                                        memory_kv=mkv)
                ssm_pieces.append(st)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, ModelCache(_stack(attn_pieces, LayerKV, n_sb),
                              _stack(ssm_pieces, SSMState, n_sb), *cross)


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
    """The JAX package's gate, with its messages."""
    if ssm_positions(cfg):
        raise ValueError("chunked prefill is attention-only: SSM state "
                         "carries across segments (sequential scan)")
    if cfg.is_moe:
        raise ValueError("chunked prefill needs per-row MoE capacity: "
                         "per-batch expert capacity couples segment "
                         "tokens, so segmenting changes routing")
    if cfg.is_encoder_decoder:
        raise ValueError("chunked prefill is decoder-only")


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
    return ModelCache(_stack([
        kvcache.compress_prompt(spec, st.k[i, 0], st.v[i, 0], st.mass[i, 0],
                                dtype=cfg.dtype,
                                logical_budget=int(layer_budgets[i]),
                                use_kernels=cfg.use_kernels,
                                generator=generator)
        for i in range(cfg.num_layers)], LayerKV, cfg.num_layers))


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
    if sb_layout(cfg)[0] != 1:
        raise ValueError("prefill_finalize_meta assumes uniform attention "
                         "layers")
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
    engine routes near-hits for policy "none" only). Uniform attention
    models only (sb == 1), as in JAX."""
    sb, _, kinds = sb_layout(cfg)
    if sb != 1 or kinds[0][0] != "attn":
        raise ValueError("prefill_from_kv assumes uniform attention layers")
    _check_chunkable(cfg)
    st = PrefillState(k=ks[:, None].to(cfg.dtype), v=vs[:, None].to(cfg.dtype),
                      mass=torch.zeros((ks.shape[0], 1, *ks.shape[1:3]),
                                       dtype=torch.float32,
                                       device=ks.device))
    return prefill_finalize(cfg, st, spec, layer_budgets=layer_budgets,
                            generator=generator)


@shd.replicates_plain
def decode_step(params, cfg, cache: ModelCache, token: torch.Tensor,
                spec: CacheSpec, *, ring_full: Optional[bool] = None,
                append_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """token: [B, 1] int. Appends one token to every attention layer's
    cache and advances every SSM state (in place); returns (logits [B, V]
    f32, the same ModelCache).

    ring_full: host-side knowledge of whether any row's quantized ring
    flushes this step (see `cache.append_token_quantized`); None asks the
    device once per layer. append_mask: [B] bool, rows where it is False
    leave the cache untouched (the speculative drafter's ragged depths;
    attention-only: an SSM state advances unconditionally)."""
    x = L.embed(params["embed"], token)
    sb, n_sb, kinds = sb_layout(cfg)
    aps, sps = attn_positions(cfg), ssm_positions(cfg)
    if append_mask is not None and sps:
        raise ValueError("append_mask is attention-only (SSM state "
                         "advances unconditionally)")
    for s in range(n_sb):
        mkv = (None if cache.cross_k is None
               else (cache.cross_k[s], cache.cross_v[s], cache.cross_bias))
        for i, (kind, _) in enumerate(kinds):
            p = _layer(params["blocks"][f"sub{i}"], s)
            if kind == "attn":
                x = B.block_decode(
                    p, x, cfg, spec,
                    kvcache.layer_view(cache.attn, s, aps.index(i)),
                    ring_full=ring_full, append_mask=append_mask,
                    generator=generator, memory_kv=mkv)
            else:
                x = B.block_decode(
                    p, x, cfg, spec,
                    kvcache.layer_view(cache.ssm, s, sps.index(i)),
                    kind="ssm", memory_kv=mkv)
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
               src_len: int = 0,
               layer_budgets: Optional[Sequence[int]] = None,
               device=None, paged: bool = False, block_len: int = 16,
               pool_blocks: Optional[int] = None) -> ModelCache:
    """The serving cache: for the attention layers dense `LayerKV`
    leaves, or with `paged` one block pool per layer plus a shared table
    (`core.paging`; the default pool is capacity parity with the dense
    layout); for the Mamba-2 layers zero `SSMState` stacks; for an
    encoder-decoder with `src_len` > 0 zero cross memory."""
    sb, n_sb, kinds = sb_layout(cfg)
    aps, sps = attn_positions(cfg), ssm_positions(cfg)
    attn_c = ssm_c = None
    if aps:
        lead = (n_sb, len(aps))
        if paged:
            S = spec.main_store_len(max_len)
            bl = paging.resolve_block_len(spec, S, block_len)
            attn_c = paging.init_paged_kv(
                spec, batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                n_blocks=pool_blocks or batch * (S // bl), block_len=bl,
                dtype=cfg.dtype, device=device, lead=lead)
        else:
            attn_c = kvcache.init_layer_kv(spec, batch, max_len,
                                           cfg.num_kv_heads, cfg.head_dim,
                                           cfg.dtype, device=device,
                                           lead=lead)
        if layer_budgets is not None:
            attn_c.budget.copy_(torch.as_tensor(
                [int(b) for b in layer_budgets], dtype=torch.int32
            ).view(lead))
    if sps:
        ssm_c = kvcache.init_ssm_state(
            batch, ssm_lib.conv_dim(cfg), cfg.ssm.d_conv, cfg.ssm_heads,
            cfg.ssm.head_dim, cfg.ssm.d_state, dtype=cfg.dtype,
            device=device, lead=(n_sb, len(sps)))
    cross = ()
    if cfg.is_encoder_decoder and src_len > 0:
        shape = (cfg.num_layers, batch, src_len, cfg.num_kv_heads,
                 cfg.head_dim)
        cross = (torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros((batch, src_len), dtype=torch.float32,
                             device=device))
    return ModelCache(attn_c, ssm_c, *cross)
