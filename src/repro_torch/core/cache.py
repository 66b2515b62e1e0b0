"""KV-cache data structures with first-class compression (counterpart of
`repro.core.cache`, the dense store of the main serving path).

Per attention layer: a main store of ``budget`` slots (dense, or KIVI
bit-packed codes when ``spec.bits < 16``), a full-precision residual ring
of ``window`` recent tokens, and per-slot metadata (absolute position,
accumulated attention mass). In the model every leaf carries leading
``[n_sb, nA]`` layer dims, the JAX package's layout; a per-layer piece is
a view into those stacked tensors.

**In place.** Where the JAX functions return an updated pytree (and the
engine donates the old one so XLA aliases it), the decode-time functions
here (`append_token*`, `accumulate_scores`, `insert_request`,
`reset_slot`) write the live cache tensors in place and return the same
`LayerKV`. A per-layer view handed to them updates the stacked cache.

The paged store (`core.paging.PagedLayerKV`) shares the metadata field
names, so victim selection, flush planning, the validity bias and score
accumulation here run on either store; `append_token`,
`materialize_kv` and `cache_physical_bytes` dispatch to `core.paging`
for it.

**Masked appends.** Every append takes an optional ``mask`` [B] bool:
a row where it is False keeps its K/V, scores, `slot_pos`, `length`,
`rlen` and `pos` (ragged speculative drafts and verify segments).
`append_segment` is L such appends in order, and `truncate_rows`
un-appends a row's newest tokens (speculative rollback).

**Policy noise.** NACL perturbs the eviction score and Keyformer the
accumulated mass with Gumbel noise. `gumbel` is the one draw function
(the counterpart of `jax.random.gumbel`), from an explicit
`torch.Generator` on the cache's device; `policy_noise` makes the one
draw a layer call needs, or none. `select_victim` and
`accumulate_scores` take that draw as ``noise`` (a decode step draws once
per layer and hands both the same tensor, as the JAX step hands both the
same key); `compress_prompt` and `append_segment` take the generator and
draw where the JAX functions draw. Without a generator nothing is drawn
and both policies rank by the plain mass.

A Mamba-2 layer's "cache" is its `SSMState` (the conv window and the
recurrent state, constant in sequence length); `insert_request_tree` /
`reset_slot_tree` are its per-slot surgery, in place as well.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import quantization as qz
from repro_torch.kernels.kvquant import ops as kvq_ops

NEG_INF = -1e30
_I32_MAX = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# Static spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CacheSpec:
    """Static description of one model's KV cache + compression policy
    (fields as `repro.core.cache.CacheSpec`)."""

    budget: int = 0
    window: int = 0
    sinks: int = 4
    bits: int = 16
    group: int = 64
    policy: str = "none"
    recent_protect: int = 64
    nacl_temperature: float = 0.0
    keyformer_tau: float = 0.0

    def __post_init__(self):
        if self.bits < 16 and not (self.window > 0
                                   and self.group == self.window):
            raise ValueError("quantized decode path flushes the residual "
                             "ring as one per-channel group: require "
                             "group == window")
        if self.budget and self.bits < 16 and self.budget % self.group:
            raise ValueError("quantized budget must be a multiple of group")

    @property
    def quantized(self) -> bool:
        return self.bits < 16

    @property
    def compressed(self) -> bool:
        return self.budget > 0

    def main_store_len(self, max_len: int) -> int:
        return self.budget if self.budget else max_len

    def track_scores(self) -> bool:
        return self.policy in ("h2o", "nacl", "keyformer")


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------


class LayerKV(NamedTuple):
    """One attention layer's cache; every field a tensor. Same field
    names and order as `repro.core.cache.LayerKV` (the packed-code
    layout too: k/v trailing dim D*bits/8 int8 when quantized)."""

    k: torch.Tensor           # [B, S, H, D] dtype | [B, S, H, D*bits/8] int8
    v: torch.Tensor
    k_scale: torch.Tensor     # [B, S//G, H, D] f32 (bits<16) else [B,0,H,D]
    k_zero: torch.Tensor
    v_scale: torch.Tensor     # [B, S, H] f32 (bits<16) else [B,0,H]
    v_zero: torch.Tensor
    rk: torch.Tensor          # [B, W, H, D] residual ring (W may be 0)
    rv: torch.Tensor
    r_scores: torch.Tensor    # [B, W] f32
    scores: torch.Tensor      # [B, S] f32 accumulated attention mass
    slot_pos: torch.Tensor    # [B, S] int32, -1 = empty
    length: torch.Tensor      # [B] int32 valid slots in main store
    rlen: torch.Tensor        # [B] int32 valid slots in residual
    pos: torch.Tensor         # [B] int32 absolute next position
    budget: torch.Tensor      # [] int32 logical per-layer budget


def init_layer_kv(spec: CacheSpec, batch: int, max_len: int, kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, *, device=None,
                  logical_budget: Optional[int] = None,
                  lead: tuple = ()) -> LayerKV:
    """Empty cache for one layer; `lead` prepends layer-stacking dims."""
    S = spec.main_store_len(max_len)
    W = spec.window
    SG = S // spec.group if spec.quantized else 0
    store_dt = torch.int8 if spec.quantized else dtype
    B, H, D = batch, kv_heads, head_dim
    Dp = D * spec.bits // 8 if spec.quantized else D
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dt):
        return torch.zeros(*lead, *shape, dtype=dt, device=device)

    lb = logical_budget if logical_budget is not None else S
    return LayerKV(
        k=z(B, S, H, Dp, dt=store_dt), v=z(B, S, H, Dp, dt=store_dt),
        k_scale=z(B, SG, H, D, dt=f32), k_zero=z(B, SG, H, D, dt=f32),
        v_scale=z(B, S if spec.quantized else 0, H, dt=f32),
        v_zero=z(B, S if spec.quantized else 0, H, dt=f32),
        rk=z(B, W, H, D, dt=dtype), rv=z(B, W, H, D, dt=dtype),
        r_scores=z(B, W, dt=f32), scores=z(B, S, dt=f32),
        slot_pos=torch.full((*lead, B, S), -1, dtype=i32, device=device),
        length=z(B, dt=i32), rlen=z(B, dt=i32), pos=z(B, dt=i32),
        budget=torch.full(lead, lb, dtype=i32, device=device),
    )


def stacked_kv(spec: CacheSpec, n_layers: int, batch: int, max_len: int,
               kv_heads: int, head_dim: int, dtype=torch.bfloat16, *,
               device=None) -> LayerKV:
    """Layer-stacked cache: every leaf gets a leading [n_layers] dim."""
    return init_layer_kv(spec, batch, max_len, kv_heads, head_dim, dtype,
                         device=device, lead=(n_layers,))


def layer_view(stacked, *idx):
    """The per-layer piece at leading index `idx` of a stacked `LayerKV`
    or `PagedLayerKV` — views, so in-place updates of the piece land in
    the stacked cache."""
    return type(stacked)(*(t[idx] for t in stacked))


# ---------------------------------------------------------------------------
# Views for attention
# ---------------------------------------------------------------------------


def validity_bias(lc: LayerKV) -> torch.Tensor:
    """[B, S+W] additive bias over [main | residual]: 0 where the slot
    holds a live token, -1e30 elsewhere (finite, so an all-empty row
    softmaxes uniformly instead of to NaN)."""
    B, S = lc.slot_pos.shape
    dev = lc.slot_pos.device
    idx = torch.arange(S, device=dev)[None]
    main_valid = idx < torch.minimum(lc.length, lc.budget)[:, None]
    bias = torch.where(main_valid, 0.0, NEG_INF).float()
    W = lc.rk.shape[1]
    if W > 0:
        r_valid = torch.arange(W, device=dev)[None] < lc.rlen[:, None]
        bias = torch.cat([bias, torch.where(r_valid, 0.0, NEG_INF).float()],
                         dim=1)
    return bias


def materialize(lc, spec: CacheSpec, dtype=torch.bfloat16):
    """(k, v, bias) over [main | residual]: `materialize_kv` +
    `validity_bias` (callers that already hold the bias call
    `materialize_kv` directly)."""
    k, v = materialize_kv(lc, spec, dtype)
    return k, v, validity_bias(lc)


def materialize_kv(lc, spec: CacheSpec, dtype=torch.bfloat16):
    """Dense (k, v) [B, S+W, H, D] over [main | residual]: the decode
    reference path (dequantizes the whole main store every call; a paged
    store is gathered into its dense view first)."""
    if not isinstance(lc, LayerKV):
        from repro_torch.core import paging
        lc = paging.gather_dense(lc, spec)
    B, S, H, _ = lc.k.shape
    if spec.quantized:
        G = spec.group
        D = lc.k_scale.shape[-1]
        k_codes = qz.unpack_codes(lc.k, spec.bits, D)
        v_codes = qz.unpack_codes(lc.v, spec.bits, D)
        kq = qz.Quantized(k_codes.reshape(B, S // G, G, H, D),
                          lc.k_scale[:, :, None], lc.k_zero[:, :, None])
        k = kq.dequantize(dtype).reshape(B, S, H, D)
        v = qz.Quantized(v_codes, lc.v_scale[..., None],
                         lc.v_zero[..., None]).dequantize(dtype)
    else:
        k, v = lc.k.to(dtype), lc.v.to(dtype)
    if lc.rk.shape[1] > 0:
        # kvlint: ok(step-copy: the [main | ring] view the plain decode path and B5's verify attend over — a step-local temporary per layer, never bound to the cache)
        k = torch.cat([k, lc.rk.to(dtype)], dim=1)
        # kvlint: ok(step-copy: the values' half of the same per-layer view)
        v = torch.cat([v, lc.rv.to(dtype)], dim=1)
    return k, v


# ---------------------------------------------------------------------------
# Policy noise (NACL / Keyformer)
# ---------------------------------------------------------------------------


def gumbel(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard Gumbel draws, f32, of `shape` on `device` from `generator`:
    ``-log(-log(u))`` with u uniform in [tiny, 1), the construction of
    `jax.random.gumbel` (the values differ: another bit generator)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def policy_noise(spec: CacheSpec, shape, generator: Optional[torch.Generator],
                 device) -> Optional[torch.Tensor]:
    """The Gumbel draw of one layer call: NACL with a positive
    temperature or Keyformer with a positive tau, and a generator; else
    None (nothing drawn)."""
    if generator is None or not (
            (spec.policy == "nacl" and spec.nacl_temperature > 0)
            or (spec.policy == "keyformer" and spec.keyformer_tau > 0)):
        return None
    return gumbel(shape, generator, device)


# ---------------------------------------------------------------------------
# Victim selection
# ---------------------------------------------------------------------------


def _evictable_mask(lc: LayerKV, spec: CacheSpec) -> torch.Tensor:
    occupied = lc.slot_pos >= 0
    sink = lc.slot_pos < spec.sinks
    recent = lc.slot_pos >= (lc.pos[:, None] - spec.recent_protect)
    return occupied & ~sink & ~recent


def select_victim(lc: LayerKV, spec: CacheSpec,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] slot index to overwrite, per policy (argmin: first index on
    ties, as jnp.argmin). `noise` [B, S]: the layer's Gumbel draw
    (`policy_noise`); NACL adds ``nacl_temperature * noise`` to the
    scores, other policies ignore it."""
    evictable = _evictable_mask(lc, spec)
    if spec.policy in ("none", "streaming"):
        crit = torch.where(evictable, lc.slot_pos, _I32_MAX)
    else:
        score = lc.scores
        if spec.policy == "nacl" and noise is not None:
            score = score + spec.nacl_temperature * noise
        crit = torch.where(evictable, score, float("inf"))
    victim = torch.argmin(crit, dim=-1)
    # nothing evictable (budget <= sinks + recent_protect): evict the
    # oldest non-sink slot; if every occupied slot is a sink, the last one
    occupied = lc.slot_pos >= 0
    non_sink = occupied & (lc.slot_pos >= spec.sinks)
    fb_crit = torch.where(non_sink, lc.slot_pos, _I32_MAX)
    fallback = torch.where(non_sink.any(dim=-1), torch.argmin(fb_crit, dim=-1),
                           lc.slot_pos.shape[-1] - 1)
    return torch.where(evictable.any(dim=-1), victim, fallback)


# ---------------------------------------------------------------------------
# Per-slot cache surgery (continuous batching)
# ---------------------------------------------------------------------------


def insert_request(stacked: LayerKV, slot_idx: int, prefilled: LayerKV, *,
                   batch_axis: int = 1) -> LayerKV:
    """Copy one request's prefilled cache (batch 1 at `batch_axis`) into
    batch position `slot_idx` of the live cache, in place. `budget` is
    per-layer state of the live cache and is left untouched."""
    for f in LayerKV._fields:
        if f != "budget":
            getattr(stacked, f).narrow(batch_axis, slot_idx, 1).copy_(
                getattr(prefilled, f))
    return stacked


def reset_slot(stacked: LayerKV, slot_idx: int, *,
               batch_axis: int = 1) -> LayerKV:
    """Clear batch position `slot_idx` back to the empty state, in place:
    zeros, slot_pos = -1 (what a fresh `init_layer_kv` holds)."""
    for f in LayerKV._fields:
        if f != "budget":
            getattr(stacked, f).narrow(batch_axis, slot_idx, 1).fill_(
                -1 if f == "slot_pos" else 0)
    return stacked


def insert_request_tree(stacked, slot_idx: int, prefilled, *,
                        batch_axis: int):
    """Generic scatter over a NamedTuple of tensors (an `SSMState`): every
    leaf of `prefilled` (batch 1 at `batch_axis`) replaces batch position
    `slot_idx` of `stacked`, in place."""
    for d, s in zip(stacked, prefilled):
        d.narrow(batch_axis, slot_idx, 1).copy_(s)
    return stacked


def reset_slot_tree(stacked, slot_idx: int, *, batch_axis: int,
                    fill: float = 0.0):
    """Generic clear of batch position `slot_idx`, in place."""
    for d in stacked:
        d.narrow(batch_axis, slot_idx, 1).fill_(fill)
    return stacked


# ---------------------------------------------------------------------------
# Decode append (one token), in place
# ---------------------------------------------------------------------------


def _put_rows(arr: torch.Tensor, slot: torch.Tensor, val: torch.Tensor,
              mask: Optional[torch.Tensor]) -> None:
    """arr[b, slot[b]] = val[b] in place; a row where ``mask[b]`` is False
    keeps its old value (its old entry is read and written back)."""
    rows = torch.arange(arr.shape[0], device=arr.device)
    val = val.to(arr.dtype)
    if mask is not None:
        val = torch.where(mask.view(-1, *([1] * (val.dim() - 1))), val,
                          arr[rows, slot])
    arr[rows, slot] = val


def _advance(counter: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    """counter += 1 on the rows the mask lets through (all without one)."""
    counter.add_(1 if mask is None else mask.to(counter.dtype))


def append_token_dense(lc: LayerKV, spec: CacheSpec, k_new: torch.Tensor,
                       v_new: torch.Tensor, *,
                       mask: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> LayerKV:
    """k_new/v_new: [B, H, D] (post-RoPE). Fixed-budget eviction append;
    rows where `mask` [B] is False are left untouched; `noise` as in
    `select_victim`."""
    B, S = lc.scores.shape
    cap = torch.clamp(lc.budget, max=S)
    full = lc.length >= cap
    slot = torch.where(full, select_victim(lc, spec, noise), lc.length)
    _put_rows(lc.k, slot, k_new, mask)
    _put_rows(lc.v, slot, v_new, mask)
    _put_rows(lc.scores, slot, lc.scores.new_zeros(B), mask)
    _put_rows(lc.slot_pos, slot, lc.pos, mask)
    new_len = torch.minimum(lc.length + 1, cap)
    lc.length.copy_(new_len if mask is None
                    else torch.where(mask, new_len, lc.length))
    _advance(lc.pos, mask)
    return lc


def quantize_kv(k: torch.Tensor, v: torch.Tensor, spec: CacheSpec, *,
                use_kernels: bool = True):
    """KIVI-quantize and pack k, v [B, S, H, D] (one K group per
    `spec.group` rows): ``(kq, vq)`` as `quantization.Quantized` with
    packed codes [B, S, H, D*bits/8] and the layouts of
    `quantize_k_per_channel` / `quantize_v_per_token` (K scale / zero
    [B, S/G, 1, H, D], V [B, S, H, 1]). With `use_kernels` the fused
    kernel (`kernels.kvquant`: K and V in one CUDA launch on the card,
    its plain versions on the CPU), its outputs adapted by views;
    without, `core.quantization` + `pack_codes`. Both compute the same
    function."""
    bits, G = spec.bits, spec.group
    if use_kernels:
        (kp, ks, kz), (vp, vs, vz) = kvq_ops.quantize_kv_pair(
            k, v, bits=bits, group=G)
        return (qz.Quantized(kp, ks[:, :, None], kz[:, :, None]),
                qz.Quantized(vp, vs[..., None], vz[..., None]))
    kq = qz.quantize_k_per_channel(k, bits, G)
    vq = qz.quantize_v_per_token(v, bits)
    return (kq._replace(q=qz.pack_codes(kq.q, bits)),
            vq._replace(q=qz.pack_codes(vq.q, bits)))


def plan_group_flush(lc: LayerKV, spec: CacheSpec, S: int, *,
                     use_kernels: bool = True):
    """Quantized-flush planning: returns ``(gslot, cap_groups, kq, vq,
    new_pos)`` — the destination group per row (the victim group when at
    budget, else the next free one), the group capacity, the packed
    quantized ring (`quantize_kv`: the whole [B, W, H, D] ring, one group
    a row), and the absolute positions of the flushed tokens."""
    B = lc.scores.shape[0]
    G, W = spec.group, spec.window
    n_groups = S // G
    dev = lc.scores.device
    cap_groups = torch.clamp(lc.budget // G, max=n_groups)
    at_cap = (lc.length // G) >= cap_groups
    gscores = lc.scores.reshape(B, n_groups, G).sum(dim=-1)
    gpos = lc.slot_pos.reshape(B, n_groups, G).amax(dim=-1)
    sinkg = torch.arange(n_groups, device=dev)[None] == 0   # protect group 0
    evictable = (gpos >= 0) & ~sinkg
    if spec.policy in ("none", "streaming"):
        crit = torch.where(evictable, gpos, _I32_MAX)
    else:
        crit = torch.where(evictable, gscores, float("inf"))
    gslot = torch.where(at_cap, torch.argmin(crit, dim=-1), lc.length // G)
    kq, vq = quantize_kv(lc.rk, lc.rv, spec, use_kernels=use_kernels)
    new_pos = (lc.pos[:, None] - W
               + torch.arange(W, device=dev)[None]).to(torch.int32)
    return gslot, cap_groups, kq, vq, new_pos


def flush_need(lc, spec: CacheSpec,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B] rows whose append flushes the ring first: a full ring, on a
    row the mask lets append (a masked row's append, flush included,
    never happens)."""
    need = lc.rlen >= spec.window
    return need if mask is None else need & mask


def ring_append(lc, k_new: torch.Tensor, v_new: torch.Tensor,
                mask: Optional[torch.Tensor]) -> None:
    """Write the token at ring row `rlen` and advance `rlen` / `pos`
    (rows the mask lets through). A masked row may sit at a full ring:
    its index clamps to the last row, whose value is written back."""
    W = lc.rk.shape[1]
    at = lc.rlen.long() if mask is None else lc.rlen.clamp(max=W - 1).long()
    _put_rows(lc.rk, at, k_new, mask)
    _put_rows(lc.rv, at, v_new, mask)
    _put_rows(lc.r_scores, at, lc.r_scores.new_zeros(lc.rk.shape[0]), mask)
    _advance(lc.rlen, mask)
    _advance(lc.pos, mask)


def append_token_quantized(lc: LayerKV, spec: CacheSpec,
                           k_new: torch.Tensor, v_new: torch.Tensor, *,
                           ring_full: Optional[bool] = None,
                           mask: Optional[torch.Tensor] = None,
                           use_kernels: bool = True) -> LayerKV:
    """Append to the fp residual ring; a row whose ring is full first
    quantizes it as one per-channel group (KIVI) and flushes it into the
    main store, evicting a whole group when at budget.

    The flush is per row (rows sit at different ring phases under
    continuous batching). It is computed for the whole batch and written
    only where the row's ring is full (and `mask` lets the row append),
    so no row's decision needs the host. `ring_full` is the caller's
    host-side knowledge of whether any row flushes this step: False
    skips the flush work, True runs it; None asks the device (one sync)
    — the engines keep host mirrors of the ring lengths and pass it, so
    their loops never sync here. `use_kernels` picks the flush's
    quantizer (`quantize_kv`)."""
    W = G = spec.window
    B, S = lc.scores.shape
    rows = torch.arange(B, device=lc.k.device)
    need = flush_need(lc, spec, mask)                         # [B]
    if ring_full is None:
        # kvlint: ok(step-sync: asked only when the caller passes ring_full=None — the engines pass their host mirrors' answer; the KVSharer runner and direct model calls pay one sync a quantized layer; a CUDA graph of the step must lose it)
        ring_full = bool(need.any())
    if ring_full:
        n_groups = S // G
        gslot, cap_groups, kq, vq, new_pos = plan_group_flush(
            lc, spec, S, use_kernels=use_kernels)

        def put(arr, val):
            """arr[b, gslot[b]] = val[b] (arr viewed as [B, n_groups,
            -1]) on the rows that flush; other rows keep their contents."""
            a = arr.view(B, n_groups, -1)
            keep = a[rows, gslot]
            a[rows, gslot] = torch.where(need[:, None],
                                         val.reshape(B, -1).to(a.dtype), keep)

        put(lc.k, kq.q)
        put(lc.v, vq.q)
        put(lc.k_scale, kq.scale)
        put(lc.k_zero, kq.zero)
        put(lc.v_scale, vq.scale)
        put(lc.v_zero, vq.zero)
        put(lc.scores, lc.r_scores)
        put(lc.slot_pos, new_pos)
        lc.length.copy_(torch.where(
            need, torch.minimum(lc.length + W, cap_groups * G), lc.length))
        lc.r_scores.masked_fill_(need[:, None], 0.0)
        lc.rlen.masked_fill_(need, 0)
    ring_append(lc, k_new, v_new, mask)
    return lc


def append_token(lc, spec: CacheSpec, k_new: torch.Tensor,
                 v_new: torch.Tensor, *, ring_full: Optional[bool] = None,
                 mask: Optional[torch.Tensor] = None,
                 use_kernels: bool = True,
                 noise: Optional[torch.Tensor] = None):
    """One token per row, in place; `mask` [B] bool (None: every row)
    gates the rows that append, `ring_full` and `use_kernels` as in
    `append_token_quantized`, `noise` (an eviction's NACL draw) as in
    `select_victim`."""
    if not isinstance(lc, LayerKV):
        # paged store: same eviction / flush semantics, K/V writes routed
        # through the block table
        from repro_torch.core import paging
        return paging.append_token_paged(lc, spec, k_new, v_new,
                                         ring_full=ring_full, mask=mask,
                                         use_kernels=use_kernels,
                                         noise=noise)
    if spec.quantized:
        return append_token_quantized(lc, spec, k_new, v_new,
                                      ring_full=ring_full, mask=mask,
                                      use_kernels=use_kernels)
    return append_token_dense(lc, spec, k_new, v_new, mask=mask,
                              noise=noise)


def append_segment(lc, spec: CacheSpec, k_seg: torch.Tensor,
                   v_seg: torch.Tensor, *,
                   valid_len: Optional[torch.Tensor] = None,
                   ring_full: Optional[Sequence[bool]] = None,
                   use_kernels: bool = True,
                   generator: Optional[torch.Generator] = None):
    """Append n tokens per row in order: k_seg/v_seg [B, n, H, D]
    (post-RoPE), in place. The body is n masked `append_token`s, so
    evictions and quantized flushes fire at exactly the positions a
    token-at-a-time loop would fire them (bit-equal by construction), on
    either store. `valid_len` [B] int: row b appends only its first
    `valid_len[b]` tokens (0: none). `ring_full`: one host flag per
    sub-step (None asks the device); `use_kernels` picks the flushes'
    quantizer. Under NACL each sub-step's eviction draws its own noise
    from `generator`, as the JAX function splits its key per token."""
    for t in range(k_seg.shape[1]):
        noise = (policy_noise(spec, lc.scores.shape, generator,
                              lc.scores.device)
                 if spec.policy == "nacl" else None)
        append_token(lc, spec, k_seg[:, t], v_seg[:, t],
                     ring_full=None if ring_full is None else ring_full[t],
                     mask=None if valid_len is None else t < valid_len,
                     use_kernels=use_kernels, noise=noise)
    return lc


# ---------------------------------------------------------------------------
# Speculative rollback: un-append the most recent tokens, in place
# ---------------------------------------------------------------------------


def truncate_rows(lc, spec: CacheSpec, n_drop: torch.Tensor):
    """Un-append the `n_drop[b]` newest tokens of row b (rejected
    speculative drafts); n_drop [B] int, 0 keeps the row. Leaves may carry
    leading layer dims: one call serves a per-layer piece or a whole
    stacked cache, dense or paged.

    The rollback contract (kept by the speculative loop's depth cap): the
    undone appends crossed no eviction and no quantized flush. A dense
    store then lowers `length` / `pos` and clears the dropped rows'
    metadata (slot_pos -1, scores 0, so they leave no trace in victim
    selection); a quantized store lowers `rlen` / `pos` — ring rows past
    `rlen` are masked by the validity bias and rewritten before any flush
    reads them. Dropped K/V bytes stay, masked like a reset slot's."""
    n_drop = n_drop.clamp(min=0).to(lc.length.dtype)
    if spec.quantized:
        lc.rlen.sub_(n_drop)
        lc.pos.sub_(n_drop)
        return lc
    idx = torch.arange(lc.scores.shape[-1], device=lc.scores.device)
    new_len = lc.length - n_drop
    dropped = (idx >= new_len[..., None]) & (idx < lc.length[..., None])
    lc.scores.masked_fill_(dropped, 0.0)
    lc.slot_pos.masked_fill_(dropped, -1)
    lc.length.copy_(new_len)
    lc.pos.sub_(n_drop)
    return lc


# ---------------------------------------------------------------------------
# Score accumulation (H2O / NACL / Keyformer statistics), in place
# ---------------------------------------------------------------------------


def accumulate_scores(lc: LayerKV, spec: CacheSpec, attn_mass: torch.Tensor,
                      *, gate: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None) -> LayerKV:
    """attn_mass: [B, S+W] this step's attention mass per slot, aligned
    with `materialize_kv` ordering (the decode kernel's f32 mass output
    on the kernel path). `gate` [B] bool: rows where it is False add an
    exact 0.0 (speculative verify applies only the accepted rows' masses;
    the float association chain stays that of a row that never saw the
    step), applied after the policy transform. `noise` [B, S]: the
    layer's Gumbel draw; Keyformer adds the main store's
    ``softmax((log(max(mass, 1e-9)) + noise) / tau)`` in place of the
    mass, other policies ignore it."""
    if not spec.track_scores():
        return lc
    S = lc.scores.shape[1]
    main, resid = attn_mass[:, :S], attn_mass[:, S:]
    if spec.policy == "keyformer" and noise is not None:
        main = torch.softmax((torch.log(torch.clamp(main, min=1e-9))
                              + noise) / spec.keyformer_tau, dim=-1)
    if gate is not None:
        main = torch.where(gate[:, None], main, 0.0)
        resid = torch.where(gate[:, None], resid, 0.0)
    lc.scores.add_(main)
    if lc.r_scores.shape[1] > 0:
        lc.r_scores.add_(resid)
    return lc


# ---------------------------------------------------------------------------
# Prefill compression: select `budget` prompt tokens into the cache
# ---------------------------------------------------------------------------


def compress_prompt(spec: CacheSpec, k: torch.Tensor, v: torch.Tensor,
                    attn_mass: torch.Tensor, *, dtype=torch.bfloat16,
                    logical_budget: Optional[int] = None,
                    use_kernels: bool = True,
                    generator: Optional[torch.Generator] = None) -> LayerKV:
    """k, v: [B, S_p, H, D] post-RoPE prompt KV; attn_mass: [B, S_p]
    accumulated attention mass of the prefill pass. Returns a LayerKV at
    the physical budget (last `window` tokens -> residual ring, fp).

    Selection is a top-S by policy score in which ties go to the lower
    index, as `jax.lax.top_k` breaks them (a stable descending sort):
    sinks score +inf, ring and headroom padding -inf, so ties are common,
    and a picked padding row feeds a quantized group's K min/max.
    `use_kernels` picks the quantizer of a quantized store
    (`quantize_kv`). NACL and Keyformer perturb the selection score with
    one Gumbel draw [B, S_p] from `generator` (`policy_noise`), where
    the JAX function draws: only when a selection is made."""
    B, S_p, H, D = k.shape
    S = spec.main_store_len(S_p)
    W = spec.window
    dev = k.device
    positions = torch.arange(S_p, dtype=torch.int32, device=dev).expand(B, S_p)
    lb = logical_budget if logical_budget is not None else S

    if S >= S_p and not spec.quantized and W == 0:
        # no selection needed: place the prompt verbatim (headroom allowed)
        lc = init_layer_kv(spec, B, S_p, H, D, dtype, device=dev,
                           logical_budget=lb)
        lc.k[:, :S_p] = k.to(lc.k.dtype)
        lc.v[:, :S_p] = v.to(lc.v.dtype)
        lc.scores[:, :S_p] = attn_mass.float()
        lc.slot_pos[:, :S_p] = positions
        lc.length.fill_(S_p)
        lc.pos.fill_(S_p)
        return lc

    if spec.policy in ("none", "streaming"):
        score = positions.float()                       # keep most recent
    else:
        score = attn_mass.float()
        g = policy_noise(spec, score.shape, generator, dev)
        if g is not None and spec.policy == "nacl":
            score = score + spec.nacl_temperature * g
        elif g is not None:
            score = ((torch.log(torch.clamp(score, min=1e-9)) + g)
                     / spec.keyformer_tau)

    in_resid = positions >= (S_p - W)
    sink = (positions >= 0) & (positions < spec.sinks)
    sel_score = torch.where(sink, float("inf"), score)
    sel_score = torch.where(in_resid, float("-inf"), sel_score)
    n_main = max(min(S, S_p - W) if S_p - W > 0 else 0, 0)

    pad_amt = max(0, S + W - S_p)
    if pad_amt:
        def padc(x, fill):
            shape = (B, pad_amt, *x.shape[2:])
            return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                            device=dev)], dim=1)
        k, v = padc(k, 0), padc(v, 0)
        attn_mass = padc(attn_mass, 0.0)
        positions = padc(positions, -(10 ** 6))
        sel_score = padc(sel_score, float("-inf"))
    idx = torch.sort(sel_score, dim=-1, descending=True,
                     stable=True).indices[:, :S]
    idx = torch.sort(idx, dim=-1).values                # keep causal order

    def take(x):
        return torch.gather(x, 1, idx.view(B, S, *([1] * (x.dim() - 2)))
                            .expand(B, S, *x.shape[2:]))

    k_sel, v_sel = take(k), take(v)
    score_sel = torch.gather(attn_mass, 1, idx)
    pos_sel = torch.gather(positions, 1, idx)
    n_valid = min(n_main, int(lb))
    valid = torch.arange(S, device=dev)[None] < n_valid

    lc = init_layer_kv(spec, B, S_p, H, D, dtype, device=dev,
                       logical_budget=lb)
    if spec.quantized:
        kq, vq = quantize_kv(k_sel, v_sel, spec, use_kernels=use_kernels)
        lc = lc._replace(
            k=kq.q, v=vq.q,
            k_scale=kq.scale.squeeze(2), k_zero=kq.zero.squeeze(2),
            v_scale=vq.scale.squeeze(-1), v_zero=vq.zero.squeeze(-1))
    else:
        lc = lc._replace(k=k_sel.to(lc.k.dtype), v=v_sel.to(lc.v.dtype))
    lc = lc._replace(
        scores=torch.where(valid, score_sel.float(), 0.0),
        slot_pos=torch.where(valid, pos_sel, -1).to(torch.int32))
    lc.length.fill_(n_valid)
    lc.pos.fill_(S_p)
    if W > 0:
        lc = lc._replace(
            rk=k[:, S_p - W:S_p].to(dtype, copy=True),
            rv=v[:, S_p - W:S_p].to(dtype, copy=True),
            r_scores=attn_mass[:, S_p - W:S_p].to(torch.float32, copy=True))
        lc.rlen.fill_(W)
    return lc


# ---------------------------------------------------------------------------
# SSM / conv state (Mamba2 layers): the attention-free "cache"
# ---------------------------------------------------------------------------


class SSMState(NamedTuple):
    conv: torch.Tensor    # [B, d_conv-1, conv_dim] model dtype
    state: torch.Tensor   # [B, H, P, N] f32


def init_ssm_state(batch: int, conv_dim: int, d_conv: int, heads: int,
                   head_dim: int, d_state: int, *, dtype=torch.bfloat16,
                   device=None, lead: Sequence[int] = ()) -> SSMState:
    """Zero state; `lead` prepends layer dims (the model's ``[n_sb, nS]``)."""
    return SSMState(
        conv=torch.zeros(*lead, batch, d_conv - 1, conv_dim, dtype=dtype,
                         device=device),
        state=torch.zeros(*lead, batch, heads, head_dim, d_state,
                          dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Bytes accounting
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a NamedTuple of tensors (None: 0; None
    leaves count 0)."""
    return 0 if tree is None else sum(t.numel() * t.element_size()
                                      for t in tree if t is not None)


def cache_physical_bytes(lc) -> int:
    """Resident bytes of one cache. Dense: every leaf is reserved memory.
    Paged: the blocks some slot maps plus the metadata (a host sync)."""
    if not isinstance(lc, LayerKV):
        from repro_torch.core import paging
        return paging.paged_physical_bytes(lc)
    return tree_bytes(lc)


def cache_logical_bytes_per_layer(spec: CacheSpec, max_len: int,
                                  kv_heads: int, head_dim: int,
                                  base_bytes: float = 2.0) -> float:
    """What the compression actually stores per layer (ratio ground truth)."""
    S = spec.main_store_len(max_len)
    if spec.quantized:
        return qz.kv_logical_bytes(
            S + spec.window, kv_heads, head_dim, bits=spec.bits,
            group=spec.group, residual_window=spec.window,
            base_bytes=base_bytes)
    return 2 * (S + spec.window) * kv_heads * head_dim * base_bytes
