"""Paged block-table KV cache: one physical pool per layer shared across
slots (counterpart of `repro.core.paging`).

  * **block pool** — per attention layer, ``[n_blocks, block_len, H, Dp]``
    codes (+ matching scale/zero pools for quantized stores). One id
    space spans every layer: block ``i`` reserves row ``i`` of every
    layer's pools, so the allocator and the table are layer-agnostic.
  * **block table** — ``[slots, max_blocks]`` int32 pool block ids
    (-1 = unmapped). Logical main-store row ``s`` of slot ``b`` lives at
    pool row ``tbl[b, s // block_len] * block_len + s % block_len``.
  * **free-list allocator** — host-side, consulted at admission; blocks
    return to the pool on retire through `Scheduler.release`.

Per-slot metadata (scores, slot positions, lengths, the fp residual
ring) stays in dense ``[B, ...]`` leaves named as in `LayerKV`, so the
eviction / flush / bias helpers of `core.cache` run unchanged on either
store.

**The drop block.** JAX drops writes to unmapped rows with
``mode="drop"``. torch's in-place scatter has no such mode, and sorting
valid rows out on the host would cost a device sync per decode step. So
every pool carries one block past the grantable ones (``pk.shape[-4] ==
n_blocks + 1``): a write routed through a -1 entry (a free slot's
garbage decode, a non-flushing row, rows past a partial grant) lands in
that block. The allocator never grants it and no table maps it, so
nothing reads it. Reads clamp -1 to block 0 and are masked by the
validity bias, as in the JAX package.

Like `core.cache`, the decode-time functions update the live tensors in
place and return the same object.

Prefix sharing maps one block into several slots' tables: the
allocator refcounts every holder (slots and the prefix index), an insert
skips the adopted leading blocks (`n_skip`), and copy-on-write clones
shared blocks into fresh ones (`copy_pool_blocks`).

Lazy block growth grants a slot further blocks as it decodes
(`write_block_table` into its row) and a speculative rollback returns
them (`clear_block_table_from`); `FaultPlan` injects deterministic
allocator refusals, refcount skew and host-tier fetch faults, which
`audit_pool` must catch or the engine must ride out.

The rest of the overload ladder:

  * **degradation** — `degrade_slot_groups` drops a resident quantized
    slot's oldest flushed groups by permuting its table row in place (no
    pool data moves);
  * **the host tier** — `HostTier` keeps spilled block payloads
    (`gather_pool_blocks` / `gather_slot_meta`) in pinned host memory.
    The gather is a fresh device copy enqueued on the main stream, in
    order behind the step in flight; the device-to-host copy runs on one
    side stream per device, which carries copies only, never a kernel.
    A fetch hands back the pinned payload; `HostTier.upload` copies it
    to the device on the main stream before `scatter_pool_blocks` /
    `scatter_slot_meta` land it in freshly granted rows.
"""
from __future__ import annotations

import itertools
import random
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.kernels.decode_qattn.ref import gather_pool
from repro_torch.obs.trace import NULL_TRACER

# Leaves backed by the shared pool (no batch dim: leading dims are layer
# stacking, then [n_blocks + 1, rows_per_block, ...]).
POOL_FIELDS = ("pk", "pv", "pk_scale", "pk_zero", "pv_scale", "pv_zero")
# Dense per-slot metadata, name-compatible with LayerKV.
META_FIELDS = ("rk", "rv", "r_scores", "scores", "slot_pos",
               "length", "rlen", "pos")


class PagedLayerKV(NamedTuple):
    """One attention layer's paged cache (fields as
    `repro.core.paging.PagedLayerKV`). Pool leaves have no batch dim and
    one trailing drop block; metadata leaves mirror `LayerKV`."""

    pk: torch.Tensor         # [n_blocks+1, bl, H, Dp] dtype | packed int8
    pv: torch.Tensor
    pk_scale: torch.Tensor   # [n_blocks+1, bl//G, H, D] f32 (bits<16) else [.., 0, H, D]
    pk_zero: torch.Tensor
    pv_scale: torch.Tensor   # [n_blocks+1, bl, H] f32 (bits<16) else [.., 0, H]
    pv_zero: torch.Tensor
    block_tbl: torch.Tensor  # [B, max_blocks] int32 pool block ids, -1 = unmapped
    rk: torch.Tensor         # [B, W, H, D] residual ring (W may be 0)
    rv: torch.Tensor
    r_scores: torch.Tensor   # [B, W] f32
    scores: torch.Tensor     # [B, S] f32 accumulated attention mass
    slot_pos: torch.Tensor   # [B, S] int32, -1 = empty
    length: torch.Tensor     # [B] int32 valid slots in main store
    rlen: torch.Tensor       # [B] int32 valid slots in residual
    pos: torch.Tensor        # [B] int32 absolute next position
    budget: torch.Tensor     # [] int32 logical per-layer budget (<= S)


def n_blocks(p: PagedLayerKV) -> int:
    """Grantable blocks of the pool (the drop block excluded)."""
    return p.pk.shape[-4] - 1


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def resolve_block_len(spec: CacheSpec, S: int, block_len: int) -> int:
    """Largest legal block length <= the request. Quantized stores flush
    whole groups, so the block IS the group; dense stores need
    ``S % block_len == 0``, so snap to the largest divisor of S (warning
    when the snap is drastic: a tiny block is a table-width cliff)."""
    if spec.quantized:
        return spec.group
    req = max(int(block_len), 1)
    bl = max(d for d in range(1, min(req, S) + 1) if S % d == 0)
    if bl < req and bl < 4:
        warnings.warn(
            f"paged block_len snapped {req} -> {bl} (store length {S} has "
            f"no larger divisor <= {req}); pad prompt_len/max_new so "
            f"S is divisible by the block length you want", stacklevel=2)
    return bl


def init_paged_kv(spec: CacheSpec, batch: int, max_len: int, kv_heads: int,
                  head_dim: int, *, n_blocks: int, block_len: int,
                  dtype=torch.bfloat16, device=None,
                  logical_budget: Optional[int] = None,
                  lead: tuple = ()) -> PagedLayerKV:
    """Zeros-initialized paged cache (cf. `cache.init_layer_kv`); `lead`
    prepends layer-stacking dims. Pools start as zeros: a clamped read of
    an unmapped entry must see finite values (a NaN score would poison
    its row even under the -1e30 bias)."""
    S = spec.main_store_len(max_len)
    bl = resolve_block_len(spec, S, block_len)
    if S % bl:
        raise ValueError(f"store length {S} not a multiple of block {bl}")
    n_max = S // bl
    W = spec.window
    spb = bl // spec.group if spec.quantized else 0   # scale rows per block
    store_dt = torch.int8 if spec.quantized else dtype
    B, H, D = batch, kv_heads, head_dim
    Dp = D * spec.bits // 8 if spec.quantized else D
    nbt = n_blocks + 1
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dt):
        return torch.zeros(*lead, *shape, dtype=dt, device=device)

    lb = logical_budget if logical_budget is not None else S
    return PagedLayerKV(
        pk=z(nbt, bl, H, Dp, dt=store_dt), pv=z(nbt, bl, H, Dp, dt=store_dt),
        pk_scale=z(nbt, spb, H, D, dt=f32), pk_zero=z(nbt, spb, H, D, dt=f32),
        pv_scale=z(nbt, bl if spec.quantized else 0, H, dt=f32),
        pv_zero=z(nbt, bl if spec.quantized else 0, H, dt=f32),
        block_tbl=torch.full((*lead, B, n_max), -1, dtype=i32, device=device),
        rk=z(B, W, H, D, dt=dtype), rv=z(B, W, H, D, dt=dtype),
        r_scores=z(B, W, dt=f32), scores=z(B, S, dt=f32),
        slot_pos=torch.full((*lead, B, S), -1, dtype=i32, device=device),
        length=z(B, dt=i32), rlen=z(B, dt=i32), pos=z(B, dt=i32),
        budget=torch.full(lead, lb, dtype=i32, device=device),
    )


def stacked_paged_kv(spec: CacheSpec, n_layers: int, batch: int,
                     max_len: int, kv_heads: int, head_dim: int, *,
                     n_blocks: int, block_len: int, dtype=torch.bfloat16,
                     device=None) -> PagedLayerKV:
    """Layer-stacked paged cache: every leaf gets a leading [n_layers]
    dim; one allocation maps the same id in every layer's table."""
    return init_paged_kv(spec, batch, max_len, kv_heads, head_dim,
                         n_blocks=n_blocks, block_len=block_len, dtype=dtype,
                         device=device, lead=(n_layers,))


# ---------------------------------------------------------------------------
# Gather: paged -> dense per-slot view (the reference path)
# ---------------------------------------------------------------------------


def gather_dense(p: PagedLayerKV, spec: CacheSpec) -> LayerKV:
    """The dense `LayerKV` view of one paged layer: each slot's blocks in
    table order. Unmapped entries clamp to block 0 — those rows are past
    `length` and masked by the validity bias."""
    def g(pool):                    # [nb+1, r, ...] -> [B, n_max*r, ...]
        return gather_pool(pool, p.block_tbl)

    return LayerKV(
        k=g(p.pk), v=g(p.pv), k_scale=g(p.pk_scale), k_zero=g(p.pk_zero),
        v_scale=g(p.pv_scale), v_zero=g(p.pv_zero),
        rk=p.rk, rv=p.rv, r_scores=p.r_scores, scores=p.scores,
        slot_pos=p.slot_pos, length=p.length, rlen=p.rlen, pos=p.pos,
        budget=p.budget)


# ---------------------------------------------------------------------------
# Scatter primitives
# ---------------------------------------------------------------------------


def _phys_rows(block_tbl: torch.Tensor, slot: torch.Tensor, bl: int,
               nb: int) -> torch.Tensor:
    """[B] physical pool row of logical main-store row `slot[b]`;
    unmapped blocks go to the drop block's first row."""
    blk = torch.gather(block_tbl, 1, (slot // bl).long()[:, None])[:, 0]
    return torch.where(blk < 0, nb * bl, blk * bl + slot % bl).long()


def _scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """pool [nb+1, bl, ...]; rows [B] flat row ids; vals [B, ...]."""
    pool.view(-1, *pool.shape[2:])[rows] = vals.to(pool.dtype)


# ---------------------------------------------------------------------------
# Decode append — one token, through the block table, in place
# ---------------------------------------------------------------------------


def append_token_paged(p: PagedLayerKV, spec: CacheSpec, k_new: torch.Tensor,
                       v_new: torch.Tensor, *,
                       ring_full: Optional[bool] = None,
                       mask: Optional[torch.Tensor] = None,
                       use_kernels: bool = True,
                       noise: Optional[torch.Tensor] = None) -> PagedLayerKV:
    """Paged twin of `cache.append_token`: the same eviction / ring-flush
    semantics (shared planning helpers), K/V writes routed through the
    block table. `ring_full`, `mask`, `use_kernels` and `noise` as in
    `cache.append_token`: a masked row's pool writes go to the drop
    block, its metadata stays."""
    if spec.quantized:
        return _append_quantized_paged(p, spec, k_new, v_new,
                                       ring_full=ring_full, mask=mask,
                                       use_kernels=use_kernels)
    B, S = p.scores.shape
    bl = p.pk.shape[1]
    cap = torch.clamp(p.budget, max=S)
    full = p.length >= cap
    slot = torch.where(full, kvcache.select_victim(p, spec, noise),
                       p.length)
    phys = _phys_rows(p.block_tbl, slot, bl, n_blocks(p))
    if mask is not None:
        phys = torch.where(mask, phys, n_blocks(p) * bl)
    _scatter_rows(p.pk, phys, k_new)
    _scatter_rows(p.pv, phys, v_new)
    kvcache._put_rows(p.scores, slot, p.scores.new_zeros(B), mask)
    kvcache._put_rows(p.slot_pos, slot, p.pos, mask)
    new_len = torch.minimum(p.length + 1, cap)
    p.length.copy_(new_len if mask is None
                   else torch.where(mask, new_len, p.length))
    kvcache._advance(p.pos, mask)
    return p


def _append_quantized_paged(p: PagedLayerKV, spec: CacheSpec,
                            k_new: torch.Tensor, v_new: torch.Tensor, *,
                            ring_full: Optional[bool],
                            mask: Optional[torch.Tensor],
                            use_kernels: bool) -> PagedLayerKV:
    W = G = spec.window
    B, S = p.scores.shape
    if p.pk.shape[1] != G:
        raise ValueError("quantized pools flush one block per group")
    rows = torch.arange(B, device=p.pk.device)
    need = kvcache.flush_need(p, spec, mask)                 # [B]
    if ring_full is None:
        ring_full = bool(need.any())
    if ring_full:
        n_groups = S // G
        gslot, cap_groups, kq, vq, new_pos = kvcache.plan_group_flush(
            p, spec, S, use_kernels=use_kernels)
        # destination block per row; rows not flushing (or with an
        # unmapped group: a free slot) write the drop block
        blk = torch.gather(p.block_tbl, 1, gslot[:, None])[:, 0]
        tgt = torch.where(need & (blk >= 0), blk, n_blocks(p)).long()
        for pool, val in ((p.pk, kq.q), (p.pv, vq.q),
                          (p.pk_scale, kq.scale), (p.pk_zero, kq.zero),
                          (p.pv_scale, vq.scale), (p.pv_zero, vq.zero)):
            pool[tgt] = val.reshape(B, *pool.shape[1:]).to(pool.dtype)

        def put(arr, val):
            """arr[b, gslot[b]] = val[b] on the flushing rows (metadata
            is per-slot dense: other rows keep their contents)."""
            a = arr.view(B, n_groups, -1)
            keep = a[rows, gslot]
            a[rows, gslot] = torch.where(need[:, None],
                                         val.reshape(B, -1).to(a.dtype), keep)

        put(p.scores, p.r_scores)
        put(p.slot_pos, new_pos)
        p.length.copy_(torch.where(
            need, torch.minimum(p.length + W, cap_groups * G), p.length))
        p.r_scores.masked_fill_(need[:, None], 0.0)
        p.rlen.masked_fill_(need, 0)
    kvcache.ring_append(p, k_new, v_new, mask)
    return p


# ---------------------------------------------------------------------------
# Per-slot surgery (continuous batching), in place
# ---------------------------------------------------------------------------


def _flat_rows(pool: torch.Tensor, batch_axis: int) -> torch.Tensor:
    """View of a pool with its (block, row) axes merged."""
    return pool.view(*pool.shape[:batch_axis], -1,
                     *pool.shape[batch_axis + 2:])


def insert_request_paged(stacked: PagedLayerKV, slot_idx: int,
                         prefilled: LayerKV, block_ids: torch.Tensor, *,
                         batch_axis: int = 1, n_skip: int = 0,
                         pool_write: bool = True) -> PagedLayerKV:
    """Scatter one request's prefilled *dense* `LayerKV` (batch 1 at
    `batch_axis`) into slot `slot_idx` of a live paged cache whose blocks
    `block_ids` ([n_max] int32 on the cache's device, -1-padded) the
    allocator just granted. Metadata rows copy as in the dense
    `insert_request`, store rows scatter into the granted blocks, and
    the table row becomes `block_ids`. Rows past the granted blocks are
    headroom beyond the request's budgeted length and go to the drop
    block. `n_skip` (host int) sends the pool writes of the first
    `n_skip` table positions to the drop block too: those blocks were
    adopted read-only from the prefix index and already hold the same
    rows, which other slots map. `pool_write=False` skips the K/V
    scatter: the prefill-direct path already streamed the rows into the
    pool."""
    for f in META_FIELDS:
        getattr(stacked, f).narrow(batch_axis, slot_idx, 1).copy_(
            getattr(prefilled, f))
    write_block_table(stacked, slot_idx, 0, block_ids, batch_axis=batch_axis)
    if not pool_write:
        return stacked
    nb = n_blocks(stacked)
    ids = block_ids.long()
    for f, src in (("pk", "k"), ("pv", "v"), ("pk_scale", "k_scale"),
                   ("pk_zero", "k_zero"), ("pv_scale", "v_scale"),
                   ("pv_zero", "v_zero")):
        pool = getattr(stacked, f)
        r = pool.shape[batch_axis + 1]
        if r == 0:
            continue
        ar = torch.arange(r, device=ids.device)
        skip = ids[:, None] < 0
        if n_skip:
            skip = skip | (torch.arange(ids.shape[0],
                                        device=ids.device)[:, None] < n_skip)
        rows = torch.where(skip, nb * r + ar, ids[:, None] * r + ar
                           ).reshape(-1)
        val = getattr(prefilled, src).select(batch_axis, 0)
        _flat_rows(pool, batch_axis).index_copy_(batch_axis, rows,
                                                 val.to(pool.dtype))
    return stacked


def copy_pool_blocks(stacked: PagedLayerKV, src_ids: torch.Tensor,
                     dst_ids: torch.Tensor, *,
                     batch_axis: int = 1) -> PagedLayerKV:
    """Copy whole pool blocks `src_ids` -> `dst_ids` ([k] int64 on the
    cache's device, every layer at once), in place: the device half of
    copy-on-write — the engine allocates fresh ids, copies the shared
    blocks' rows, then rewrites the diverging slot's table entries to the
    copies (`write_block_table`)."""
    for f in POOL_FIELDS:
        pool = getattr(stacked, f)
        if pool.shape[batch_axis + 1] == 0:
            continue
        pool.index_copy_(batch_axis, dst_ids,
                         pool.index_select(batch_axis, src_ids))
    return stacked


def gather_pool_blocks(stacked: PagedLayerKV, ids: torch.Tensor, *,
                       batch_axis: int = 1) -> Dict[str, torch.Tensor]:
    """Read whole pool blocks `ids` ([k] int64 on the cache's device) out
    of every layer's pools: the device half of a spill to the host tier.
    A dict keyed by `POOL_FIELDS` name (the zero-width quantization
    leaves of a dense store omitted), each value the pool with its block
    axis replaced by `k`. Each value is a fresh tensor (`index_select`),
    never a view: the pools are written in place, and the caller frees
    and re-grants the ids at once, so the copy must be taken here, in
    stream order behind the step in flight."""
    out: Dict[str, torch.Tensor] = {}
    for f in POOL_FIELDS:
        pool = getattr(stacked, f)
        if pool.shape[batch_axis + 1] == 0:
            continue
        out[f] = pool.index_select(batch_axis, ids)
    return out


def scatter_pool_blocks(stacked: PagedLayerKV, ids: torch.Tensor,
                        payload: Mapping[str, torch.Tensor], *,
                        batch_axis: int = 1) -> PagedLayerKV:
    """Write spilled block bytes back into pool blocks `ids` ([k] int64 on
    the cache's device), in place: the device half of a fetch. `payload`
    is a `gather_pool_blocks` result already on the device
    (`HostTier.upload`); the ids are freshly granted and generally not
    the ones the blocks were spilled from — block identity lives with
    the holder's table row or index node, not the row number."""
    for f, val in payload.items():
        pool = getattr(stacked, f)
        pool.index_copy_(batch_axis, ids, val.to(pool.dtype))
    return stacked


def gather_slot_meta(stacked: PagedLayerKV, slot_idx: int, *,
                     batch_axis: int = 1) -> Dict[str, torch.Tensor]:
    """Slot `slot_idx`'s dense metadata row (scores, slot positions,
    lengths, the residual ring), batch dim kept at 1, as fresh tensors:
    the non-pool half of a slot snapshot, so a spilled slot resumes with
    exactly the eviction and flush state it was preempted with."""
    return {f: getattr(stacked, f).narrow(batch_axis, slot_idx, 1).clone()
            for f in META_FIELDS}


def scatter_slot_meta(stacked: PagedLayerKV, slot_idx: int,
                      payload: Mapping[str, torch.Tensor], *,
                      batch_axis: int = 1) -> PagedLayerKV:
    """Write a `gather_slot_meta` snapshot back into slot `slot_idx`."""
    for f, val in payload.items():
        getattr(stacked, f).narrow(batch_axis, slot_idx, 1).copy_(val)
    return stacked


def write_prefill_rows(stacked: PagedLayerKV, rows: torch.Tensor,
                       k_seg: torch.Tensor, v_seg: torch.Tensor, *,
                       batch_axis: int = 1) -> PagedLayerKV:
    """Prefill-direct segment write (dense pools): one streamed chunk's
    K/V rows ([..., 1, C, H, D], batch at `batch_axis`) go straight into
    flat pool rows `rows` ([C], host-computed as ``ids[t // bl] * bl +
    t % bl``), skipping the scratch -> compress -> scatter hop for
    policies that keep every prompt row."""
    for pool, seg in ((stacked.pk, k_seg), (stacked.pv, v_seg)):
        _flat_rows(pool, batch_axis).index_copy_(
            batch_axis, rows.long(), seg.select(batch_axis, 0).to(pool.dtype))
    return stacked


def reset_slot_paged(stacked: PagedLayerKV, slot_idx: int, *,
                     batch_axis: int = 1) -> PagedLayerKV:
    """Clear slot `slot_idx`: metadata back to the empty state, table row
    to -1. Pool rows stay as they are — the allocator owns recycling and
    unmapped rows are unreachable through any table."""
    for f in META_FIELDS + ("block_tbl",):
        getattr(stacked, f).narrow(batch_axis, slot_idx, 1).fill_(
            -1 if f in ("slot_pos", "block_tbl") else 0)
    return stacked


def write_block_table(stacked: PagedLayerKV, slot_idx: int, start: int,
                      ids: torch.Tensor, *,
                      batch_axis: int = 1) -> PagedLayerKV:
    """Write `ids` ([k] int32 pool block ids) into table row `slot_idx`
    from entry `start`, in every layer copy of the table."""
    stacked.block_tbl.narrow(batch_axis, slot_idx, 1).narrow(
        -1, start, ids.shape[0]).copy_(ids)
    return stacked


def clear_block_table_from(stacked: PagedLayerKV, slot_idx: int, start: int,
                           *, batch_axis: int = 1) -> PagedLayerKV:
    """Unmap table entries >= `start` of row `slot_idx` (host ints), in
    every layer copy: blocks released host-side must stop receiving this
    slot's rows before the free list re-grants them."""
    row = stacked.block_tbl.narrow(batch_axis, slot_idx, 1)
    row.narrow(-1, start, row.shape[-1] - start).fill_(-1)
    return stacked


# ---------------------------------------------------------------------------
# Free-list allocator (host-side, like the scheduler)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault injection for `BlockAllocator` (as
    `repro.core.paging.FaultPlan`), the test harness of the overload
    ladder. Faults are keyed by alloc-call index (0-based count of `alloc`
    calls), so a plan replays identically against the same workload:

      * `fail_allocs` — call indices refused although the free list
        could cover them (a transient exhaustion);
      * `fail_rate` — extra refusals drawn from `random.Random(seed)`,
        one draw per would-succeed call; `max_failures` bounds the total;
      * `skew_alloc` / `skew_delta` — silently corrupt the refcount of
        the first id handed out by call `skew_alloc` (positive leaks the
        block, negative under-counts it); `audit_pool` must catch either.

    The same plan drives the host tier's swap path (`HostTier` takes it
    too), keyed by fetch-call index with its own rng stream
    (``random.Random(seed + 1)``), so alloc and fetch faults compose
    without perturbing each other:

      * `fail_fetches` / `fetch_fail_rate` / `max_fetch_failures` — the
        fetch is refused as if the host copy were unreadable: the entry
        is dropped and the engine falls down the ladder to
        recompute-on-resume;
      * `delay_fetches` / `fetch_delay_s` — the fetch completes but is
        charged `fetch_delay_s` of stall."""

    seed: int = 0
    fail_allocs: Tuple[int, ...] = ()
    fail_rate: float = 0.0
    max_failures: Optional[int] = None
    skew_alloc: Optional[int] = None
    skew_delta: int = 1
    fail_fetches: Tuple[int, ...] = ()
    fetch_fail_rate: float = 0.0
    max_fetch_failures: Optional[int] = None
    delay_fetches: Tuple[int, ...] = ()
    fetch_delay_s: float = 0.005


class PoolAuditError(AssertionError):
    """A pool invariant audit failed; the message lists every violation."""


class BlockAllocator:
    """Refcounted free list over the shared block-id space; one id
    reserves the same row of every layer's pools. `alloc` is
    all-or-nothing: a request that does not fit leaves the pool
    untouched (admission refusal). `incref` adds a holder (the prefix
    index, a slot adopting a shared block); `free` drops one reference
    and recycles the block with its last. Freeing or increfing a block
    that is not allocated raises. `fault_plan` (a `FaultPlan`) injects
    deterministic refusals and refcount skew; without one the allocator
    never refuses a call it can cover. `tracer` sees only the refusals
    (`alloc_refused`): an event per alloc / free would flood the ring;
    the engine samples `available` once per loop iteration instead."""

    def __init__(self, n_blocks: int, *,
                 fault_plan: Optional[FaultPlan] = None, tracer=None):
        if n_blocks < 1:
            raise ValueError(f"need >= 1 block, got {n_blocks}")
        self.n_blocks = n_blocks
        self.trace = tracer if tracer is not None else NULL_TRACER
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self.peak_used = 0
        self.fault_plan = fault_plan
        self.alloc_calls = 0
        self.faults_injected = 0
        self.skews_injected = 0
        self._fault_rng = (random.Random(fault_plan.seed)
                           if fault_plan is not None else None)

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.n_blocks - len(self._free)

    def free_ids(self) -> List[int]:
        return list(self._free)

    def refcounts(self) -> Dict[int, int]:
        return dict(self._refs)

    def _inject_failure(self, call_idx: int, n: int) -> bool:
        """True when the fault plan refuses this (would-succeed) call."""
        plan = self.fault_plan
        if plan is None or n == 0 or n > len(self._free):
            return False
        if (plan.max_failures is not None
                and self.faults_injected >= plan.max_failures):
            return False
        # draw before the explicit-index check, so the stream depends only
        # on the sequence of would-succeed calls (replayable)
        r = self._fault_rng.random() if plan.fail_rate > 0.0 else 1.0
        return call_idx in plan.fail_allocs or r < plan.fail_rate

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"negative block count {n}")
        call_idx = self.alloc_calls
        self.alloc_calls += 1
        if self._inject_failure(call_idx, n):
            self.faults_injected += 1
            if self.trace:
                self.trace.instant("alloc_refused",
                                   args=dict(n=n, free=len(self._free),
                                             injected=True))
            return None
        if n > len(self._free):
            if self.trace:
                self.trace.instant("alloc_refused",
                                   args=dict(n=n, free=len(self._free)))
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        plan = self.fault_plan
        if plan is not None and plan.skew_alloc == call_idx and ids:
            self._refs[ids[0]] += plan.skew_delta
            self.skews_injected += 1
        self.peak_used = max(self.peak_used, self.used)
        return ids

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    def incref(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i not in self._refs:
                raise ValueError(f"block {i} is not allocated")
            self._refs[i] += 1

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i not in self._refs:
                raise ValueError(f"block {i} is not allocated")
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                self._free.append(i)


# ---------------------------------------------------------------------------
# Host tier: spilled block payloads in pinned host memory
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a payload tree (nested dicts), dict keys sorted at
    every level — the order `jax.tree.leaves` gives a dict."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in _leaves(tree[k])]


def _rebuild(tree, leaves: Iterable[torch.Tensor]):
    """`tree` with its leaves replaced, in `_leaves` order."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        return {k: go(node[k]) for k in sorted(node)}

    return go(tree)


def _crc(tree) -> int:
    """crc32 over the raw bytes of every leaf (bf16 viewed as bytes), in
    `_leaves` order."""
    crc = 0
    for t in _leaves(tree):
        crc = zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8)
                         .numpy(), crc)
    return crc


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of a card, for the tier's device-to-host
    copies (never a kernel: the split-KV kernels' ticket buffers assume
    one stream)."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SIDE_STREAMS:
        _SIDE_STREAMS[i] = torch.cuda.Stream(device=i)
    return _SIDE_STREAMS[i]


class _PinnedArena:
    """Pinned host buffers, reused across spills: pinning is slow (a
    cudaHostAlloc per buffer), so a buffer whose payload was fetched or
    dropped goes back on a free list, guarded by the event after which
    the last copy out of it is done. `take` picks the smallest free buffer
    that fits and pins a new one only when none does; `pinned_bytes` is
    what the tier holds pinned."""

    def __init__(self) -> None:
        self._free: List[Tuple[torch.Tensor, Any]] = []
        self.pinned_bytes = 0

    def take(self, nbytes: int) -> torch.Tensor:
        fits = [i for i, (b, _) in enumerate(self._free)
                if b.numel() >= nbytes]
        if fits:
            i = min(fits, key=lambda j: self._free[j][0].numel())
            buf, ready = self._free.pop(i)
            if ready is not None:
                ready.synchronize()
            return buf
        self.pinned_bytes += nbytes
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, ready=None) -> None:
        self._free.append((buf, ready))


class _HostEntry(NamedTuple):
    payload: Any            # host tree once resident; device tree in flight
    n_blocks: int
    nbytes: int
    resident: bool
    checksum: int           # crc32 over the leaves (0 in flight)
    buf: Any = None         # the pinned buffer the host tree views (card)
    copy: Any = None        # in flight on the card: (host tree, start, landed)


class HostTier:
    """Host-RAM block tier under the device pool (as
    `repro.core.paging.HostTier`: the same census, capacity refusal,
    handles, fault injection and `stats` keys). Entries are whole payload
    trees (a `gather_pool_blocks` dict, or a slot snapshot wrapping one)
    keyed by a monotonic handle, never the device block id, which is
    freed at spill time and re-granted.

    The spill is asynchronous. On the card `begin_spill` takes the fresh
    device gather (enqueued on the main stream behind the step in
    flight), records an event after it on the current stream, and on the
    card's side stream waits for that event and copies every leaf into a
    pinned host buffer (`non_blocking`), recording a "landed" event; the
    entry holds the gathered tensors until then. `drain()`, one engine
    iteration later, waits on each landed event (not on the device) and
    checksums the host bytes. `fetch` of an entry still in flight drains
    on demand (the stall is timed). A fetched payload is the pinned host
    tree: `upload` copies it to the device on the main stream and only
    then returns its buffer to the arena. On the CPU the payload is a
    host copy already, and `drain` just checksums a clone of it.

    `capacity_blocks` bounds the tier in device-block units (a snapshot's
    metadata rides along free). `fault_plan` takes `FaultPlan`'s fetch
    fields. `d2h_seconds` / `h2d_seconds` sum the copies' device times
    (card events), `pinned_bytes` what the arena pins. `tracer` gets the
    instants `spill`, `spill_refused`, `spill_drain`, `fetch`,
    `fetch_refused` and `tier_drop`, with host values only:
    `spill_drain`'s `landed` counts the entries whose events the host
    waited on, and no event or tensor is queried to fill an argument."""

    def __init__(self, capacity_blocks: int, *,
                 fault_plan: Optional[FaultPlan] = None, tracer=None):
        if capacity_blocks < 1:
            raise ValueError(f"need >= 1 host block, got {capacity_blocks}")
        self.capacity_blocks = capacity_blocks
        self.fault_plan = fault_plan
        self.trace = tracer if tracer is not None else NULL_TRACER
        self._entries: Dict[int, _HostEntry] = {}
        self._pending: List[int] = []
        self._next = itertools.count()
        self._arena = _PinnedArena()
        self._lent: Dict[int, torch.Tensor] = {}   # id(payload) -> buffer
        self._uploads: List[Tuple[Any, Any]] = []  # (start, end) events
        self.d2h_seconds = 0.0
        self.fetch_calls = 0
        self._fetch_rng = (random.Random(fault_plan.seed + 1)
                           if fault_plan is not None else None)
        self.stats: Dict[str, Any] = dict(
            spills=0, fetches=0, drops=0,
            bytes_spilled=0, bytes_fetched=0, fetch_stall_s=0.0,
            refused_spills=0, refused_fetches=0, delayed_fetches=0)

    # -- census ----------------------------------------------------------
    @property
    def used_blocks(self) -> int:
        return sum(e.n_blocks for e in self._entries.values())

    @property
    def resident_blocks(self) -> int:
        return sum(e.n_blocks for e in self._entries.values() if e.resident)

    @property
    def in_flight_blocks(self) -> int:
        return sum(e.n_blocks for e in self._entries.values()
                   if not e.resident)

    @property
    def free_blocks(self) -> int:
        return self.capacity_blocks - self.used_blocks

    @property
    def pinned_bytes(self) -> int:
        return self._arena.pinned_bytes

    def handles(self) -> List[int]:
        return list(self._entries)

    def nbytes_of(self, handle: int) -> int:
        return self._entries[handle].nbytes

    # -- spill -----------------------------------------------------------
    def _start_copy(self, payload):
        """Queue the device-to-host copy of a device payload on the side
        stream, behind an event recorded on the current stream. Returns
        (pinned buffer, (host tree, start event, landed event))."""
        leaves = _leaves(payload)
        dev = leaves[0].device
        offs, total = [], 0
        for t in leaves:
            offs.append(total)
            total += -(-t.numel() * t.element_size() // 64) * 64
        buf = self._arena.take(total)
        host = [buf.narrow(0, o, t.numel() * t.element_size())
                .view(t.dtype).view(t.shape) for o, t in zip(offs, leaves)]
        gathered = torch.cuda.Event()
        gathered.record(torch.cuda.current_stream(dev))
        side = _side_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        landed = torch.cuda.Event(enable_timing=True)
        side.wait_event(gathered)
        with torch.cuda.stream(side):
            start.record(side)
            for h, t in zip(host, leaves):
                h.copy_(t, non_blocking=True)
                # an entry dropped in flight frees the gather early: the
                # allocator must not hand its memory out before this copy
                t.record_stream(side)
            landed.record(side)
        return buf, (_rebuild(payload, host), start, landed)

    def begin_spill(self, payload: Any, n_blocks: int) -> Optional[int]:
        """Adopt a device gather; returns the handle, or None when the
        tier is full (the caller falls down the ladder). No host sync:
        sizes come from the tensors' metadata."""
        if n_blocks > self.free_blocks:
            self.stats["refused_spills"] += 1
            if self.trace:
                self.trace.instant("spill_refused",
                                   args=dict(blocks=n_blocks,
                                             host_free=self.free_blocks))
            return None
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(payload))
        h = next(self._next)
        buf = copy = None
        if any(t.is_cuda for t in _leaves(payload)):
            buf, copy = self._start_copy(payload)
        self._entries[h] = _HostEntry(payload, n_blocks, nbytes, False, 0,
                                      buf, copy)
        self._pending.append(h)
        self.stats["spills"] += 1
        self.stats["bytes_spilled"] += nbytes
        if self.trace:
            self.trace.instant("spill", args=dict(handle=h, blocks=n_blocks,
                                                  bytes=nbytes))
        return h

    def drain(self) -> int:
        """Complete pending spills: wait for each landed event (card) and
        checksum the host bytes. Called one engine iteration after
        `begin_spill` and once at teardown. Returns the entries landed."""
        landed = 0
        for h in self._pending:
            e = self._entries.get(h)
            if e is None or e.resident:      # dropped or already fetched
                continue
            if e.copy is not None:
                host, start, end = e.copy
                end.synchronize()
                self.d2h_seconds += start.elapsed_time(end) / 1e3
            else:
                host = _rebuild(e.payload, [t.detach().clone()
                                            for t in _leaves(e.payload)])
            self._entries[h] = e._replace(payload=host, resident=True,
                                          checksum=_crc(host), copy=None)
            landed += 1
        self._pending = []
        if landed and self.trace:
            self.trace.instant("spill_drain", args=dict(landed=landed))
        return landed

    def prefetch(self, handle: int) -> None:
        """Make `handle` resident ahead of its fetch, so the fetch-time
        stall is zero (the queue head's ticket is the one caller)."""
        if handle in self._entries and not self._entries[handle].resident:
            self.drain()

    # -- fetch -----------------------------------------------------------
    def _inject_fetch_fault(self, call_idx: int) -> Tuple[bool, bool]:
        """(refused, delayed) for this fetch call."""
        plan = self.fault_plan
        if plan is None:
            return False, False
        delayed = call_idx in plan.delay_fetches
        if (plan.max_fetch_failures is not None
                and self.stats["refused_fetches"] >= plan.max_fetch_failures):
            return False, delayed
        r = (self._fetch_rng.random()
             if plan.fetch_fail_rate > 0.0 else 1.0)
        refused = (call_idx in plan.fail_fetches
                   or r < plan.fetch_fail_rate)
        return refused, delayed

    def _recycle(self, e: _HostEntry) -> None:
        """Return a discarded entry's pinned buffer; one still in flight
        is reused only after its copy has landed."""
        if e.buf is not None:
            self._arena.give(e.buf, e.copy[2] if e.copy is not None
                             else None)

    def fetch(self, handle: int) -> Optional[Tuple[Any, int, float]]:
        """Pop entry `handle` and return ``(payload, nbytes, stall_s)``:
        the host tree, for `upload`. None on an injected fetch refusal
        (the entry is dropped: the bytes are gone, the caller
        recomputes). Verifies the entry's checksum against spill time."""
        call_idx = self.fetch_calls
        self.fetch_calls += 1
        e = self._entries.get(handle)
        if e is None:
            raise KeyError(f"host tier has no entry {handle}")
        refused, delayed = self._inject_fetch_fault(call_idx)
        if refused:
            del self._entries[handle]
            self._recycle(e)
            self.stats["refused_fetches"] += 1
            if self.trace:
                self.trace.instant("fetch_refused", args=dict(handle=handle))
            return None
        stall = 0.0
        if not e.resident:
            t0 = time.perf_counter()
            self.drain()
            stall = time.perf_counter() - t0
            e = self._entries[handle]
        if delayed:
            stall += self.fault_plan.fetch_delay_s
            self.stats["delayed_fetches"] += 1
        crc = _crc(e.payload)
        if crc != e.checksum:
            raise PoolAuditError(
                f"host tier entry {handle} corrupted: checksum "
                f"{crc:#x} != spill-time {e.checksum:#x}")
        del self._entries[handle]
        if e.buf is not None:
            self._lent[id(e.payload)] = e.buf
        self.stats["fetches"] += 1
        self.stats["bytes_fetched"] += e.nbytes
        self.stats["fetch_stall_s"] += stall
        if self.trace:
            self.trace.instant("fetch",
                               args=dict(handle=handle, blocks=e.n_blocks,
                                         bytes=e.nbytes,
                                         stall_ms=round(stall * 1e3, 3)))
        return e.payload, e.nbytes, stall

    def upload(self, payload, device: torch.device):
        """A fetched payload on `device`: on the card, non-blocking copies
        from pinned memory on the current (main) stream; the pinned buffer
        returns to the arena behind an event recorded after them, so it
        is never rewritten before they complete. On the CPU the payload
        itself."""
        buf = self._lent.pop(id(payload), None)
        if torch.device(device).type != "cuda":
            return payload
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = _rebuild(payload, [t.to(device, non_blocking=True)
                                 for t in _leaves(payload)])
        end.record()
        if buf is not None:
            self._arena.give(buf, end)
        self._uploads.append((start, end))
        return out

    @property
    def h2d_seconds(self) -> float:
        """Device time of every `upload` so far (waits for the last)."""
        total = 0.0
        for start, end in self._uploads:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total

    def drop(self, handle: int) -> None:
        """Discard entry `handle` without fetching (its holder is gone)."""
        e = self._entries.pop(handle, None)
        if e is not None:
            self._recycle(e)
            self.stats["drops"] += 1
            if self.trace:
                self.trace.instant("tier_drop", args=dict(handle=handle))

    def verify(self) -> List[int]:
        """Re-checksum every resident entry; the mismatched handles (audit
        hook — consumes nothing)."""
        return [h for h, e in sorted(self._entries.items())
                if e.resident and _crc(e.payload) != e.checksum]


def audit_pool(allocator: BlockAllocator,
               slot_blocks: Mapping[int, Sequence[int]],
               index_blocks: Iterable[int] = (), *,
               block_tbl=None, tbl_slots=None,
               host_tier: Optional[HostTier] = None,
               tier_holders: Iterable[int] = ()) -> Dict[str, object]:
    """Cross-check the allocator against every holder (`slot_blocks`:
    slot -> table-order grant list; `index_blocks`: the prefix index's
    resident ids, one reference each): each block is free or held by
    exactly `refcount` holders — no leaks, no double maps, no skew.

    `block_tbl` (host array ``[..., B, n_max]``, layer dims leading) adds
    the table check: each slot of `tbl_slots` (default all holders) maps
    exactly its grant list, identically in every layer copy.

    `host_tier` / `tier_holders` add the host census: every holder handle
    (the index's host nodes, queued continuations' tickets) names a live
    entry, every entry is named by exactly one holder (an unnamed one is
    a host leak), the tier is within capacity, and every resident entry
    still matches its spill-time checksum. Returns a report dict; raises
    `PoolAuditError` listing every violation."""
    problems: List[str] = []
    free = allocator.free_ids()
    refs = allocator.refcounts()
    free_set = set(free)
    all_ids = set(range(allocator.n_blocks))

    if len(free) != len(free_set):
        problems.append("free list holds duplicate ids")
    if not free_set <= all_ids:
        problems.append(f"free list ids out of range: "
                        f"{sorted(free_set - all_ids)}")
    overlap = free_set & set(refs)
    if overlap:
        problems.append(f"ids both free and allocated: {sorted(overlap)}")
    lost = sorted(all_ids - free_set - set(refs))
    if lost:
        problems.append(f"ids neither free nor allocated (lost): {lost}")

    holders: Dict[int, int] = {}
    double_mapped: List[int] = []
    for slot, ids in sorted(slot_blocks.items()):
        seen = set()
        for i in ids:
            if i in seen:
                double_mapped.append(i)
                problems.append(f"slot {slot} maps block {i} twice")
            seen.add(i)
            if i in free_set:
                double_mapped.append(i)
                problems.append(f"slot {slot} maps freed block {i}")
            holders[i] = holders.get(i, 0) + 1
    for i in index_blocks:
        holders[i] = holders.get(i, 0) + 1

    leaked = sorted(i for i in refs if holders.get(i, 0) == 0)
    for i in leaked:
        problems.append(f"block {i} allocated (refs={refs[i]}) but held "
                        "by no slot and no index entry (leak)")
    skewed: List[int] = []
    for i, n_hold in sorted(holders.items()):
        if refs.get(i, 0) != n_hold:
            skewed.append(i)
            problems.append(f"block {i} refcount skew: allocator="
                            f"{refs.get(i, 0)} holders={n_hold}")
    for i, r in sorted(refs.items()):
        if r <= 0:
            skewed.append(i)
            problems.append(f"block {i} has nonpositive refcount {r}")

    if block_tbl is not None:
        import numpy as np
        tbl = np.asarray(block_tbl)
        tbl = tbl.reshape(-1, *tbl.shape[-2:])          # [L, B, n_max]
        if not (tbl == tbl[:1]).all():
            problems.append("block table layer copies diverge")
        check = (set(slot_blocks) if tbl_slots is None
                 else set(tbl_slots) & set(slot_blocks))
        for slot in sorted(check):
            mapped = [int(b) for b in tbl[0, slot] if b >= 0]
            if mapped != list(slot_blocks[slot]):
                problems.append(f"slot {slot} device table {mapped} != "
                                f"grant list {list(slot_blocks[slot])}")

    host_resident = host_in_flight = host_entries = 0
    if host_tier is not None:
        held: Dict[int, int] = {}
        for h in tier_holders:
            held[h] = held.get(h, 0) + 1
        live = set(host_tier.handles())
        for h, n in sorted(held.items()):
            if h not in live:
                problems.append(f"tier holder names dead entry {h}")
            elif n > 1:
                problems.append(f"tier entry {h} claimed by {n} holders")
        for h in sorted(live - set(held)):
            problems.append(f"host entry {h} held by no index node and "
                            "no queued ticket (host leak)")
        if host_tier.used_blocks > host_tier.capacity_blocks:
            problems.append(
                f"host tier over capacity: {host_tier.used_blocks} > "
                f"{host_tier.capacity_blocks}")
        for h in host_tier.verify():
            problems.append(f"host entry {h} bytes differ from spill "
                            "time (checksum mismatch)")
        host_resident = host_tier.resident_blocks
        host_in_flight = host_tier.in_flight_blocks
        host_entries = len(live)

    report: Dict[str, object] = dict(
        n_blocks=allocator.n_blocks, free=len(free), allocated=len(refs),
        holders=sum(holders.values()), leaked=leaked,
        double_mapped=sorted(set(double_mapped)), skewed=sorted(set(skewed)),
        lost=lost, host_resident=host_resident,
        host_in_flight=host_in_flight, host_entries=host_entries,
        clean=not problems)
    if problems:
        raise PoolAuditError("pool audit failed:\n  "
                             + "\n  ".join(problems))
    return report


# ---------------------------------------------------------------------------
# Block-count arithmetic (host side)
# ---------------------------------------------------------------------------


def blocks_for_len(n_rows: int, block_len: int) -> int:
    return -(-n_rows // block_len)


def request_blocks_prefix(spec: CacheSpec, S: int, rows_streamed: int,
                          block_len: int) -> int:
    """Chunk-wise grant schedule of a chunked admission: blocks covering
    the prompt rows streamed so far (quantized: rounded up to a group).
    Monotone and bounded by `request_blocks`; the engine tops up to the
    full grant before the insert."""
    rows = rows_streamed
    if spec.quantized:
        G = spec.group
        rows = -(-rows // G) * G
    return blocks_for_len(min(S, max(rows, 1)), block_len)


def request_blocks(spec: CacheSpec, S: int, prompt_len: int, max_new: int,
                   block_len: int) -> int:
    """Blocks covering every row a request admitted at `prompt_len` with
    `max_new` decode headroom can touch. Quantized stores flush whole
    groups at group-aligned slots: round up and add one group of slack;
    everything clamps at the physical store length S."""
    rows = prompt_len + max_new
    if spec.quantized:
        G = spec.group
        rows = -(-rows // G) * G + G
    return blocks_for_len(min(S, rows), block_len)


# ---------------------------------------------------------------------------
# Pressure-driven budget degradation (quantized streaming slots)
# ---------------------------------------------------------------------------


def degrade_slot_groups(stacked: PagedLayerKV, spec: CacheSpec,
                        slot_idx: int, n_drop, *,
                        batch_axis: int = 1) -> PagedLayerKV:
    """Quality-reversible pressure eviction of one resident quantized
    streaming slot, in place (as `repro.core.paging.degrade_slot_groups`):
    drop its `n_drop` oldest fully flushed non-sink groups and compact
    its table row, scores, slot positions and length. Block == group in
    a quantized pool, so a drop is a table permutation and no pool data
    moves; the slot regrows one group per window of appends once
    pressure clears.

    Storage group 0 (the sinks) is kept, ages come from `slot_pos`, and
    the partial tail group and rows past `length` are never touched.
    Needs uniform per-layer lengths (the engine checks its host mirror):
    the layer-replicated table row takes one permutation. The dropped ids
    fall off the row's tail, and the drop block is never mapped by a
    kept entry. Every step runs on the device (no host sync); the engine
    reads the new row to release the dropped ids. Both sorts are stable,
    as JAX's `argsort` is."""
    G = spec.group
    if not (spec.quantized and G > 0):
        raise ValueError("degradation needs a grouped ring store")
    tbl = stacked.block_tbl
    n_max = tbl.shape[-1]
    row_v = tbl.select(batch_axis, slot_idx)                  # [..., n_max]
    sp_v = stacked.slot_pos.select(batch_axis, slot_idx)      # [..., S]
    sc_v = stacked.scores.select(batch_axis, slot_idx)
    ln_v = stacked.length.select(batch_axis, slot_idx)        # [...]
    S = sp_v.shape[-1]
    row = row_v.reshape(-1, n_max)                            # [L, n_max]
    sp = sp_v.reshape(-1, S)
    sc = sc_v.reshape(-1, S)
    ln = ln_v.reshape(-1)
    L, dev = sp.shape[0], sp.device
    length = ln.min()                        # uniform across layers (gated)
    full_groups = length // G                # fully flushed prefix groups
    n_drop = torch.clamp(torch.as_tensor(n_drop, device=dev), min=0)
    n_drop = torch.minimum(n_drop, torch.clamp(full_groups - 1, min=0))

    ages = sp.reshape(L, n_max, G).amax(dim=(0, 2))           # [n_max]
    idx = torch.arange(n_max, device=dev)
    cand = (idx >= 1) & (idx < full_groups)  # non-sink, fully flushed
    key = torch.where(cand, ages, torch.iinfo(torch.int32).max)
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    drop = cand & (rank < n_drop)
    # stable compaction: kept entries keep their order, dropped go last
    perm = torch.argsort(torch.where(drop, n_max, 0) + idx, stable=True)
    kept = idx < n_max - n_drop

    new_row = torch.where(kept, row[:, perm], -1)

    def compact(rows, fill):                  # [L, S] -> [L, S]
        x = rows.reshape(L, n_max, G)[:, perm]
        x = torch.where(kept[None, :, None], x, fill)
        return x.reshape(L, n_max * G)

    new_sc, new_sp = compact(sc, 0.0), compact(sp, -1)
    new_ln = ln - n_drop * G
    row_v.copy_(new_row.reshape(row_v.shape))
    sc_v.copy_(new_sc.reshape(sc_v.shape))
    sp_v.copy_(new_sp.reshape(sp_v.shape))
    ln_v.copy_(new_ln.reshape(ln_v.shape))
    return stacked


# ---------------------------------------------------------------------------
# Bytes accounting
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pool_bytes(p: PagedLayerKV) -> int:
    """Reserved bytes of the block pools (all layers, drop block too)."""
    return sum(_nbytes(getattr(p, f)) for f in POOL_FIELDS)


def bytes_per_block(p: PagedLayerKV) -> int:
    """Physical bytes one block id pins across every layer's pools."""
    return pool_bytes(p) // p.pk.shape[-4]


def mapped_blocks(p: PagedLayerKV) -> int:
    """Distinct pool blocks mapped by any slot (reads the table: a host
    sync). Tables are replicated per layer; count one copy."""
    tbl = p.block_tbl.reshape(-1, *p.block_tbl.shape[-2:])[0]
    return int(torch.unique(tbl[tbl >= 0]).numel())


def block_fp16_bytes(p: PagedLayerKV, spec: CacheSpec) -> int:
    """Bytes one block would cost to move as fp16 across every layer: the
    uncompressed-offload baseline of the tier's bytes moved. A quantized
    pool packs `8 // bits` codes per int8 lane. Per grantable block, as
    the JAX package counts it (its pools have no drop block)."""
    factor = 8 // spec.bits if spec.quantized else 1
    return (p.pk.numel() + p.pv.numel()) * factor // p.pk.shape[-4] * 2


def paged_physical_bytes(p: PagedLayerKV) -> int:
    """Mapped-block bytes + metadata bytes (see
    `cache.cache_physical_bytes`)."""
    meta = sum(_nbytes(t) for t in p) - pool_bytes(p)
    return meta + mapped_blocks(p) * bytes_per_block(p)
