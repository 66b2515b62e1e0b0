"""Paged block-table KV cache: one physical pool per layer shared across
slots (counterpart of `repro.core.paging`, eager block growth).

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

Not ported yet: `FaultPlan`, `HostTier`, `degrade_slot_groups`, the
pool-block gather / scatter of tiering, and lazy block growth.
"""
from __future__ import annotations

import warnings
from typing import (Dict, Iterable, List, Mapping, NamedTuple, Optional,
                    Sequence)

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, LayerKV
from repro_torch.kernels.decode_qattn.ref import gather_pool

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
                       use_kernels: bool = True) -> PagedLayerKV:
    """Paged twin of `cache.append_token`: the same eviction / ring-flush
    semantics (shared planning helpers), K/V writes routed through the
    block table. `ring_full`, `mask` and `use_kernels` as in
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
    slot = torch.where(full, kvcache.select_victim(p, spec), p.length)
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


class PoolAuditError(AssertionError):
    """A pool invariant audit failed; the message lists every violation."""


class BlockAllocator:
    """Refcounted free list over the shared block-id space; one id
    reserves the same row of every layer's pools. `alloc` is
    all-or-nothing: a request that does not fit leaves the pool
    untouched (admission refusal). `incref` adds a holder (the prefix
    index, a slot adopting a shared block); `free` drops one reference
    and recycles the block with its last. Freeing or increfing a block
    that is not allocated raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need >= 1 block, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self.peak_used = 0

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

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
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


def audit_pool(allocator: BlockAllocator,
               slot_blocks: Mapping[int, Sequence[int]],
               index_blocks: Iterable[int] = (), *,
               block_tbl=None, tbl_slots=None) -> Dict[str, object]:
    """Cross-check the allocator against every holder (`slot_blocks`:
    slot -> table-order grant list; `index_blocks`: the prefix index's
    resident ids, one reference each): each block is free or held by
    exactly `refcount` holders — no leaks, no double maps, no skew.

    `block_tbl` (host array ``[..., B, n_max]``, layer dims leading) adds
    the table check: each slot of `tbl_slots` (default all holders) maps
    exactly its grant list, identically in every layer copy. Returns a
    report dict; raises `PoolAuditError` listing every violation."""
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

    report: Dict[str, object] = dict(
        n_blocks=allocator.n_blocks, free=len(free), allocated=len(refs),
        holders=sum(holders.values()), leaked=leaked,
        double_mapped=sorted(set(double_mapped)), skewed=sorted(set(skewed)),
        lost=lost, clean=not problems)
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


def paged_physical_bytes(p: PagedLayerKV) -> int:
    """Mapped-block bytes + metadata bytes (see
    `cache.cache_physical_bytes`)."""
    meta = sum(_nbytes(t) for t in p) - pool_bytes(p)
    return meta + mapped_blocks(p) * bytes_per_block(p)
