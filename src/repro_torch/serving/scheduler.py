"""Continuous-batching request lifecycle: queue, slots, block grants,
accounting (the dense, paged and chunked-admission parts of
`repro.serving.scheduler`, which the port cannot import without
importing the JAX engine).

The survey frames compression as a *serving* problem — bytes per sequence
bound how many sequences fit, and only a scheduler that reclaims freed
memory converts that into throughput (arXiv:2503.24000). This module is
the pure-Python half of that scheduler: a bucketed FIFO queue folded into
a `Scheduler` that tracks which request occupies which batch slot,
detects EOS / max-new completion, and accounts per-request latency
(TTFT, per-token) plus fleet-level slot occupancy.

No device code here: the `Engine` owns all device state (persistent
slots-wide cache, per-bucket prefill, the decode step) and drives this
class — which makes the lifecycle unit-testable with a fake clock.
Prefix sharing adds the `reclaim` hook (one retry of a refused
allocation after the prefix index drops lingering blocks),
`adopt_blocks` and `cow_swap`. The overload ladder adds `preempt` /
`preempt_victim` (a preempted request requeues at the front as a
continuation that carries its emitted tokens), `release_blocks` (lazy
growth's rollback) and the shortest-prompt admission order. Tiering adds
the host-tier accounting (`note_swap`, `queued_tickets`, a queued
continuation's `tier_ticket`) and the tier-aware second reclaim pass
(`spillable`); degradation adds `replace_blocks`.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

_uid_counter = itertools.count()


@dataclass
class Request:
    """One generation request. `tokens` is the prompt (1-D int32) and must
    be exactly one of the scheduler's bucket lengths — callers pad
    upstream (each bucket is one prefill shape)."""

    tokens: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    uid: int = field(default_factory=lambda: next(_uid_counter))
    # continuation state (preemption with recompute-on-resume): tokens
    # emitted before a preemption ride the requeue; on re-admission the
    # engine re-prefills the prompt and replays them through the decode
    # path (outputs discarded), so the resumed stream equals an
    # unpreempted one. Their timestamps and the true first-token time
    # ride along for TTFT and per-token accounting.
    emitted_prefix: List[int] = field(default_factory=list)
    token_times_prefix: List[float] = field(default_factory=list)
    t_first_prefix: float = 0.0
    n_preemptions: int = 0
    n_retries: int = 0            # admission attempts refused by the pool
    # host-tier state (spill-to-host preemption): a preemption that
    # spilled the slot's cache carries its `HostTier` handle here; on
    # re-admission the engine fetches and restores instead of replaying.
    # `tier_blocks` is the block count the snapshot covers. The ticket is
    # attached only while the request is queued (the audit's holder
    # census is queued tickets + the index's host nodes).
    tier_ticket: Optional[int] = None
    tier_blocks: int = 0
    # swap accounting, accumulated across preempt / resume round trips
    n_spills: int = 0
    n_fetches: int = 0
    bytes_moved: int = 0
    fetch_stall_s: float = 0.0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {self.tokens.shape}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")

    @property
    def remaining_new(self) -> int:
        """Decode tokens still owed (max_new minus the carried prefix)."""
        return self.max_new - len(self.emitted_prefix)


@dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # [n_emitted] generated (EOS included)
    prompt_len: int
    bucket: int
    slot: int                     # -1: failed before ever holding a slot
    finish_reason: str            # "eos" | "length" | "failed"
    ttft_s: float                 # submit -> first token (0.0 if failed)
    total_s: float                # submit -> retirement
    decode_s: float               # first token -> retirement
    token_times: np.ndarray = field(  # [n_emitted] clock at each token —
        default_factory=lambda: np.zeros(0))  # inter-token stall analysis
    n_preemptions: int = 0        # times the request was preempted / resumed
    n_retries: int = 0            # admission attempts refused by the pool
    n_spills: int = 0             # blocks spilled to the host tier
    n_fetches: int = 0            # blocks fetched back to the device
    bytes_moved: int = 0          # device <-> host transport, both ways
    fetch_stall_s: float = 0.0    # decode-blocking fetch wait
    queue_s: float = 0.0          # submit -> first admission (a resumed
                                  # request keeps its first wait; 0.0 if
                                  # never admitted)

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    def max_inter_token_s(self, t0: float = -np.inf,
                          t1: float = np.inf) -> float:
        """Largest gap between consecutive token timestamps whose later
        token lands in [t0, t1]: the per-request stall that chunked
        admission exists to bound."""
        tt = self.token_times
        if tt.shape[0] < 2:
            return 0.0
        gaps = np.diff(tt)
        sel = (tt[1:] >= t0) & (tt[1:] <= t1)
        return float(gaps[sel].max()) if sel.any() else 0.0


@dataclass
class _SlotState:
    req: Request
    bucket: int
    t_submit: float
    t_admit: float
    t_first: float = 0.0
    emitted: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)   # paged-pool block ids
    prefilling: bool = False      # chunked admission in flight: occupied,
                                  # not yet decoding (no tokens yet)
    seq: int = -1                 # admission order (victim tie-break)
    n_spills: int = 0             # swap accounting of this residency
    n_fetches: int = 0
    bytes_moved: int = 0
    fetch_stall_s: float = 0.0


class Scheduler:
    """Per-slot request lifecycle for a `slots`-wide persistent cache.

    QUEUED -> (admit_next) ACTIVE -> (record_token x N) -> (retire) DONE.
    The engine calls `admit_next` whenever a slot is free, feeds every
    sampled token through `record_token` (which returns a finish reason
    once EOS or the request's max_new is hit), then `retire`s the slot —
    freeing it for the next queued request immediately, mid-decode.

    **Chunked admission** inserts a PREFILLING stage: QUEUED ->
    (begin_prefill) PREFILLING -> (grant_blocks x chunks, paged) ->
    (finish_prefill) ACTIVE -> ... The slot is occupied but takes no
    decode steps; TTFT still clocks at the real first token. A request
    that can never be served is retired from the queue head with
    `fail_head` ("failed").

    **Block-aware admission** (paged cache): pass `allocator` (with
    `alloc(n) -> list | None` / `free(ids)`, e.g.
    `core.paging.BlockAllocator`) and `block_need(req) -> int`. A request
    is admitted only when the allocator covers its budgeted length;
    otherwise `admit_next` returns None and it stays at the head of the
    queue (FIFO head-of-line). `retire` frees the slot's blocks through
    `release`, the one seam every block returns by. `reclaim` (optional,
    set by the engine under prefix sharing) is called with the shortfall
    when an allocation fails, to drop lingering prefix-index references
    before one retry: resident requests outrank the prompt cache.

    **Preemption** (the overload ladder): `preempt` evicts an ACTIVE
    slot's request back to the queue front as a continuation; the engine
    picks the victim with `preempt_victim`. `admission_order=
    "shortest-prompt"` admits the shortest queued prompt first (ties
    FIFO) instead of the queue front.
    """

    def __init__(self, buckets: Sequence[int], n_slots: int, *,
                 clock: Callable[[], float] = time.perf_counter,
                 allocator=None,
                 block_need: Optional[Callable[[Request], int]] = None,
                 admission_order: str = "fifo",
                 tracer=None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"need positive prompt buckets, got {buckets}")
        if n_slots < 1:
            raise ValueError(f"need >= 1 slot, got {n_slots}")
        if (allocator is None) != (block_need is None):
            raise ValueError("allocator and block_need come together")
        if admission_order not in ("fifo", "shortest-prompt"):
            raise ValueError(f"unknown admission_order {admission_order!r}")
        self.buckets = buckets
        self.n_slots = n_slots
        self.allocator = allocator
        self._block_need = block_need
        self._clock = clock
        self.admission_order = admission_order
        # lifecycle tracing: the scheduler owns every request timestamp,
        # so it emits the request spans — submit / admit / first-token
        # instants, the queued + request complete events at retire.
        # Host values only.
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.reclaim: Optional[Callable[[int], None]] = None
        # tier-aware admission: blocks the engine could demote to the host
        # tier right now (cold refcount-1 prefix nodes with host room).
        # When the first reclaim retry still falls short, `_alloc` asks
        # `reclaim` again: the engine's reclaim spills before it evicts,
        # so the second pass turns cold-but-warm capacity into free blocks
        self.spillable: Optional[Callable[[], int]] = None
        self._queue: Deque[Tuple[Request, float]] = deque()
        self._slots: List[Optional[_SlotState]] = [None] * n_slots
        self.results: List[RequestResult] = []
        self._decode_steps = 0
        self._active_slot_steps = 0
        self._admit_seq = itertools.count()
        self.n_preemptions = 0        # fleet totals (per-request counts
        self.n_retries = 0            # land on RequestResult)
        self.n_spills = 0
        self.n_fetches = 0
        self.bytes_moved = 0
        self.fetch_stall_s = 0.0
        # uid -> its first admission's queue wait (t_admit - t_submit, on
        # this scheduler's clock); a resumed request keeps its first wait
        self._queue_s: dict = {}

    def _head_idx(self) -> int:
        """Queue index the next admission takes. FIFO: the front.
        shortest-prompt: the shortest queued prompt (ties FIFO), so a
        short request can jump a long one; long prompts still drain, since
        every admission re-evaluates."""
        if self.admission_order == "fifo" or len(self._queue) <= 1:
            return 0
        return min(range(len(self._queue)),
                   key=lambda i: (len(self._queue[i][0].tokens), i))

    def _pop_head(self) -> Tuple[Request, float]:
        i = self._head_idx()
        item = self._queue[i]
        del self._queue[i]
        return item

    # ---- queue -----------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        if prompt_len in self.buckets:
            return prompt_len
        raise ValueError(
            f"prompt length {prompt_len} matches no bucket {self.buckets}; "
            "pad the prompt to a bucket length")

    def submit(self, req: Request) -> None:
        self.bucket_for(len(req.tokens))    # validate up front
        self._queue.append((req, self._clock()))
        if self.trace:
            self.trace.instant("submit", args=dict(uid=req.uid))

    @property
    def pending(self) -> int:
        return len(self._queue)

    def head_request(self) -> Optional[Request]:
        """The request admission takes next (None when the queue is
        empty): the front, or under shortest-prompt the shortest queued
        prompt."""
        return self._queue[self._head_idx()][0] if self._queue else None

    # ---- slots -----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_slots(self) -> List[int]:
        """Slots decoding (PREFILLING slots are occupied but not active:
        they take no decode steps and emit no tokens yet)."""
        return [i for i, s in enumerate(self._slots)
                if s is not None and not s.prefilling]

    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots)
                if s is not None and s.prefilling]

    def slot_request(self, slot_idx: int) -> Optional[Request]:
        """The request occupying the slot (None when it is free)."""
        st = self._slots[slot_idx]
        return st.req if st is not None else None

    def all_done(self) -> bool:
        return not self._queue and all(s is None for s in self._slots)

    def admit_next(self, slot_idx: int) -> Optional[Request]:
        """Pop the next queued request into a free slot (FIFO). Returns
        None when the queue is empty or (block-aware mode) the allocator
        cannot cover the head request's blocks yet."""
        if self._slots[slot_idx] is not None:
            raise ValueError(f"slot {slot_idx} is occupied")
        if not self._queue:
            return None
        blocks: List[int] = []
        if self.allocator is not None:
            got = self._alloc(self._block_need(self.head_request()))
            if got is None:
                return None            # pool exhausted: wait for a retire
            blocks = got
        req, t_submit = self._pop_head()
        self._slots[slot_idx] = st = _SlotState(
            req, self.bucket_for(len(req.tokens)), t_submit, self._clock(),
            blocks=blocks, seq=next(self._admit_seq))
        self._queue_s.setdefault(req.uid, st.t_admit - t_submit)
        if self.trace:
            self.trace.instant("admit", tid=slot_idx + 1,
                               args=dict(uid=req.uid, slot=slot_idx,
                                         blocks=len(blocks)))
        return req

    def slot_blocks(self, slot_idx: int) -> List[int]:
        """Pool block ids granted to the slot's current request, in table
        order."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        return list(st.blocks)

    def emitted_total(self, slot_idx: int) -> int:
        """Tokens the slot's request has emitted across all residencies
        (the continuation prefix plus this stint)."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        return len(st.req.emitted_prefix) + len(st.emitted)

    # ---- chunked-prefill lifecycle (QUEUED -> PREFILLING -> ACTIVE) ------
    def begin_prefill(self, slot_idx: int) -> Optional[Request]:
        """Pop the head request into a free slot in the PREFILLING state:
        the slot is occupied (it owns its scratch and, paged, its
        chunk-wise grants) but takes no decode steps until
        `finish_prefill`. Nothing is allocated here: the engine paces the
        grants through `grant_blocks`."""
        if self._slots[slot_idx] is not None:
            raise ValueError(f"slot {slot_idx} is occupied")
        if not self._queue:
            return None
        req, t_submit = self._pop_head()
        self._slots[slot_idx] = st = _SlotState(
            req, self.bucket_for(len(req.tokens)), t_submit, self._clock(),
            prefilling=True, seq=next(self._admit_seq))
        self._queue_s.setdefault(req.uid, st.t_admit - t_submit)
        if self.trace:
            self.trace.instant("admit", tid=slot_idx + 1,
                               args=dict(uid=req.uid, slot=slot_idx,
                                         chunked=True))
        return req

    def grant_blocks(self, slot_idx: int, n: int) -> bool:
        """Grant `n` more pool blocks to an occupied slot: chunk-wise
        pacing of a PREFILLING slot, or lazy growth of an ACTIVE one. False
        when the allocator cannot cover them yet (the admission stalls,
        or the engine handles the starved decode)."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if self.allocator is None or n <= 0:
            return True
        got = self._alloc(n)
        if got is None:
            return False
        st.blocks.extend(got)
        return True

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate with one reclaim retry: under pool pressure the
        `reclaim` hook drops lingering prefix-index references first (and,
        with tiering, a second pass demotes what `spillable` counts)."""
        got = self.allocator.alloc(n)
        if got is None and self.reclaim is not None:
            self.reclaim(n - self.allocator.available)
            got = self.allocator.alloc(n)
        if (got is None and self.reclaim is not None
                and self.spillable is not None and self.spillable() > 0):
            self.reclaim(n - self.allocator.available)
            got = self.allocator.alloc(n)
        return got

    def adopt_blocks(self, slot_idx: int, ids: Sequence[int]) -> None:
        """Map already-allocated blocks (a matched prefix from the index)
        into an occupied slot read-only: one reference per id, appended
        to the slot's grant list. Called right after `begin_prefill`,
        before any suffix grant, so table order stays [shared prefix |
        owned suffix]."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if not ids:
            return
        if st.blocks:
            raise ValueError("adopt before any suffix grant")
        self.allocator.incref(ids)
        st.blocks.extend(ids)

    def cow_swap(self, slot_idx: int, n: int
                 ) -> Optional[Tuple[List[int], List[int]]]:
        """Copy-on-write: replace the slot's first `n` (shared) blocks
        with freshly allocated exclusive ids and drop this slot's
        references to the old ones (the index keeps its own). Returns
        (old_ids, new_ids) for the device row copy and table rewrite, or
        None when the pool cannot cover the copies."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if not 0 < n <= len(st.blocks):
            raise ValueError(f"cow_swap of {n} blocks, slot holds "
                             f"{len(st.blocks)}")
        new = self._alloc(n)
        if new is None:
            return None
        old = st.blocks[:n]
        st.blocks[:n] = new
        self.release(slot_idx, old)
        return old, new

    def release(self, slot_idx: int, ids: Sequence[int]) -> None:
        """Single choke point: every block returned to the allocator
        funnels through here, so ownership changes have one auditable
        seam. `slot_idx` is the releasing slot (-1: blocks no slot holds,
        such as the prefix index's)."""
        if self.allocator is None or not ids:
            return
        self.allocator.free(ids)

    def release_blocks(self, slot_idx: int, n: int) -> List[int]:
        """Return the slot's `n` most recently granted blocks to the free
        list (a speculative rollback dropped below a block boundary).
        Grant order is table order, so popping from the tail releases
        exactly the table entries no longer covered; the engine unmaps
        them on the device (`paging.clear_block_table_from`) before the
        ids can be granted again. Returns the freed ids."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if self.allocator is None or n <= 0:
            return []
        if n > len(st.blocks):
            raise ValueError(f"release of {n} blocks, slot holds "
                             f"{len(st.blocks)}")
        freed = st.blocks[len(st.blocks) - n:]
        del st.blocks[len(st.blocks) - n:]
        self.release(slot_idx, freed)
        return freed

    def finish_prefill(self, slot_idx: int) -> None:
        """PREFILLING -> ACTIVE: the admission's cache is inserted and
        the request starts decoding (TTFT clocks at the first
        `record_token`, the real first token)."""
        st = self._slots[slot_idx]
        if st is None or not st.prefilling:
            raise ValueError(f"slot {slot_idx} is not prefilling")
        st.prefilling = False

    # ---- token stream ----------------------------------------------------
    def record_token(self, slot_idx: int, token: int) -> Optional[str]:
        """Append one sampled token; returns the finish reason ("eos" |
        "length") when this token completes the request, else None."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if st.prefilling:
            raise ValueError(f"slot {slot_idx} is still prefilling")
        token = int(token)
        now = self._clock()
        if not st.emitted:
            st.t_first = now
            if self.trace and not st.req.emitted_prefix:
                self.trace.instant("first_token", tid=slot_idx + 1,
                                   args=dict(uid=st.req.uid))
        st.emitted.append(token)
        st.token_times.append(now)
        if st.req.eos_id is not None and token == st.req.eos_id:
            return "eos"
        if len(st.req.emitted_prefix) + len(st.emitted) >= st.req.max_new:
            return "length"
        return None

    def retire(self, slot_idx: int, reason: str) -> RequestResult:
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        self._slots[slot_idx] = None
        self.release(slot_idx, st.blocks)      # freed capacity is reusable
        now = self._clock()
        req = st.req
        # a resumed request carries its pre-preemption tokens, their
        # timestamps and the true first-token time: the result merges
        # them with this stint's stream
        tokens = req.emitted_prefix + st.emitted
        times = req.token_times_prefix + st.token_times
        t_first = req.t_first_prefix if req.emitted_prefix else st.t_first
        res = RequestResult(
            uid=req.uid,
            tokens=np.asarray(tokens, np.int32),
            prompt_len=len(req.tokens),
            bucket=st.bucket,
            slot=slot_idx,
            finish_reason=reason,
            # a slot retired before its first token has no t_first
            ttft_s=(t_first - st.t_submit) if tokens else 0.0,
            total_s=now - st.t_submit,
            decode_s=(now - t_first) if tokens else 0.0,
            token_times=np.asarray(times, np.float64),
            n_preemptions=req.n_preemptions,
            n_retries=req.n_retries,
            n_spills=req.n_spills + st.n_spills,
            n_fetches=req.n_fetches + st.n_fetches,
            bytes_moved=req.bytes_moved + st.bytes_moved,
            fetch_stall_s=req.fetch_stall_s + st.fetch_stall_s,
            queue_s=self._queue_s[req.uid],
        )
        self.results.append(res)
        if self.trace:
            # the request's slot residency as one complete span, plus
            # its queue wait — timestamps are this scheduler's clock
            if st.t_admit > st.t_submit:
                self.trace.complete("queued", st.t_submit, st.t_admit,
                                    tid=slot_idx + 1,
                                    args=dict(uid=req.uid))
            self.trace.complete(
                "request", st.t_admit, now, tid=slot_idx + 1,
                args=dict(uid=req.uid, reason=reason,
                          tokens=len(tokens),
                          preemptions=req.n_preemptions))
        return res

    # ---- preemption (the overload ladder: spill -> degrade -> preempt ->
    # fail) -------------------------------------------------------------
    def preempt(self, slot_idx: int) -> Request:
        """Evict an ACTIVE slot's request and requeue it at the queue
        front as a continuation: its blocks go back through `release`,
        its emitted tokens (with their timestamps and the first-token
        time) fold into the request's continuation prefix, and the
        original submit time rides along. On re-admission the engine
        re-prefills the prompt and replays the prefix through the decode
        path."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        if st.prefilling:
            raise ValueError(f"slot {slot_idx} is prefilling; cancel the "
                             "admission instead of preempting it")
        self._slots[slot_idx] = None
        self.release(slot_idx, st.blocks)
        req = st.req
        if st.emitted and not req.emitted_prefix:
            req.t_first_prefix = st.t_first
        req.emitted_prefix.extend(st.emitted)
        req.token_times_prefix.extend(st.token_times)
        req.n_preemptions += 1
        self.n_preemptions += 1
        # swap accounting survives the requeue on the request, like the
        # emitted prefix; the next residency starts its own slot counts
        req.n_spills += st.n_spills
        req.n_fetches += st.n_fetches
        req.bytes_moved += st.bytes_moved
        req.fetch_stall_s += st.fetch_stall_s
        self._queue.appendleft((req, st.t_submit))
        if self.trace:
            self.trace.instant("preempt", tid=slot_idx + 1,
                               args=dict(uid=req.uid, slot=slot_idx,
                                         emitted=len(req.emitted_prefix)))
        return req

    def preempt_victim(self, exclude: Sequence[int] = ()) -> Optional[int]:
        """Victim policy: the ACTIVE slot with the lowest progress fraction
        (emitted / max_new, continuation prefix included), the least sunk
        recompute, ties broken youngest-admitted first so an old request
        under repeated pressure still converges."""
        best = None
        for i, st in enumerate(self._slots):
            if st is None or st.prefilling or i in exclude:
                continue
            done = len(st.req.emitted_prefix) + len(st.emitted)
            key = (done / max(st.req.max_new, 1), -st.seq, i)
            if best is None or key < best[0]:
                best = (key, i)
        return best[1] if best is not None else None

    def note_swap(self, slot_idx: int, *, spills: int = 0, fetches: int = 0,
                  bytes_moved: int = 0, stall_s: float = 0.0) -> None:
        """Account a spill or fetch against a slot's request and the fleet
        totals. `slot_idx=-1` charges the fleet only (prefix-index
        demotions and promotions move blocks no resident request owns)."""
        self.n_spills += spills
        self.n_fetches += fetches
        self.bytes_moved += bytes_moved
        self.fetch_stall_s += stall_s
        if slot_idx < 0:
            return
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        st.n_spills += spills
        st.n_fetches += fetches
        st.bytes_moved += bytes_moved
        st.fetch_stall_s += stall_s

    def queued_tickets(self) -> List[int]:
        """Host-tier handles held by queued continuations (audit input: a
        ticket is attached only while its request waits in the queue)."""
        return [req.tier_ticket for req, _ in self._queue
                if req.tier_ticket is not None]

    def note_retry(self) -> int:
        """An admission attempt for the head request was refused by the
        pool: count it on the request. Returns its retries so far (0 when
        the queue is empty)."""
        req = self.head_request()
        if req is None:
            return 0
        req.n_retries += 1
        self.n_retries += 1
        return req.n_retries

    def replace_blocks(self, slot_idx: int, keep_ids: Sequence[int]
                       ) -> List[int]:
        """Pressure degradation dropped some of a slot's blocks on the
        device: swap the grant list for the kept ids (in the new table
        order) and release the dropped ones through the seam. Returns the
        dropped ids."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        keep = [int(i) for i in keep_ids]
        ks = set(keep)
        if len(ks) != len(keep) or not ks <= set(st.blocks):
            raise ValueError(f"kept ids {keep} are not a subset of the "
                             f"slot's grant {st.blocks}")
        dropped = [b for b in st.blocks if b not in ks]
        st.blocks = keep
        self.release(slot_idx, dropped)
        return dropped

    def occupied_blocks(self) -> dict:
        """slot -> grant list for every occupied slot (audit input)."""
        return {i: list(st.blocks) for i, st in enumerate(self._slots)
                if st is not None}

    def fail_head(self, reason: str = "failed") -> RequestResult:
        """Retire the head of the queue without admitting it: the request
        cannot be served (its budgeted length exceeds the whole pool).
        Earlier completions keep their results."""
        if not self._queue:
            raise ValueError("queue is empty")
        req, t_submit = self._pop_head()
        now = self._clock()
        # a preempted continuation that proves unservable still surfaces
        # the tokens it emitted
        res = RequestResult(
            uid=req.uid, tokens=np.asarray(req.emitted_prefix, np.int32),
            prompt_len=len(req.tokens),
            bucket=self.bucket_for(len(req.tokens)), slot=-1,
            finish_reason=reason,
            ttft_s=((req.t_first_prefix - t_submit)
                    if req.emitted_prefix else 0.0),
            total_s=now - t_submit,
            decode_s=((now - req.t_first_prefix)
                      if req.emitted_prefix else 0.0),
            token_times=np.asarray(req.token_times_prefix, np.float64),
            n_preemptions=req.n_preemptions, n_retries=req.n_retries,
            n_spills=req.n_spills, n_fetches=req.n_fetches,
            bytes_moved=req.bytes_moved, fetch_stall_s=req.fetch_stall_s,
            queue_s=self._queue_s.get(req.uid, 0.0))
        self.results.append(res)
        if self.trace:
            self.trace.instant("request_failed",
                               args=dict(uid=req.uid, reason=reason))
        return res

    # ---- fleet accounting ------------------------------------------------
    def note_decode_step(self) -> None:
        self._decode_steps += 1
        self._active_slot_steps += len(self.active_slots())

    @property
    def decode_steps(self) -> int:
        return self._decode_steps

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        return self._active_slot_steps / max(1, self._decode_steps
                                             * self.n_slots)
