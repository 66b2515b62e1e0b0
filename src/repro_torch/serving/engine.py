"""Batched serving engine with first-class cache compression (counterpart
of `repro.serving.engine`: the wave path and the dense, monolithic
continuous-batching path).

  * **Wave-based** (`generate`): requests in waves of `slots` sequences
    of one prompt length; one prefill + `max_new - 1` decode steps each.
  * **Continuous** (`generate_continuous`): one persistent `slots`-wide
    cache; each request is prefilled at its bucket length (batch 1),
    copied into a free batch slot (`cache.insert_request`), and retired
    the moment it hits EOS or its `max_new`, its slot refilled from the
    queue mid-decode. With ``chunked_prefill=True`` an admission streams
    its prompt in ``chunk_len``-token segments, one bounded step (a
    segment, the compress, or the insert) per decode step, so a long
    prompt never stalls resident slots; the streams are those of a
    monolithic admission. With ``paged=True`` the persistent cache is a
    block pool shared by all slots (`core.paging`): a request is admitted
    only when the free list covers its budgeted length, and its blocks
    return to the pool when it retires.

With ``speculative=True`` `generate_continuous` runs the draft / verify
loop of `serving.speculative` instead: the same weights draft `gamma`
tokens per slot against a cheap cache view (`draft_policy`), and one
rectangular `verify_step` commits the accepted prefix (greedy streams
equal the plain loop's).

Both plain decode loops are double-buffered: step N+1 is dispatched from step
N's device-side tokens before the host reads step N's tokens, and the
read waits on an event recorded right behind step N's token copy — not
on step N+1. The quantized ring's flush decision rides a host mirror of
the ring lengths, so a decode step needs no device sync at all. A
chunked admission's first token takes the same pipelined read one
iteration later.

**One CUDA graph per decode step** (`serving.step_graph`). On the card
a call (a wave, for `generate`) captures its cache's decode step (the
model's dispatch and the greedy sample), one graph per ring flush
variant, and replays it, so a step costs one graph launch instead of
thousands of Python-launched ops; steps the graph cannot hold (SSM,
MoE, cross-attention, sharded caches, policy noise, a sampler that
draws, the speculative loop's masked steps) run eagerly, and the streams
are the eager path's. `ContinuousGenerationResult.graph_steps` counts
the replayed steps.

With ``prefix_sharing=True`` (paged) a radix index over the pool
(`serving.prefix`) lets admissions that share a prompt prefix map the
same physical blocks read-only (refcounted) and stream only their
suffix; a shared block is copied the moment its slot would write it
(copy-on-write), and ``near_hit`` routes same-template, edited-middle
prompts through CacheBlend's selective recompute
(`serving.cacheblend`). Every sharing admission goes through the chunked
machinery, so streams equal those of a run without sharing.

**The overload ladder** (paged, the plain loop), rung by rung:

  1. **spill** (``tiering=True``): above the tier controller's high-water
     mark cold prefix-index blocks demote to a host-RAM tier
     (`paging.HostTier`, ``host_blocks`` big) instead of being freed, and
     a stalled admission's granted-but-unwritten blocks are stripped;
     the bytes come back bit for bit, and a warm hit pages them back;
  2. **degrade** (``degrade=True``, lazy growth, a quantized streaming
     store): above ``degrade_high`` of the pool in use, resident slots
     drop their oldest flushed groups (`paging.degrade_slot_groups`)
     down to ``degrade_low``, keeping ``degrade_keep_groups``; lossy, but
     the slots regrow one group per window of appends;
  3. **preempt** (``preemption=True``): a starved grant or admission
     preempts the least-progressed resident slot, which requeues at the
     front as a continuation. With the tier on and room in it the slot's
     blocks and metadata spill to host and its re-admission restores
     them (no re-prefill, no replay); otherwise the re-admission
     re-prefills the prompt and *replays* the emitted tokens through
     ordinary decode steps (outputs discarded), so its stream equals an
     unpreempted one;
  4. **fail**: without preemption a starved slot retires "oom", and a
     request that cannot fit the empty pool "failed".

With ``block_growth="lazy"`` an admission reserves only its prompt's
blocks and a slot is granted more as it decodes (a host mirror of its
row counts decides each grant, no device read). ``preempt_at`` forces
preemptions at given (dispatch, slot) pairs, ``fault_plan`` injects
allocator refusals, refcount skew and fetch refusals and delays, and
``audit_every`` audits the pool, its device block table and the host
census included, every N dispatches.
``admission_order="shortest-prompt"`` admits the shortest queued prompt
first. Neither rung 1 nor rung 2 runs with ``speculative=True`` (the
constructor refuses, as the JAX engine does).

**Mamba-2 layers.** A hybrid config's (jamba's) slots carry their SSM
state beside their attention cache: the insert, the reset and the host
tier's spill / restore copy a slot's SSM leaves too, and the physical
bytes count them. A config with no attention layer (mamba2) is refused
at construction: it serves through `nn.model.prefill` / `decode_step`.

**Sampling and noise.** The engine owns one `torch.Generator` on its
device, seeded from ``seed``: the sampler (``sampler=greedy``, or
`sampler.temperature(temp, top_k)`) and the NACL / Keyformer noise of the
model functions draw from it in dispatch order, so one seed gives one
stream on one device and path. The JAX engine splits a key per dispatch
instead, so under noise the two packages' streams differ.

**Telemetry.** ``tracer=`` (an `obs.Tracer`) receives the request
lifecycle from the scheduler, the spans ``wave_prefill``,
``wave_decode``, ``prefill``, ``prefill_chunk``, ``blend_prefill``,
``restore`` and ``draft_prefill``, one ``step`` (``round`` when
speculative) per loop iteration, the ``pool`` counter track, and the
instants of the allocator, the host tier, the prefix index and the
ladder (``prefix_warm_hit``, ``prefix_cold``, ``prefix_near_hit``,
``cow``, ``audit``, ``preempt``, ``spill``, ``fetch``, ...). Inside the
plain loop's iteration: ``admit_start`` (a chunked admission's start),
``decode`` (every `_decode`: the model's dispatch and the sample; within
it, while tracing, the model step's ranges ``attn`` ⊃ ``kv`` ⊃ ``attend``
and ``mlp`` per layer, ``logits`` and ``sample`` per step), and, after
the ``step`` span, ``token_wait`` (the pipelined token read; a chunk
admission's first-token read inside the step too) and ``retire`` (the
record / retire / refill bookkeeping, a refill's ``prefill`` nested).
``prefill_chunk`` holds one ``prefill_segment`` (``uid``, ``c0``,
``c1``), ``prefill_finalize`` or ``prefill_insert`` (``uid``) per unit of
work. Each span is also a ``torch.profiler`` range (`obs.trace`), so
under a running profiler the program's spans land on its clock. The
``decode`` and ``token_wait`` seconds are kept with tracing off too
(`ContinuousGenerationResult.dispatch_seconds`, `token_wait_seconds`),
and each `RequestResult` carries its queue wait (``queue_s``). ``metrics=``
(an `obs.Metrics`) gets the loop's ``pool.free_frac`` / ``slots.active``
/ ``engine.loop_iters`` and the end-of-run aggregates
(`Engine._publish_metrics`). Every value handed to either is a host
value: a span ends when the host has enqueued its work, so span times
are host times, and tracing adds no device sync. Both default to falsy
no-ops; the reported prefill / decode seconds come from the same `Span`
stopwatch whether tracing is on or off.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import budgets as budgets_lib
from repro_torch.core import cache as kvcache
from repro_torch.core import paging
from repro_torch.core.cache import CacheSpec, cache_logical_bytes_per_layer
from repro_torch.core.policy import CompressionPolicy
from repro_torch.nn import model as M
from repro_torch.nn.attention import MASS_GROUP
from repro_torch.obs import NULL_METRICS, NULL_TRACER
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import cacheblend as cacheblend_lib
from repro_torch.serving import prefix as prefix_lib
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving import step_graph as graph_lib
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler


@dataclass
class GenerationResult:
    tokens: np.ndarray            # [n_requests, max_new]
    prefill_seconds: float
    decode_seconds: float
    decode_tokens_per_s: float
    cache_physical_bytes: int
    cache_logical_bytes: float
    full_cache_bytes: float
    compression_ratio: float
    policy_name: str
    # decode steps served by a replay of a step graph, the graphs
    # captured and the host seconds the captures took (`step_graph`)
    graph_steps: int = 0
    graph_captures: int = 0
    graph_capture_seconds: float = 0.0


@dataclass
class ContinuousGenerationResult:
    results: List[RequestResult]  # sorted by uid; per-request tokens + latency
    prefill_seconds: float
    decode_seconds: float
    decode_steps: int
    decode_tokens: int            # useful tokens produced by decode steps
    decode_tokens_per_s: float
    occupancy: float              # mean active-slot fraction per decode step
    ttft_mean_s: float
    cache_physical_bytes: int     # dense: resident slots-wide footprint;
                                  # paged: peak allocated-block + metadata
                                  # bytes (real pool usage, not reserve)
    cache_logical_bytes: float
    full_cache_bytes: float
    compression_ratio: float
    policy_name: str
    pool_blocks: int = 0          # paged runs only: reserved pool size,
    pool_block_bytes: int = 0     # bytes one block pins across layers,
    pool_peak_blocks: int = 0     # high-water allocated blocks
    spec: Optional[spec_lib.SpecStats] = None   # speculative runs only
    prefix: Optional[dict] = None  # prefix-sharing runs only: warm / cold /
                                   # near-hit admissions, CoW copies, blocks
    # append steps whose quantized ring flushed (host-decided; one per
    # decode step, verify sub-step or drafter step that flushed any row)
    kv_flush_steps: int = 0
    tier: Optional[dict] = None    # tiering runs only: spill / fetch counts,
                                   # bytes moved, fetch stalls, host-tier
                                   # capacity + pressure-controller stats
    # recompute-on-resume: tokens re-fed through the decode path (the
    # continuation prefixes at re-admission), the seconds spent
    # re-prefilling the preempted prompts (part of prefill_seconds), and
    # the uid of each such re-admission (a restore from the host tier is
    # none of these)
    replayed_tokens: int = 0
    readmit_prefill_s: float = 0.0
    recomputed_uids: List[int] = field(default_factory=list)
    # host seconds inside decode_seconds: the `decode` spans (the model's
    # dispatch and the sample; in the speculative loop the drafter's and
    # the fallback's steps, not verify) and the `token_wait` spans (the
    # host blocked on the pipelined token reads)
    dispatch_seconds: float = 0.0
    token_wait_seconds: float = 0.0
    # decode steps served by a replay of a step graph, the graphs
    # captured and the host seconds the captures took (`step_graph`)
    graph_steps: int = 0
    graph_captures: int = 0
    graph_capture_seconds: float = 0.0

    def tokens_for(self, uid: int) -> np.ndarray:
        for r in self.results:
            if r.uid == uid:
                return r.tokens
        raise KeyError(uid)

    def failed(self) -> List[RequestResult]:
        """Requests retired without being served (a paged pool too small
        for their budgeted length)."""
        return [r for r in self.results if r.finish_reason == "failed"]

    def paged_bytes_per_seq(self, slots: int) -> float:
        """Physical bytes one live request pins under paging: its peak
        allocated blocks plus its share of the per-slot metadata."""
        blocks = self.pool_peak_blocks * self.pool_block_bytes
        return blocks + (self.cache_physical_bytes - blocks) / slots


@dataclass
class _ChunkedAdmission:
    """The in-flight chunked admission (at most one per engine loop): the
    PREFILLING slot, its prompt scratch, and the MASS_GROUP-aligned
    segments still to stream."""
    slot: int
    st: M.PrefillState
    segs: List[np.ndarray]
    starts: List[int]
    total_blocks: int = 0          # paged: full grant target
    granted: int = 0
    next_i: int = 0
    last_logits: Optional[torch.Tensor] = None   # the last segment's logits
    pc: Optional[M.ModelCache] = None            # finalized, awaiting insert
    direct: bool = False           # prefill-direct: segments write the pool
    restore_m: int = 0             # prefix rows restored from the index
    n_adopt: int = 0               # leading blocks adopted read-only
    blend: bool = False            # near-hit CacheBlend admission
    secs: float = 0.0              # accumulated prefill seconds
    stalls: int = 0                # consecutive refused grants (the
                                   # preemption ladder's trigger)


class RingMirror:
    """Host mirror of each slot's quantized-ring length. Every row of the
    batch appends once per decode step, and a row whose ring is full
    flushes first, so the counts evolve without reading the device; an
    admission leaves the ring full (`compress_prompt`), a reset empty."""

    def __init__(self, spec: CacheSpec, slots: int) -> None:
        self.window = spec.window if spec.quantized else 0
        self.rlen = np.zeros(slots, np.int64)

    def fill(self, slot: Optional[int] = None) -> None:
        self.rlen[slice(None) if slot is None else slot] = self.window

    def clear(self, slot: int) -> None:
        self.rlen[slot] = 0

    def advance(self) -> bool:
        """Account one decode step; True when some ring flushes in it."""
        if not self.window:
            return False
        full = self.rlen >= self.window
        self.rlen[full] = 0
        self.rlen += 1
        return bool(full.any())


class _TokenFetch:
    """Pipelined device->host token reads. `start` queues an async copy
    into pinned memory right behind the step that made the tokens and
    records an event; `get` waits for that event only, so work
    dispatched after `start` keeps running. Two buffers alternate: a
    buffer is reused only after its tokens were read."""

    def __init__(self, device: torch.device, n: int) -> None:
        self.cuda = device.type == "cuda"
        self._bufs = [torch.empty(n, dtype=torch.int32, pin_memory=self.cuda)
                      for _ in range(2)]
        self._i = 0

    def start(self, tok_dev: torch.Tensor):
        """Queue the copy of `tok_dev`; returns the handle `get` reads."""
        buf = self._bufs[self._i]
        self._i ^= 1
        buf.copy_(tok_dev, non_blocking=self.cuda)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    @staticmethod
    def get(handle) -> np.ndarray:
        buf, ev = handle
        if ev is not None:
            ev.synchronize()
        return buf.numpy().copy()


class Engine:
    """Serving engine over one compression policy (module docstring).
    `device` None means the card and raises without one; `params` must
    live on the engine's device. `use_kernels` overrides the config's
    kernels-or-reference switch. `paged` (with `block_len`,
    `pool_blocks`: None is capacity parity with the dense layout) and
    `chunked_prefill` (with `chunk_len`), `speculative` (with `gamma`
    and `draft_policy`) and `prefix_sharing` (with `near_hit`, the
    CacheBlend recompute fraction; 0 turns near-hits off) apply to
    `generate_continuous`, as in the JAX engine, and so do the overload
    ladder's `block_growth`, `admission_order`, `preemption` (with
    `preempt_patience`, `fail_patience`), `preempt_at`, `fault_plan`,
    `audit_every`, `degrade` (with `degrade_high`, `degrade_low`,
    `degrade_keep_groups`) and `tiering` (with `host_blocks`: None is
    the pool's size) (module docstring). `sampler`, `seed`, `tracer` and
    `metrics` as in the module docstring (speculative decoding needs the
    greedy sampler); `allocator_signal` ({"cos_sim": [L]} for squeeze,
    {"uncertainty": [L]} for zigzag, e.g. from `budgets.
    layer_cosine_signal` / `attention_entropy_signal`) feeds the layer
    budget allocator in place of its defaults."""

    def __init__(self, cfg, params, policy: CompressionPolicy, *,
                 prompt_len: Optional[int] = None, max_new: int,
                 slots: int = 4, buckets: Optional[Sequence[int]] = None,
                 use_kernels: Optional[bool] = None, device=None,
                 paged: bool = False, block_len: int = 16,
                 pool_blocks: Optional[int] = None,
                 chunked_prefill: bool = False, chunk_len: int = 64,
                 block_growth: str = "eager",
                 admission_order: str = "fifo", speculative: bool = False,
                 gamma: int = 4, draft_policy: str = "window:64",
                 sampler: Callable = sampler_lib.greedy,
                 allocator_signal: Optional[dict] = None, seed: int = 0,
                 prefix_sharing: bool = False, near_hit: float = 0.0,
                 preemption: bool = False, preempt_patience: int = 2,
                 fail_patience: int = 3, degrade: bool = False,
                 degrade_high: float = 0.85, degrade_low: float = 0.60,
                 degrade_keep_groups: int = 2, tiering: bool = False,
                 host_blocks: Optional[int] = None,
                 fault_plan: Optional[paging.FaultPlan] = None,
                 audit_every: int = 0,
                 preempt_at: Sequence[Sequence[int]] = (),
                 tracer=None, metrics=None):
        if block_growth not in ("eager", "lazy"):
            raise ValueError(f"unknown block_growth {block_growth!r}")
        if admission_order not in ("fifo", "shortest-prompt"):
            raise ValueError(f"unknown admission_order {admission_order!r}")
        if speculative and sampler is not sampler_lib.greedy:
            raise ValueError(
                "speculative decoding requires the greedy sampler "
                "(acceptance is exact match-and-truncate under argmax)")
        self.device = resolve_device(device)
        self.sampler = sampler
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # telemetry: both default to falsy no-ops, so every emit site is
        # one truthiness check when it is off; only host values reach
        # them (kvlint's host-sync rule checks the loops)
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        if prompt_len is None and not buckets:
            raise ValueError("need prompt_len and/or buckets")
        if use_kernels is not None:
            cfg = cfg.replace(use_kernels=bool(use_kernels))
        self.buckets = (tuple(sorted({int(b) for b in buckets}))
                        if buckets else (int(prompt_len),))
        if prompt_len is None:
            prompt_len = max(self.buckets)
        if max(self.buckets) > prompt_len:
            raise ValueError(f"bucket {max(self.buckets)} exceeds "
                             f"prompt_len {prompt_len}")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"on {self.device}")
        self.cfg, self.params, self.policy = cfg, params, policy
        self.prompt_len, self.max_new, self.slots = prompt_len, max_new, slots

        spec = policy.spec
        if not spec.compressed:
            # the uncompressed baseline still needs decode headroom (sized
            # for the largest bucket so every bucket shares one shape)
            spec = CacheSpec(budget=prompt_len + max_new, policy="none",
                             sinks=spec.sinks)
        self.spec = spec

        # paged block-table cache (continuous batching only): one pool per
        # layer + a per-slot table; a request pins only the blocks its
        # budgeted length needs, and retired blocks recycle (core/paging)
        self.paged = bool(paged)
        self._S_phys = spec.main_store_len(prompt_len + max_new)
        self.block_len = (paging.resolve_block_len(spec, self._S_phys,
                                                   block_len)
                          if paged else 0)
        self.n_max_blocks = self._S_phys // self.block_len if paged else 0
        self.pool_blocks = ((int(pool_blocks) if pool_blocks
                             else slots * self.n_max_blocks) if paged else 0)
        self.block_allocator: Optional[paging.BlockAllocator] = None
        self.last_audit: Optional[dict] = None

        # lazy decode-block growth (paged): an admission reserves only its
        # prompt's blocks, decode blocks are granted as `pos` crosses block
        # boundaries (a speculative rollback returns them)
        if block_growth == "lazy" and not paged:
            raise ValueError("block_growth='lazy' requires paged=True")
        self.lazy_blocks = block_growth == "lazy"
        self.admission_order = admission_order

        # the host-RAM tier under the pool (`paging.HostTier`): cold
        # prefix-index blocks demote to it instead of being freed, a
        # stalled admission's unwritten grant is stripped, and a preempted
        # slot snapshots to it and restores on re-admission
        self.tiering = bool(tiering)
        if self.tiering and not self.paged:
            raise ValueError("tiering spills paged pool blocks; it "
                             "requires paged=True")
        if self.tiering and speculative:
            raise ValueError("tiering + speculative is unsupported (the "
                             "draft cache holds no block tables to spill)")
        if host_blocks is not None and not self.tiering:
            raise ValueError("host_blocks requires tiering=True")
        self.host_blocks = (int(host_blocks) if host_blocks
                            else self.pool_blocks if self.tiering else 0)
        self.host_tier: Optional[paging.HostTier] = None
        self.tier_pressure = None
        self._tier_aux: dict = {}     # tier handle -> host mirror snapshots
        self._tier_stripped = 0       # stalled admissions' grants reclaimed

        # the overload ladder: a starved grant or admission preempts the
        # least-progressed resident slot, which requeues as a continuation
        # and replays its emitted tokens on re-admission. `preempt_at`
        # ((dispatch, slot) pairs) forces preemptions; `fault_plan` and
        # `audit_every` are the proof harness (injected allocator faults,
        # pool audits during the run)
        self.preempt_at = tuple((int(k), int(s)) for k, s in preempt_at)
        self.preemption = bool(preemption) or bool(self.preempt_at)
        self.preempt_patience = int(preempt_patience)
        self.fail_patience = max(int(fail_patience), 1)
        self.fault_plan = fault_plan
        self.audit_every = int(audit_every)
        if fault_plan is not None and not self.paged:
            raise ValueError("fault_plan injects BlockAllocator faults; "
                             "it requires paged=True")
        if self.audit_every and not self.paged:
            raise ValueError("audit_every audits the paged pool; it "
                             "requires paged=True")

        # cross-request prefix sharing (paged + continuous only): a radix
        # index over the pool lets admissions sharing a prompt prefix map
        # the same blocks read-only and prefill only their suffix. Every
        # admission then goes through the chunked machinery (a warm hit
        # is a chunked prefill resumed at the match offset)
        self.prefix_sharing = bool(prefix_sharing)
        self.near_hit = float(near_hit)
        if self.prefix_sharing:
            if not paged:
                raise ValueError("prefix_sharing requires paged=True")
            if speculative:
                raise ValueError(
                    "prefix_sharing + speculative is unsupported (the "
                    "draft cache holds no block tables to share)")
        if self.near_hit:
            if not self.prefix_sharing:
                raise ValueError("near_hit requires prefix_sharing=True")
            if not 0.0 < self.near_hit <= 1.0:
                raise ValueError(f"near_hit is a recompute fraction in "
                                 f"(0, 1], got {self.near_hit}")
        self._share_state: Optional[dict] = None   # live during a sharing run
        self.flush_steps = 0
        self.dispatch_s = 0.0        # `decode` spans (`_decode`) of the run
        self.token_wait_s = 0.0      # `token_wait` spans of the run
        # one CUDA graph per decode step (`step_graph`): the card's capture
        # backend (None on the CPU: every step eager), the live cache's
        # graphs, and the run's replays and captures
        self.graph_backend = (graph_lib.CudaGraphs()
                              if self.device.type == "cuda" else None)
        self._graphs: Optional[graph_lib.StepGraphs] = None
        self.graph_steps = self.graph_captures = 0
        self.graph_capture_s = 0.0
        self.replayed_tokens = 0
        self.readmit_prefill_s = 0.0
        self.recomputed_uids = []

        # chunked prefill (continuous batching only): chunk_len snaps to
        # the mass group, so chunked and monolithic admissions fold the
        # attention mass in the same association chain
        self.chunked_prefill = bool(chunked_prefill)
        self.chunk_len = 0
        if self.chunked_prefill or self.prefix_sharing:
            M._check_chunkable(cfg)
            self.chunk_len = max(MASS_GROUP,
                                 int(chunk_len) - int(chunk_len) % MASS_GROUP)
            self._check_aligned(self.buckets)

        n_attn = cfg.num_attn_layers()
        alloc = budgets_lib.ALLOCATORS[policy.allocator]
        kw = dict(policy.allocator_kwargs)
        kw.setdefault("multiple", spec.group if spec.quantized else 1)
        if policy.allocator == "squeeze":
            kw.setdefault("cos_sim", (allocator_signal or {}).get(
                "cos_sim", np.linspace(0.6, 0.95, n_attn)))
        if policy.allocator == "zigzag":
            kw.setdefault("uncertainty", (allocator_signal or {}).get(
                "uncertainty", np.ones(n_attn)))
        self.layer_budgets = np.minimum(alloc(n_attn, spec.budget, **kw),
                                        spec.main_store_len(prompt_len))

        # speculative decoding (continuous only): a second, per-slot cache
        # over the same weights drafts against a cheap view; the verify
        # step scores each segment against the real cache in one forward
        self.speculative = bool(speculative)
        self.gamma = int(gamma)
        if self.speculative:
            if self.gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            M._check_speculable(cfg)
            self.draft = spec_lib.resolve_draft_policy(
                draft_policy, cfg, self.spec, prompt_len, max_new)
            dS = self.draft.spec.main_store_len(prompt_len + max_new)
            self.draft_layer_budgets = np.minimum(
                budgets_lib.ALLOCATORS["uniform"](
                    n_attn, self.draft.spec.budget or dS,
                    multiple=(self.draft.spec.group
                              if self.draft.spec.quantized else 1)),
                dS)

        # pressure-driven degradation (the rung between spill and
        # preempt): above the high-water mark resident quantized slots
        # drop their oldest flushed groups
        self.pressure = None
        if degrade:
            if not (self.paged and self.lazy_blocks):
                raise ValueError(
                    "degrade requires paged=True with block_growth="
                    "'lazy': lazy growth grants a block before every "
                    "dispatch, which is what guarantees a post-degrade "
                    "ring flush always lands in a mapped table entry")
            if not self.spec.quantized or self.spec.track_scores():
                raise ValueError(
                    "degrade drops whole flushed groups of a quantized "
                    "streaming store (kivi*); score-carrying or "
                    "unquantized policies have no group structure to "
                    "evict down")
            if self.speculative:
                raise ValueError(
                    "degrade + speculative is unsupported (the drafter's "
                    "host mirror cannot track pressure evictions)")
            # adaptive.py imports Engine at module level; import the
            # controller here to keep the cycle one-directional
            from repro_torch.serving.adaptive import PressureController
            self.pressure = PressureController(
                high_water=degrade_high, low_water=degrade_low,
                keep_groups=degrade_keep_groups, tracer=self.trace)

        if not n_attn:
            # the JAX engine takes this config and fails at the first
            # admission (a reshape of its empty layer-budget array)
            raise ValueError(
                f"{cfg.name}: the serving engine needs an attention layer "
                f"(arch_type {cfg.arch_type!r} has none); serve it through "
                "nn.model.prefill / decode_step")

    # ------------------------------------------------------------------
    def _check_aligned(self, buckets) -> None:
        bad = [int(b) for b in buckets if int(b) % MASS_GROUP]
        if bad:
            raise ValueError(f"chunked prefill needs MASS_GROUP({MASS_GROUP})"
                             f"-aligned prompt buckets, got {bad}")

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device without a stream
        sync: a pinned staging copy, sent non-blocking (the caching host
        allocator keeps the staging buffer until the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _h2d_ids(self, ids: Sequence[int], dtype=np.int64) -> torch.Tensor:
        """Host block ids (a Python list) on the engine's device."""
        return self._h2d(np.array(ids, dtype))

    def _model_of(self, draft: bool):
        """(cfg, cache spec, layer budgets) of the target or the drafter
        (same weights)."""
        if draft:
            return self.draft.cfg, self.draft.spec, self.draft_layer_budgets
        return self.cfg, self.spec, self.layer_budgets

    def _prefill(self, tokens: np.ndarray, *, draft: bool = False,
                 src_embeds: Optional[np.ndarray] = None):
        cfg, spec, budgets = self._model_of(draft)
        batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                           device=self.device)}
        if src_embeds is not None:
            batch["src_embeds"] = torch.as_tensor(src_embeds,
                                                  device=self.device)
        return M.prefill(self.params, cfg, batch, spec,
                         layer_budgets=budgets, generator=self.gen)

    def _decode(self, cache: M.ModelCache, tok: torch.Tensor,
                ring_full: bool, *,
                append_mask: Optional[torch.Tensor] = None,
                draft: bool = False) -> torch.Tensor:
        """One decode dispatch and its sample, under the ``decode`` span
        (its seconds add to `dispatch_s`): a replay of the cache's step
        graph where `step_graph`'s rule allows (a capture first, under a
        ``graph_capture`` span), else the eager step, inside which, while
        tracing, the model step's ranges (`obs.trace.model_range`) and
        ``sample`` nest (a capture records them too)."""
        self.flush_steps += bool(ring_full)
        tr = self.trace
        g = self._graphs
        if (g is None or g.cache is not cache or append_mask is not None
                or draft or not g.ready(tok, ring_full, tr)):
            g = None
        with tr.span("decode") as sp:
            if g is not None:
                tok = g.replay(tok, ring_full)
            else:
                with obs_trace.model_tracing(tr):
                    tok = self._step(cache, tok, ring_full,
                                     append_mask=append_mask, draft=draft)
        self.dispatch_s += sp.elapsed
        return tok

    def _step(self, cache: M.ModelCache, tok: torch.Tensor, ring_full, *,
              append_mask: Optional[torch.Tensor] = None,
              draft: bool = False) -> torch.Tensor:
        """The decode step itself: the model's dispatch and the sample
        (what a step graph captures)."""
        cfg, spec, _ = self._model_of(draft)
        logits, _ = M.decode_step(self.params, cfg, cache, tok, spec,
                                  ring_full=ring_full,
                                  append_mask=append_mask,
                                  generator=self.gen)
        with obs_trace.model_range("sample"):
            return self.sampler(logits, self.gen)

    def _open_graphs(self, cache: M.ModelCache, tok: torch.Tensor) -> None:
        """The step graphs of `cache`, whose decode steps take tokens
        shaped as `tok`, where `step_graph`'s rule allows them."""
        self._graphs = None
        if self.graph_backend is None or graph_lib.blocker(
                self.cfg, self.spec, cache, self.sampler, self.gen):
            return
        self._graphs = graph_lib.StepGraphs(
            self.graph_backend, lambda t, rf: self._step(cache, t, rf),
            self.cfg, cache, tok,
            (False, True) if self.spec.quantized else (False,))

    def _close_graphs(self) -> None:
        """Count the live graphs' replays and captures, and free them."""
        g, self._graphs = self._graphs, None
        if g is not None:
            self.graph_steps += g.replays
            self.graph_captures += g.captures
            self.graph_capture_s += g.capture_s

    # the speculative loop's verify step (`serving.speculative`)
    def _verify(self, cache: M.ModelCache, tokens: torch.Tensor,
                valid_len: torch.Tensor, ring_full):
        self.flush_steps += sum(map(bool, ring_full))
        y, acc, _ = M.verify_step(self.params, self.cfg, cache, tokens,
                                  valid_len, self.spec, ring_full=ring_full,
                                  generator=self.gen)
        return y, acc

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _request_blocks(self, req: Request) -> int:
        """Pool blocks an admission reserves. Eager growth: the request's
        whole budgeted length (prompt, decode headroom, quantization
        slack). Lazy growth: the prompt only, decode blocks come as `pos`
        advances; under preemption also a continuation's replay rows and
        the first new append, so a resumed slot never starves mid-replay
        (two continuations could otherwise trade the pool forever) and
        commits >= 1 new token before it can be preempted again."""
        if self.lazy_blocks:
            rows = len(req.tokens) + len(req.emitted_prefix)
            if self.preemption:
                rows += 1
            base = paging.request_blocks_prefix(self.spec, self._S_phys,
                                                rows, self.block_len)
        else:
            base = paging.request_blocks(self.spec, self._S_phys,
                                         len(req.tokens), req.max_new,
                                         self.block_len)
        if req.tier_ticket is not None:
            # a spill-preempted continuation restores its snapshot into
            # fresh ids: the grant covers the snapshot and the recompute
            # path (a refused fetch falls back to replay)
            return max(req.tier_blocks, base)
        return base

    def _drop_ticket(self, req: Request) -> None:
        """Abandon a queued continuation's host snapshot; it resumes by
        recompute-on-resume replay instead."""
        if req.tier_ticket is not None and self.host_tier is not None:
            self.host_tier.drop(req.tier_ticket)
            self._tier_aux.pop(req.tier_ticket, None)
            req.tier_ticket = None
            req.tier_blocks = 0

    def _run_audit(self, sched: Scheduler, cache=None) -> dict:
        """Pool invariant audit (`paging.audit_pool`): allocator refcounts
        against every occupied slot's grant list and the prefix index;
        with `cache`, also each active slot's device block table (read to
        the host: a sync). Raises `PoolAuditError` on any violation; the
        report lands on `self.last_audit`."""
        index_blocks = ()
        if self._share_state is not None:
            index_blocks = self._share_state["index"].block_ids()
        tier_holders: List[int] = []
        if self.host_tier is not None:
            if self._share_state is not None:
                tier_holders += self._share_state["index"].host_handles()
            tier_holders += sched.queued_tickets()
        tbl = (cache.attn.block_tbl.cpu().numpy() if cache is not None
               else None)
        self.last_audit = paging.audit_pool(
            self.block_allocator, sched.occupied_blocks(), index_blocks,
            block_tbl=tbl, tbl_slots=sched.active_slots(),
            host_tier=self.host_tier, tier_holders=tier_holders)
        return self.last_audit

    def _grow_blocks(self, sched: Scheduler, cache: M.ModelCache,
                     slot: int, rows: int) -> bool:
        """Lazy growth: grant the slot the blocks its first `rows`
        main-store rows need and map them in its table row (on the stream,
        behind every earlier write). False: the pool cannot cover them."""
        need = paging.request_blocks_prefix(self.spec, self._S_phys, rows,
                                            self.block_len)
        have = len(sched.slot_blocks(slot))
        if need <= have:
            return True
        if not sched.grant_blocks(slot, need - have):
            return False
        paging.write_block_table(
            cache.attn, slot, have,
            self._h2d_ids(sched.slot_blocks(slot)[have:], np.int32),
            batch_axis=2)
        return True

    def _climb_ladder(self, sched: Scheduler, slot: int,
                      grow: Callable[[], bool],
                      preempt: Callable[[int], None],
                      exclude: Sequence[int]) -> str:
        """A lazy grant for `slot` was refused: retry it (each attempt a
        fresh alloc call, so transient injected refusals pass), then, with
        preemption on, preempt victims (never `slot` or `exclude`) until
        it fits, and requeue `slot` itself if other work still holds
        blocks that will free. Returns "granted", "preempted" (the slot
        went back to the queue) or "oom" (the caller retires it: nothing
        else will ever free blocks). `grow` retries the grant and
        `preempt` evicts a slot, both in the calling loop's terms."""
        if any(grow() for _ in range(self.fail_patience)):
            return "granted"
        if not self.preemption:
            return "oom"
        while (v := sched.preempt_victim(exclude=(slot, *exclude))
               ) is not None:
            preempt(v)
            if grow():
                return "granted"
        if len(sched.active_slots()) > 1 or sched.prefilling_slots():
            preempt(slot)
            return "preempted"
        return "oom"

    def _retry_refused_admission(self, sched: Scheduler, ladder: bool,
                                 preempt: Callable[[int], None],
                                 exclude: Sequence[int]) -> bool:
        """The pool refused the queue head's admission. With `ladder` and
        preemption on, past `preempt_patience` refusals a victim (never
        one in `exclude`) is preempted for its blocks. With nothing
        running, nothing will ever free blocks: an injected refusal is
        transient, so the head gets `fail_patience` more tries before it
        is failed as unservable. True: try the head again."""
        tries = sched.note_retry()
        if ladder and self.preemption and tries > self.preempt_patience:
            v = sched.preempt_victim(exclude=exclude)
            if v is not None:
                preempt(v)
                return True
        if not sched.active_slots() and not sched.prefilling_slots():
            if tries > self.fail_patience:
                head = sched.head_request()
                if head is not None and head.tier_ticket is not None:
                    # a ticket-sized grant the pool can never cover: drop
                    # the snapshot, retry as a plain (smaller) recompute
                    # continuation
                    self._drop_ticket(head)
                else:
                    sched.fail_head()
            return True
        return False

    def _escalate_stall(self, sched: Scheduler,
                        adm: Optional[_ChunkedAdmission],
                        preempt: Callable[[int], None],
                        exclude: Sequence[int]) -> None:
        """A chunked admission whose grant has stalled past
        `preempt_patience` claims a victim's blocks (never the
        admission's own slot or one in `exclude`)."""
        if (self.preemption and adm is not None
                and adm.stalls > self.preempt_patience):
            v = sched.preempt_victim(exclude=(adm.slot, *exclude))
            if v is not None:
                preempt(v)
                adm.stalls = 0

    def _new_scheduler(self, buckets) -> Scheduler:
        """A fresh scheduler for one continuous run (paged: over a fresh
        free list with the fault plan, kept for post-run inspection)."""
        if not self.paged:
            return Scheduler(buckets or self.buckets, self.slots,
                             admission_order=self.admission_order,
                             tracer=self.trace)
        self.block_allocator = paging.BlockAllocator(
            self.pool_blocks, fault_plan=self.fault_plan, tracer=self.trace)
        return Scheduler(buckets or self.buckets, self.slots,
                         allocator=self.block_allocator,
                         block_need=self._request_blocks,
                         admission_order=self.admission_order,
                         tracer=self.trace)

    def _verbatim_ok(self, bucket: int) -> bool:
        """True when prefill keeps every prompt row verbatim (no selection,
        no quantization, no ring): the prefill-direct case, where chunk
        K/V rows stream straight into pool blocks and the insert writes
        metadata only (`M.prefill_finalize_meta`)."""
        s = self.spec
        return (not s.quantized and s.window == 0
                and s.main_store_len(bucket) >= bucket)

    def _insert(self, cache: M.ModelCache, sched: Scheduler, slot: int,
                pc: M.ModelCache, *, pool_write: bool = True,
                n_skip: int = 0) -> None:
        """Copy a batch-1 prefilled cache into `slot` of the live cache; a
        paged cache maps the slot's granted blocks and scatters the rows
        into them (not at all on the prefill-direct path, and not into the
        first `n_skip` blocks, adopted read-only from the prefix index)."""
        if cache.ssm is not None:
            kvcache.insert_request_tree(cache.ssm, slot, pc.ssm,
                                        batch_axis=2)
        if not self.paged:
            kvcache.insert_request(cache.attn, slot, pc.attn, batch_axis=2)
            return
        ids = np.full(self.n_max_blocks, -1, np.int32)
        got = sched.slot_blocks(slot)
        ids[:len(got)] = got
        paging.insert_request_paged(cache.attn, slot, pc.attn,
                                    self._h2d(ids), batch_axis=2,
                                    n_skip=n_skip, pool_write=pool_write)

    def _reset(self, cache: M.ModelCache, slot: int) -> None:
        """Clear a slot (paged: its table row too, so a free slot's
        garbage appends never route into re-granted blocks; its SSM
        state back to zeros)."""
        if cache.ssm is not None:
            kvcache.reset_slot_tree(cache.ssm, slot, batch_axis=2)
        if self.paged:
            paging.reset_slot_paged(cache.attn, slot, batch_axis=2)
        else:
            kvcache.reset_slot(cache.attn, slot, batch_axis=2)

    # ------------------------------------------------------------------
    # Prefix sharing: eligibility and the host-side copy-on-write trigger
    # ------------------------------------------------------------------
    def _share_retained(self, bucket: int) -> int:
        """Leading prompt rows of a `bucket`-length admission whose final
        cache rows are blockwise deterministic and in position order: the
        shareable prefix (pool block b can then be mapped by any request
        whose tokens agree on rows [b*block_len, (b+1)*block_len)). 0 when
        this spec cannot share: score-carrying eviction orders rows by
        data, and a budget too small to keep the whole pre-window prompt
        drops rows mid-prefix."""
        spec = self.spec
        if spec.policy not in ("none", "streaming") or spec.track_scores():
            return 0
        min_lb = int(np.min(self.layer_budgets))
        if spec.window == 0:
            # verbatim prefill branch: every prompt row kept in place
            if spec.quantized:
                return 0
            ok = spec.main_store_len(bucket) >= bucket and min_lb >= bucket
            return bucket if ok else 0
        # streaming selection: rows [0, bucket - window) land in position
        # order in the main store when the store covers them all
        n_main = bucket - spec.window
        if n_main <= 0 or spec.main_store_len(bucket) < n_main:
            return 0
        cap = ((min_lb // spec.group) * spec.group if spec.quantized
               else min_lb)
        return n_main if cap >= n_main else 0

    def _cow_due(self, mirror, slot: int) -> bool:
        """Could this slot's next append write rows below its shared
        prefix? Appends and non-evicting flushes write at or above the
        slot's own length (past the shared rows by construction), so only
        an evict-at-cap flush can reach a shared block; a quantized ring
        flushes nothing until it is full."""
        if self.spec.quantized and int(mirror.rlen[slot]) < self.spec.window:
            return False
        return bool(np.any(mirror.length[slot] >= mirror.cap_rows))

    # ------------------------------------------------------------------
    # Chunked admission: at most one in flight, advanced one bounded step
    # (a prompt segment, the compress, or the insert) per decode step
    # ------------------------------------------------------------------
    def _start_chunked_admission(self, sched: Scheduler
                                 ) -> Optional[_ChunkedAdmission]:
        """Begin a chunked admission into the first free slot; heads that
        can never fit the pool fail at once. Under prefix sharing the
        admission consults the radix index first: an exact block-aligned
        prefix hit adopts the matched blocks read-only and streams only
        the suffix; a near-hit (same template, edited middle) goes
        through CacheBlend's selective recompute."""
        share = self._share_state
        while sched.pending:
            free = sched.free_slots()
            if not free:
                return None
            req = sched.head_request()
            if self.host_tier is not None and req.tier_ticket is not None:
                # a spill-preempted continuation is restored by the
                # loop-top ticket path, never streamed through a chunked
                # admission; later requests wait behind it
                return None
            total = self._request_blocks(req) if self.paged else 0
            if self.paged and total > self.pool_blocks:
                sched.fail_head()
                continue
            slot = free[0]
            L, C = len(req.tokens), self.chunk_len
            m = 0
            adopt_ids: List[int] = []
            pieces: List[tuple] = []
            if share is not None and self._share_retained(L):
                ids, pcs = share["index"].match(req.tokens)
                m_exact = len(ids) * self.block_len
                if (share["near_ok"] and m_exact * 2 < L
                        and share["index"].near_overlap(req.tokens) >= 0.8):
                    adm = self._start_blend_admission(sched, slot, req,
                                                      total, m_exact)
                    if adm is not None:
                        return adm
                # restore length: whole matched blocks, snapped down to the
                # resume quantum (chunked prefill folds the mass per
                # MASS_GROUP rows), leaving >= 1 suffix token for the
                # first token's logits
                m = min(m_exact, L - 1)
                m -= m % share["align"]
                if m > 0:
                    n_adopt = min(m // self.block_len,
                                  self._share_retained(L) // self.block_len)
                    adopt_ids = ids[:n_adopt]
                    pieces = pcs[:m // self.block_len]
            sched.begin_prefill(slot)
            if adopt_ids:
                sched.adopt_blocks(slot, adopt_ids)
            st = (self._restore_scratch(L, m, pieces) if m > 0 else
                  M.init_prefill_state(self.cfg, L, device=self.device))
            starts = list(range(m, L, C))
            return _ChunkedAdmission(
                slot=slot, st=st, segs=[req.tokens[s:s + C] for s in starts],
                starts=starts, total_blocks=total, granted=len(adopt_ids),
                direct=self.paged and self._verbatim_ok(L), restore_m=m,
                n_adopt=len(adopt_ids))
        return None

    def _start_blend_admission(self, sched: Scheduler, slot: int,
                               req: Request, total: int, m_exact: int
                               ) -> Optional[_ChunkedAdmission]:
        """Near-hit admission: CacheBlend recomputes only the tokens of
        highest KV deviation past the exact prefix and reuses the rest
        (`serving.cacheblend`), then the blended K / V are compressed into
        an ordinary batch-1 cache (`M.prefill_from_kv`). Approximate for a
        recompute fraction below 1, so it is never ingested into the
        index. None when the exact prefix is too short to anchor it."""
        if m_exact < self.block_len:
            return None
        with self.trace.span("blend_prefill", tid=slot + 1,
                             args=dict(uid=req.uid, m=m_exact)) as sp:
            tokens = torch.as_tensor(req.tokens[None].astype(np.int64),
                                     device=self.device)
            logits, (ks, vs), _ = cacheblend_lib.blend_prefill(
                self.params, self.cfg, tokens, [0, m_exact],
                recompute_frac=self.near_hit)
            pc = M.prefill_from_kv(self.cfg, self.spec, ks, vs,
                                   layer_budgets=self.layer_budgets,
                                   generator=self.gen)
            sched.begin_prefill(slot)
        self._share_state["stats"]["near_hits"] += 1
        if self.trace:
            self.trace.instant("prefix_near_hit", tid=slot + 1,
                               args=dict(uid=req.uid))
        return _ChunkedAdmission(
            slot=slot, st=None, segs=[], starts=[], total_blocks=total,
            next_i=1, last_logits=logits, pc=pc, blend=True,
            secs=sp.elapsed)

    def _restore_scratch(self, L: int, m: int, pieces) -> M.PrefillState:
        """A prefill scratch whose first `m` rows are the indexed prefix's
        host pieces (per block: K / V rows and attention mass), so
        `prefill_chunk` can resume at offset m with only the suffix. Equal
        to streaming the whole prompt: rows [0, m) of the ingesting run's
        final scratch are what this prompt's own segments would produce
        (causal within a segment, the canonical mass fold). Each piece is
        one contiguous pinned block, so its upload is one asynchronous
        copy into a staging tensor, which one device copy lays out."""
        st = M.init_prefill_state(self.cfg, L, device=self.device)
        for j, dst in enumerate((st.k, st.v, st.mass)):
            stage = torch.empty((len(pieces), *pieces[0][j].shape),
                                dtype=dst.dtype, device=self.device)
            for b, piece in enumerate(pieces):
                stage[b].copy_(piece[j], non_blocking=True)
            # [n_blocks, n_sb, nA, 1, bl, ...] -> [n_sb, nA, 1, m, ...]
            dst.narrow(3, 0, m).copy_(
                stage.movedim(0, 3).reshape(*dst.shape[:3], m,
                                            *dst.shape[4:]))
        return st

    @staticmethod
    def _host_pieces(t: torch.Tensor, r0: int, r1: int, bl: int):
        """Scratch rows [r0, r1) of `t` ([n_sb, nA, 1, T, ...]) as one host
        copy per `bl`-row block, each contiguous: [n_sb, nA, 1, bl, ...].
        On the card the copy goes asynchronously into pinned memory (the
        restore's uploads, later on the same stream, are ordered after
        it), so the ingest never waits for the device."""
        x = t.narrow(3, r0, r1 - r0)
        x = x.reshape(*x.shape[:3], (r1 - r0) // bl, bl, *x.shape[4:])
        x = x.movedim(3, 0).contiguous()
        pin = x.device.type == "cuda"
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
        host.copy_(x, non_blocking=pin)
        return host.unbind(0)

    def _note_inserted(self, sched: Scheduler, adm: _ChunkedAdmission,
                       share: dict) -> None:
        """Sharing bookkeeping after an insert: ingest the admission's
        retained full blocks into the index (exact admissions only: a
        blend cache is approximate), remember the prompt for near-hits,
        admit the host row mirror, and record which leading blocks the
        slot maps shared (the copy-on-write watch set)."""
        slot = adm.slot
        req = sched.slot_request(slot)
        L = len(req.tokens)
        bl = self.block_len
        n_ing = 0
        if not adm.blend:
            n_ing = self._share_retained(L) // bl
            if n_ing > 0:
                # host copies of the final scratch rows, block-sliced (the
                # index outlives the scratch); blocks already indexed keep
                # their first writer's piece, so only the rest are copied
                index = share["index"]
                have = len(index.match(req.tokens[:n_ing * bl])[0])
                new = [self._host_pieces(t, have * bl, n_ing * bl, bl)
                       for t in (adm.st.k, adm.st.v, adm.st.mass)]
                pieces = [None] * have + list(zip(*new))
                share["stats"]["ingested_blocks"] += index.ingest(
                    req.tokens, sched.slot_blocks(slot)[:n_ing], pieces,
                    self.block_allocator)
        share["index"].note_prompt(req.tokens)
        share["mirror"].admit(slot, L)
        # CoW watch set: every leading block the index now references —
        # adopted blocks and the slot's own freshly ingested ones (an
        # evicting flush into either would corrupt the cached prefix)
        n_watch = max(adm.n_adopt, n_ing)
        if n_watch > 0:
            share["upto"][slot] = n_watch
        if adm.n_adopt > 0:
            share["stats"]["warm_hits"] += 1
            if self.trace:
                self.trace.instant("prefix_warm_hit", tid=slot + 1,
                                   args=dict(uid=req.uid,
                                             blocks=adm.n_adopt))
        elif not adm.blend:
            share["stats"]["cold"] += 1
            if self.trace:
                self.trace.instant("prefix_cold", tid=slot + 1,
                                   args=dict(uid=req.uid))

    @staticmethod
    def _grant(adm: _ChunkedAdmission, sched: Scheduler,
               target: int) -> bool:
        """Top the admission's grant up to `target` blocks. False: the pool
        cannot cover it yet (`_note_adm_stall` decides what follows)."""
        if target <= adm.granted:
            return True
        if not sched.grant_blocks(adm.slot, target - adm.granted):
            return False
        adm.granted = target
        adm.stalls = 0
        return True

    def _note_adm_stall(self, adm: _ChunkedAdmission, sched: Scheduler
                        ) -> Optional[_ChunkedAdmission]:
        """A grant for the in-flight admission was refused. With resident
        work the admission just stalls (the loop's ladder may preempt a
        victim once `stalls` passes the patience). With nothing active it
        cannot happen unless faults are injected or preemption is on
        (every admission fits the pool, only one is in flight); under
        either a lone admission can starve, and is retired "failed" after
        a bounded retry window instead of spinning forever."""
        adm.stalls += 1
        if not sched.active_slots():
            if self.fault_plan is None and not self.preemption:
                raise RuntimeError("chunked admission stalled with no active "
                                   "slots (allocator invariant violated)")
            if adm.stalls > self.preempt_patience + self.fail_patience + 8:
                sched.retire(adm.slot, "failed")
                return None
        return adm

    def _advance_chunked_admission(self, adm: Optional[_ChunkedAdmission],
                                   sched: Scheduler, cache: M.ModelCache, *,
                                   run_all: bool):
        """Advance the in-flight admission by one step: a prompt segment,
        the finalize (compress), or the insert + first-token sample — each
        costs work in proportion to the prompt, so lumping them together
        would itself stall resident decode. `run_all` drains every step
        back to back (nothing is decoding, so nothing can stall). Returns
        (adm or None, first, seconds): `first` is (slot, first token on
        the device) once the slot goes ACTIVE."""
        if adm is None:
            return None, None, 0.0
        first = None
        cur = adm
        tr, tid = self.trace, adm.slot + 1
        uid = sched.slot_request(adm.slot).uid
        with tr.span("prefill_chunk", tid=tid) as sp:
            while adm is not None:
                i = adm.next_i
                if i == len(adm.segs):              # compress the scratch
                    with tr.span("prefill_finalize", tid=tid,
                                 args=dict(uid=uid)):
                        if adm.direct:
                            adm.pc = M.prefill_finalize_meta(
                                self.cfg, adm.st, self.spec,
                                layer_budgets=self.layer_budgets)
                        else:
                            adm.pc = M.prefill_finalize(
                                self.cfg, adm.st, self.spec,
                                layer_budgets=self.layer_budgets,
                                generator=self.gen)
                    adm.next_i += 1
                elif i == len(adm.segs) + 1:        # insert + first token
                    # the full grant (decode headroom, quantization slack)
                    # is in place before the insert scatters
                    if self.paged and not self._grant(adm, sched,
                                                      adm.total_blocks):
                        adm = self._note_adm_stall(adm, sched)
                        break
                    with tr.span("prefill_insert", tid=tid,
                                 args=dict(uid=uid)):
                        self._insert(cache, sched, adm.slot, adm.pc,
                                     pool_write=not adm.direct,
                                     n_skip=adm.n_adopt)
                        if self._share_state is not None:
                            self._note_inserted(sched, adm,
                                                self._share_state)
                        sched.finish_prefill(adm.slot)
                        first = (adm.slot,
                                 self.sampler(adm.last_logits, self.gen))
                    adm = None
                    break
                else:                               # one prompt segment
                    c0 = adm.starts[i]
                    c1 = c0 + len(adm.segs[i])
                    if self.paged and not self._grant(
                            adm, sched, min(adm.total_blocks,
                                            paging.request_blocks_prefix(
                                                self.spec, self._S_phys, c1,
                                                self.block_len))):
                        # chunk-wise grants: stall until blocks free up
                        adm = self._note_adm_stall(adm, sched)
                        break
                    with tr.span("prefill_segment", tid=tid,
                                 args=dict(uid=uid, c0=c0, c1=c1)):
                        adm.last_logits, _ = M.prefill_chunk(
                            self.params, self.cfg, adm.st,
                            self._h2d(adm.segs[i][None].astype(np.int64)),
                            c0, self.spec)
                        if adm.direct:
                            # prefill-direct: the segment's exact K/V rows
                            # go straight into the slot's granted blocks
                            # (restored prefix rows live in adopted blocks
                            # already)
                            got, bl = (sched.slot_blocks(adm.slot),
                                       self.block_len)
                            rows = np.asarray([got[t // bl] * bl + t % bl
                                               for t in range(c0, c1)],
                                              np.int64)
                            paging.write_prefill_rows(
                                cache.attn, self._h2d(rows),
                                adm.st.k[:, :, :, c0:c1],
                                adm.st.v[:, :, :, c0:c1], batch_axis=2)
                    adm.next_i += 1
                if not run_all:
                    break
        dt = sp.elapsed
        cur.secs += dt
        if first is not None and sched.slot_request(cur.slot).emitted_prefix:
            self._note_readmit(sched.slot_request(cur.slot), cur.secs)
        if first is not None and self._share_state is not None:
            warm = cur.restore_m > 0 or cur.blend
            self._share_state["stats"][
                "warm_prefill_s" if warm else "cold_prefill_s"].append(
                    cur.secs)
        return adm, first, dt

    def _start_admission_timed(self, sched: Scheduler):
        """Start a chunked admission under the prefill stopwatch. Both
        continuous loops go through here: the start can do real prefill
        work (a scratch restore, or a whole CacheBlend forward for a
        near-hit), so its seconds belong to the prefill seconds. Returns
        (admission or None, seconds)."""
        if not sched.pending:
            return None, 0.0
        with self.trace.span("admit_start") as sp:
            adm = self._start_chunked_admission(sched)
        return adm, sp.elapsed

    def _note_readmit(self, req: Request, secs: float) -> None:
        """Account a continuation's re-admission: its prompt's prefill
        seconds and the committed tokens it will replay."""
        self.readmit_prefill_s += secs
        self.replayed_tokens += len(req.emitted_prefix)
        self.recomputed_uids.append(req.uid)

    def _logical_bytes_per_seq(self) -> float:
        """Per-sequence logical cache bytes under the layer budgets."""
        return sum(
            cache_logical_bytes_per_layer(
                self.spec, self.prompt_len + self.max_new,
                self.cfg.num_kv_heads, self.cfg.head_dim)
            * (lb / max(self.spec.budget, 1))
            for lb in self.layer_budgets)

    # ------------------------------------------------------------------
    def generate(self, prompts: np.ndarray,
                 src_embeds: Optional[np.ndarray] = None
                 ) -> GenerationResult:
        """prompts: [n, prompt_len] int (exact bucket length). An
        encoder-decoder reads `src_embeds` [n, Ts, d_model] f32 (the
        stubbed frontend's frames; None: zeros of max(prompt_len // 4,
        16) frames); a padded final wave repeats its last row, as the
        prompts do."""
        if self.paged:
            raise ValueError(
                "the wave path decodes straight off the prefill cache "
                "(dense by construction); build a dense engine for "
                "generate(), paged applies to generate_continuous()")
        if self.speculative:
            raise ValueError(
                "speculative decoding lives in the continuous engine "
                "(per-slot draft state); use generate_continuous()")
        n, L = prompts.shape
        if L != self.prompt_len:
            raise ValueError(f"prompt length {L} != {self.prompt_len}")
        outs = np.zeros((n, self.max_new), np.int32)
        prefill_s = decode_s = 0.0
        phys = logical = 0.0
        fetch = _TokenFetch(self.device, self.slots)
        self.graph_steps = self.graph_captures = 0
        self.graph_capture_s = 0.0

        for w0 in range(0, n, self.slots):
            w1 = min(w0 + self.slots, n)
            wave = prompts[w0:w1]
            pad = self.slots - (w1 - w0)
            if pad:
                wave = np.concatenate([wave, np.repeat(wave[-1:], pad, 0)], 0)
            se = None
            if self.cfg.is_encoder_decoder:
                se = (src_embeds[w0:w1] if src_embeds is not None else
                      np.zeros((w1 - w0, max(L // 4, 16), self.cfg.d_model),
                               np.float32))
                if pad:
                    se = np.concatenate([se, np.repeat(se[-1:], pad, 0)], 0)
            with self.trace.span("wave_prefill",
                                 args=dict(wave=w0 // self.slots)) as sp:
                logits, cache = self._prefill(wave, src_embeds=se)
                tok = self.sampler(logits, self.gen)
                # kvlint: ok(host-sync: prefill's first tokens — once per wave, before the decode loop)
                first = tok.cpu().numpy()
            prefill_s += sp.elapsed
            outs[w0:w1, 0] = first[: w1 - w0]
            ring = RingMirror(self.spec, self.slots)
            ring.fill()
            tok = tok[:, None]
            self._open_graphs(cache, tok)
            sp = self.trace.span("wave_decode",
                                 args=dict(wave=w0 // self.slots))
            sp.__enter__()
            pend, pend_t = None, 0
            for t in range(1, self.max_new):
                tok_dev = self._decode(cache, tok, ring.advance())
                tok = tok_dev[:, None]
                handle = fetch.start(tok_dev)
                if pend is not None:
                    # kvlint: ok(host-sync: the pipelined read — step t-1's tokens, behind step t's dispatch)
                    outs[w0:w1, pend_t] = fetch.get(pend)[: w1 - w0]
                pend, pend_t = handle, t
            if pend is not None:
                # kvlint: ok(host-sync: loop epilogue — the last pending tokens, once per wave)
                outs[w0:w1, pend_t] = fetch.get(pend)[: w1 - w0]
            # kvlint: ok(host-sync: wave epilogue — the wave's decode span ends when the card is done, once per wave)
            self._sync()
            sp.__exit__()
            self._close_graphs()
            decode_s += sp.elapsed
            active = w1 - w0
            cross = (cache.cross_k, cache.cross_v, cache.cross_bias)
            phys += ((kvcache.cache_physical_bytes(cache.attn)
                      + kvcache.tree_bytes(cache.ssm)
                      + kvcache.tree_bytes(cross)) * active / self.slots)
            logical += self._logical_bytes_per_seq() * active
        full = (self.cfg.kv_bytes_per_token()
                * (self.prompt_len + self.max_new) * n)
        return GenerationResult(
            tokens=outs, prefill_seconds=prefill_s, decode_seconds=decode_s,
            decode_tokens_per_s=n * (self.max_new - 1) / max(decode_s, 1e-9),
            cache_physical_bytes=int(phys),
            cache_logical_bytes=float(logical),
            full_cache_bytes=float(full),
            compression_ratio=float(full / max(logical, 1.0)),
            policy_name=self.policy.name, graph_steps=self.graph_steps,
            graph_captures=self.graph_captures,
            graph_capture_seconds=self.graph_capture_s)

    # ------------------------------------------------------------------
    def generate_continuous(
        self, requests: Sequence[Union[Request, np.ndarray]], *,
        buckets: Optional[Sequence[int]] = None,
    ) -> ContinuousGenerationResult:
        """Serve `requests` through one persistent `slots`-wide cache.

        Each request is prefilled at its prompt bucket (batch 1; chunked:
        segment by segment between decode steps) and copied into a free
        batch slot; every decode step advances all active slots at once;
        a request hitting its `eos_id` or `max_new` retires immediately
        and its slot (paged: its blocks) goes to the next queued request.
        Bare arrays become `Request(tokens, max_new=self.max_new)`.
        Decoder-only archs (an encoder-decoder raises, as in JAX)."""
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "continuous batching is decoder-only for now (enc-dec "
                "requests carry per-request cross memory)")
        if buckets and max(int(b) for b in buckets) > self.prompt_len:
            raise ValueError(
                f"bucket {max(int(b) for b in buckets)} exceeds engine "
                f"prompt_len {self.prompt_len}")
        if buckets and (self.chunked_prefill or self.prefix_sharing):
            self._check_aligned(buckets)
        self.flush_steps = 0
        self.dispatch_s = self.token_wait_s = 0.0
        self.graph_steps = self.graph_captures = 0
        self.graph_capture_s = 0.0
        self._graphs = None
        self.replayed_tokens = 0
        self.readmit_prefill_s = 0.0
        self.recomputed_uids = []
        self._share_state = None
        if self.speculative:
            # draft / verify loop: synchronous rounds, since drafting needs
            # each round's committed tokens
            return spec_lib.generate_continuous_spec(self, requests,
                                                     buckets=buckets)
        sched = self._new_scheduler(buckets)
        for r in requests:
            if not isinstance(r, Request):
                r = Request(tokens=r, max_new=self.max_new)
            if r.max_new > self.max_new:
                raise ValueError(f"request max_new {r.max_new} exceeds "
                                 f"engine headroom {self.max_new}")
            sched.submit(r)

        # KV tiering: a fresh host tier and its own pressure controller per
        # run (the degrade watermarks: the spill rung engages at the same
        # pressure, one rung earlier in the ladder)
        tier: Optional[paging.HostTier] = None
        tier_ctrl = None
        self._tier_aux = {}
        self._tier_stripped = 0
        if self.tiering:
            from repro_torch.serving.adaptive import PressureController
            tier = paging.HostTier(self.host_blocks,
                                   fault_plan=self.fault_plan,
                                   tracer=self.trace)
            tier_ctrl = PressureController(high_water=0.85, low_water=0.60,
                                           tracer=self.trace)
        self.host_tier = tier
        self.tier_pressure = tier_ctrl

        share = None
        if self.prefix_sharing:
            align = math.lcm(self.block_len, MASS_GROUP)
            index = prefix_lib.PrefixIndex(self.block_len, align=align,
                                           tracer=self.trace)
            share = self._share_state = dict(
                index=index,
                mirror=spec_lib.CacheMirror(self.spec, self.layer_budgets,
                                            self._S_phys, self.slots),
                upto={},            # slot -> leading blocks mapped shared
                align=align,
                near_ok=(self.near_hit > 0
                         and self.spec.policy == "none"
                         and M.sb_layout(self.cfg)[0] == 1),
                stats=dict(warm_hits=0, cold=0, near_hits=0, cow_copies=0,
                           ingested_blocks=0, evicted_blocks=0,
                           peak_mapped_blocks=0, warm_prefill_s=[],
                           cold_prefill_s=[]))

            def reclaim(shortfall: int) -> None:
                # resident requests outrank the prompt cache: with the
                # tier, cold index blocks demote to host first (warm hits
                # survive the churn); what it cannot absorb goes, LRU
                # leaf first
                if tier is not None:
                    shortfall -= demote_index_blocks(shortfall)
                if shortfall <= 0:
                    return
                freed = index.evict(shortfall, self.block_allocator)
                share["stats"]["evicted_blocks"] += len(freed)
                sched.release(-1, freed)

            sched.reclaim = reclaim
            if tier is not None:
                # tier-aware admission: free + spillable-cold coverage
                # (the scheduler's second reclaim pass converts it)
                sched.spillable = lambda: min(
                    index.spillable(self.block_allocator), tier.free_blocks)

        cache = M.init_cache(self.cfg, self.spec, self.slots,
                             self.prompt_len + self.max_new,
                             layer_budgets=self.layer_budgets,
                             device=self.device, paged=self.paged,
                             block_len=self.block_len,
                             pool_blocks=self.pool_blocks)
        next_tok = np.zeros(self.slots, np.int32)
        prefill_s = 0.0
        decode_tokens = 0
        # slots known to hold the empty-cache state: a refused admission
        # resets a slot at most once
        clean_slots = set(range(self.slots))
        ring = RingMirror(self.spec, self.slots)
        fetch = _TokenFetch(self.device, self.slots)
        first_fetch = _TokenFetch(self.device, 1)

        # lazy growth: a host mirror of each slot's row usage (append and
        # flush timing depend only on counts, so no device read decides a
        # grant)
        lazy_mirror = (spec_lib.CacheMirror(self.spec, self.layer_budgets,
                                            self._S_phys, self.slots)
                       if self.lazy_blocks else None)
        # pipeline and preemption state (admissions may preempt, and
        # `preempt_slot` reads the in-flight token reads)
        pending = None                          # (fetch handle, valid slots)
        first_pending = None                    # (slot, fetch handle)
        replay: dict = {}     # slot -> committed tokens still to re-feed
        step_idx = 0                            # dispatches so far
        preempt_due = list(self.preempt_at)     # forced (step, slot) pairs

        def reset(slot_idx: int) -> None:
            """Clear the slot so stale KV never leaks into a later
            occupant or the accounting — paged, so a stale table never
            routes the free slot's garbage appends into re-granted
            blocks."""
            self._reset(cache, slot_idx)
            ring.clear(slot_idx)
            clean_slots.add(slot_idx)
            if lazy_mirror is not None:
                lazy_mirror.reset(slot_idx)
            if share is not None:
                share["upto"].pop(slot_idx, None)
                share["mirror"].reset(slot_idx)

        def fold_pending(s: int) -> Optional[str]:
            """Record slot `s`'s committed-but-unread token before the slot
            is cleared: a decode token riding `pending`, or a chunk-admitted
            first token riding `first_pending`. Returns the finish reason
            that token gave (None: none, or nothing was in flight)."""
            nonlocal first_pending, decode_tokens
            if pending is not None and s in pending[1]:
                decode_tokens += 1
                pending[1].remove(s)
                # kvlint: ok(host-sync: a preemption or starved retire is a rare pressure event — read the pending token before the slot is cleared)
                return sched.record_token(s, fetch.get(pending[0])[s])
            if first_pending is not None and first_pending[0] == s:
                handle = first_pending[1]
                first_pending = None
                # kvlint: ok(host-sync: a preemption or starved retire is a rare pressure event — read the pending first token before the slot is cleared)
                return sched.record_token(s, int(first_fetch.get(handle)[0]))
            return None

        def preempt_slot(s: int) -> bool:
            """Preempt slot `s`: fold its in-flight token into the record,
            then requeue prompt + emitted tokens as a continuation and clear
            the slot (its blocks return to the pool). If the folded token
            finished the request it retires instead. The slot's stale
            append of the step in flight precedes the reset on the stream.
            True when the slot was preempted (not retired)."""
            reason = fold_pending(s)
            if reason is not None:
                sched.retire(s, reason)
            else:
                # preempt to host: snapshot the blocks, the metadata row
                # and the host mirrors before `preempt` releases the ids;
                # the ticketed continuation restores instead of
                # recomputing (tier off or full, or nothing emitted yet:
                # recompute-on-resume)
                h = spill_slot(s)
                req = sched.preempt(s)
                if h is not None:
                    req.tier_ticket = h
                    req.tier_blocks = self._tier_aux[h]["n"]
            reset(s)
            replay.pop(s, None)
            return reason is None

        def degrade_tick() -> None:
            """The degrade rung: above the controller's high-water mark,
            resident quantized slots drop their oldest flushed non-sink
            groups until the shortfall is freed — reversible quality loss
            instead of preemption. Mid-replay and sharing slots are kept
            exact; a slot with uneven layer lengths is skipped (one table
            permutation serves every layer)."""
            ctrl = self.pressure
            shortfall = ctrl.shortfall(self.block_allocator)
            if shortfall <= 0:
                return
            G = self.spec.group
            for s in sched.active_slots():
                if shortfall <= 0:
                    break
                if s in replay:
                    continue
                if share is not None and share["upto"].get(s):
                    continue
                lens = lazy_mirror.length[s]
                if int(lens.min()) != int(lens.max()):
                    continue
                n = min(int(lens[0]) // G - ctrl.keep_groups, shortfall)
                if n <= 0:
                    continue
                paging.degrade_slot_groups(cache.attn, self.spec, s, n,
                                           batch_axis=2)
                tbl = cache.attn.block_tbl
                # kvlint: ok(host-sync: pressure-driven degrade is a rare event — the table read is off the steady-state step)
                row = tbl.reshape(-1, *tbl.shape[-2:])[0, s].cpu().numpy()
                dropped = sched.replace_blocks(
                    s, [int(b) for b in row if b >= 0])
                lazy_mirror.drop_rows(s, len(dropped) * G)
                if share is not None:
                    share["mirror"].drop_rows(s, len(dropped) * G)
                ctrl.note_degrade(len(dropped))
                shortfall -= len(dropped)

        # --- the tier's closures (no-ops with tiering off). The pools are
        # written in place and every gather is enqueued on the main
        # stream, so a demotion fired from inside a chunked admission's
        # grant reads the pool as it stands there.
        def demote_index_blocks(shortfall: int) -> int:
            """Cold source (a): prefix blocks past their last adopter
            (refcount 1) demote to host, LRU first, instead of being freed;
            a later warm hit pages them back (`promote_for_head`). Returns
            the device blocks freed."""
            if tier is None or share is None:
                return 0
            index = share["index"]
            freed = 0
            while freed < shortfall:
                node = index.demote_candidate(self.block_allocator)
                if node is None:
                    break
                h = tier.begin_spill(paging.gather_pool_blocks(
                    cache.attn, self._h2d_ids([node.block_id]),
                    batch_axis=2), 1)
                if h is None:
                    break                       # host tier full
                bid = node.block_id
                index.mark_host(node, h)
                sched.release(-1, [bid])
                sched.note_swap(-1, spills=1, bytes_moved=tier.nbytes_of(h))
                freed += 1
            if freed and tier_ctrl is not None:
                tier_ctrl.note_spill(freed)
            return freed

        def spill_tick() -> None:
            """The spill rung, ahead of degradation: above the tier
            controller's high-water mark, demote cold index blocks, then
            strip the granted-but-unwritten blocks of a stalled chunked
            admission (its scratch holds the rows, so its blocks carry no
            data yet; the grant loop asks for them again)."""
            shortfall = tier_ctrl.shortfall(self.block_allocator)
            if shortfall <= 0:
                return
            shortfall -= demote_index_blocks(shortfall)
            if (shortfall > 0 and adm is not None and not adm.direct
                    and not adm.blend and adm.stalls > 0
                    and adm.granted > adm.n_adopt):
                n_strip = min(shortfall, adm.granted - adm.n_adopt)
                freed = sched.release_blocks(adm.slot, n_strip)
                adm.granted -= len(freed)
                self._tier_stripped += len(freed)

        def spill_slot(s: int) -> Optional[int]:
            """Snapshot slot `s`'s pool blocks and metadata row (and its
            host mirrors: the ring, the lazy-growth and sharing rows) into
            the tier. The gather is enqueued now, behind the step in
            flight; the caller frees the ids at once; the host copy lands
            on the side stream and drains next iteration. The ticket, or
            None when the slot cannot restore exactly (mid-replay, nothing
            emitted yet) or the tier is full."""
            if tier is None or s in replay or sched.emitted_total(s) == 0:
                return None
            ids = sched.slot_blocks(s)
            if not ids:
                return None
            payload = dict(
                blocks=paging.gather_pool_blocks(
                    cache.attn, self._h2d_ids(ids), batch_axis=2),
                meta=paging.gather_slot_meta(cache.attn, s, batch_axis=2))
            if cache.ssm is not None:
                # the slot's SSM leaves ride with its blocks: a restored
                # hybrid request resumes from its own recurrent state
                payload["ssm"] = {
                    f: t.narrow(2, s, 1).clone()
                    for f, t in zip(kvcache.SSMState._fields, cache.ssm)}
            h = tier.begin_spill(payload, len(ids))
            if h is None:
                return None         # host full: recompute-on-resume
            aux: dict = dict(n=len(ids), ring=int(ring.rlen[s]))
            if lazy_mirror is not None:
                aux["lazy"] = lazy_mirror.snapshot(s)
            if share is not None:
                aux["share"] = share["mirror"].snapshot(s)
            self._tier_aux[h] = aux
            sched.note_swap(s, spills=len(ids),
                            bytes_moved=tier.nbytes_of(h))
            return h

        def try_restore(slot_idx: int, req: Request) -> bool:
            """Land a ticketed continuation's saved blocks in its fresh
            grant and resume from its last emitted token: no re-prefill,
            no replay (the bytes are checksum-verified). A refused fetch
            (injected fault) consumes the ticket and returns False: the
            caller falls back to recompute-on-resume."""
            h = req.tier_ticket
            req.tier_ticket = None
            req.tier_blocks = 0
            aux = self._tier_aux.pop(h, None)
            got = tier.fetch(h)
            if got is None:                 # refused: the bytes are gone
                return False
            payload, nbytes, stall = got
            dev = tier.upload(payload, self.device)
            k = aux["n"]
            ids = sched.slot_blocks(slot_idx)
            paging.scatter_pool_blocks(cache.attn, self._h2d_ids(ids[:k]),
                                       dev["blocks"], batch_axis=2)
            paging.scatter_slot_meta(cache.attn, slot_idx, dev["meta"],
                                     batch_axis=2)
            if cache.ssm is not None:
                kvcache.insert_request_tree(
                    cache.ssm, slot_idx,
                    kvcache.SSMState(**dev["ssm"]), batch_axis=2)
            # map the whole grant: the k saved blocks plus any headroom
            # the re-admission granted past them
            row = np.full(self.n_max_blocks, -1, np.int32)
            row[:len(ids)] = ids
            paging.write_block_table(cache.attn, slot_idx, 0,
                                     self._h2d(row), batch_axis=2)
            clean_slots.discard(slot_idx)
            ring.rlen[slot_idx] = aux["ring"]
            if lazy_mirror is not None:
                lazy_mirror.restore(slot_idx, aux["lazy"])
            if share is not None:
                # the row mirror only: the restored slot owns fresh
                # exclusive ids, so no copy-on-write watch set comes back
                share["mirror"].restore(slot_idx, aux["share"])
            sched.note_swap(slot_idx, fetches=k, bytes_moved=nbytes,
                            stall_s=stall)
            next_tok[slot_idx] = req.emitted_prefix[-1]
            return True

        def admit_ticket_head() -> None:
            """Loop-top admission of a ticketed (spill-preempted)
            continuation under chunked admission: `admit_next` sizes the
            grant through `_request_blocks` (at least the saved blocks),
            then the fetch lands the snapshot in the granted ids. Outside
            the chunked machinery: there is no prompt left to stream."""
            nonlocal prefill_s
            free = sched.free_slots()
            if not free:
                return
            i = free[0]
            req = sched.admit_next(i)
            if req is None:
                # refused: a victim past the patience, or with nothing
                # running the ticket is dropped (the head retries as a
                # plain recompute continuation)
                self._retry_refused_admission(sched, True, preempt_slot,
                                              tuple(replay))
                return
            with self.trace.span("restore", tid=i + 1,
                                 args=dict(uid=req.uid)) as sp:
                ok = try_restore(i, req)
            prefill_s += sp.elapsed
            if ok:
                set_tokens({i: int(next_tok[i])})
            else:
                # refused before anything ran in the slot: requeue at the
                # front as an ordinary recompute-on-resume continuation
                sched.preempt(i)

        def promote_for_head() -> None:
            """Pre-admission paging of a warm hit on demoted prefix
            blocks: fetch the head prompt's host-resident nodes into
            freshly allocated blocks, so `match` hands the admission the
            whole read-only hit. A refused fetch drops the node's subtree
            (its bytes are gone); an empty free list leaves the admission
            the partial (device-resident) hit."""
            if tier is None or share is None or not sched.pending:
                return
            req = sched.head_request()
            if req is None or not self._share_retained(len(req.tokens)):
                return
            index = share["index"]
            for node in index.match_nodes(req.tokens):
                if node.host is None:
                    continue
                got_ids = self.block_allocator.alloc(1)
                if got_ids is None:
                    break
                got = tier.fetch(node.host)
                if got is None:
                    dev_ids, handles = index.drop_node(node)
                    sched.release(-1, dev_ids)
                    for hh in handles:
                        tier.drop(hh)
                    sched.release(-1, got_ids)
                    break
                payload, nbytes, stall = got
                paging.scatter_pool_blocks(
                    cache.attn, self._h2d_ids(got_ids),
                    tier.upload(payload, self.device), batch_axis=2)
                index.promote(node, got_ids[0])
                sched.note_swap(-1, fetches=1, bytes_moved=nbytes,
                                stall_s=stall)

        def set_tokens(feed: dict) -> None:
            """Overwrite `tok_in` at the given slots with host tokens: one
            indexed write, no sync."""
            nonlocal tok_in
            idx = self._h2d_ids(list(feed))
            vals = self._h2d(np.array(list(feed.values()), np.int32))
            tok_in = tok_in.index_put((idx,), vals)

        def admit_into(slot_idx: int, ladder: bool = False) -> bool:
            """Fill a free slot from the queue: batch-1 prefill, copy into
            the live cache, record the first token. Loops in case a
            request finishes on its first token. True when a request now
            occupies the slot (its next feed in `next_tok`). Paged,
            `admit_next` refuses while the pool cannot cover the head;
            the slot then idles until a retire frees blocks. `ladder`
            (only at the loop top, never mid-record) lets a refused
            admission preempt a victim for its blocks."""
            nonlocal prefill_s
            while True:
                req = sched.admit_next(slot_idx)
                if req is None:
                    # replaying slots are never victims: a victim's
                    # progress must have grown since its last preemption
                    # (convergence)
                    if (self.paged and sched.pending
                            and self._retry_refused_admission(
                                sched, ladder, preempt_slot, tuple(replay))):
                        continue
                    if slot_idx not in clean_slots:
                        reset(slot_idx)
                    return False
                if tier is not None and req.tier_ticket is not None:
                    # ticketed continuation: land the snapshot in the grant
                    # instead of re-prefilling; a refused fetch falls
                    # through to recompute-on-resume below
                    with self.trace.span("restore", tid=slot_idx + 1,
                                         args=dict(uid=req.uid)) as sp:
                        ok = try_restore(slot_idx, req)
                    prefill_s += sp.elapsed
                    if ok:
                        return True
                with self.trace.span("prefill", tid=slot_idx + 1,
                                     args=dict(uid=req.uid)) as sp:
                    logits, pc = self._prefill(req.tokens[None])
                    tok = self.sampler(logits, self.gen)
                    self._insert(cache, sched, slot_idx, pc)
                    ring.fill(slot_idx)
                    clean_slots.discard(slot_idx)
                    if lazy_mirror is not None:
                        lazy_mirror.admit(slot_idx, len(req.tokens))
                    # kvlint: ok(host-sync: admission prefill's first token — once per admitted request, not per decode step)
                    tok_i = int(tok.item())
                prefill_s += sp.elapsed
                if req.emitted_prefix:
                    self._note_readmit(req, sp.elapsed)
                    # recompute-on-resume: the prefill covered the prompt;
                    # the committed tokens now replay through ordinary
                    # decode steps (outputs discarded), each the decode step
                    # it repeats. Nothing is recorded: the prefix holds
                    # this prefill's first token already.
                    next_tok[slot_idx] = req.emitted_prefix[0]
                    replay[slot_idx] = list(req.emitted_prefix[1:])
                    return True
                next_tok[slot_idx] = tok_i
                reason = sched.record_token(slot_idx, tok_i)
                if reason is None:
                    return True
                sched.retire(slot_idx, reason)   # 1-token request; refill

        use_adm = self.chunked_prefill or self.prefix_sharing
        if not use_adm:
            for i in range(self.slots):
                admit_into(i)

        # Double-buffered decode: step N+1 is dispatched from step N's
        # device-side tokens before the host reads step N's tokens. A
        # slot that retires (or is preempted) at step N already has a
        # stale step N+1 in flight: its output is dropped from the valid
        # set, and the admission's insert (or the reset) overwrites the
        # slot, wiping the stale append, before the next dispatch; every
        # write runs on one stream in that order. A chunked admission
        # joins the dispatch after its insert with its first token
        # device-side; the host reads that token one iteration later.
        tok_in = torch.as_tensor(next_tok, device=self.device)
        self._open_graphs(cache, tok_in[:, None])
        adm: Optional[_ChunkedAdmission] = None
        # per-iteration telemetry: pre-bound instruments, host mirrors only
        # (the allocator's free list, the scheduler's active set)
        trace = self.trace
        mx = self.metrics
        g_free = mx.gauge("pool.free_frac")
        g_active = mx.gauge("slots.active")
        c_iters = mx.counter("engine.loop_iters")
        loop_t0 = time.perf_counter()
        prefill_at_loop = prefill_s
        while True:
            it_t0 = time.perf_counter()
            if tier is not None:
                # land last iteration's spill copies: each waits on its
                # own copy event (the step in flight keeps running)
                tier.drain()
            if use_adm and adm is None:
                if tier is not None and sched.pending:
                    head = sched.head_request()
                    if head is not None and head.tier_ticket is not None:
                        tier.prefetch(head.tier_ticket)
                        admit_ticket_head()
                    else:
                        promote_for_head()
                adm, dt = self._start_admission_timed(sched)
                prefill_s += dt
            if preempt_due:
                # forced preemptions: the deterministic preempt-at-step-k
                # hook (dispatch count, as the JAX engine's)
                for k_s in [x for x in preempt_due if x[0] == step_idx]:
                    preempt_due.remove(k_s)
                    if k_s[1] in sched.active_slots():
                        preempt_slot(k_s[1])
            self._escalate_stall(sched, adm, preempt_slot, tuple(replay))
            if self.preemption and not use_adm and sched.pending:
                # admission retry sweep: a head refused earlier may fit
                # now, or may claim a victim through the ladder
                for i in sched.free_slots():
                    if not sched.pending or not admit_into(i, ladder=True):
                        break
                    set_tokens({i: int(next_tok[i])})
            if tier_ctrl is not None:
                spill_tick()
            if self.pressure is not None:
                degrade_tick()
            active = sched.active_slots()
            if (self.audit_every and step_idx
                    and step_idx % self.audit_every == 0):
                # kvlint: ok(host-sync: periodic pool audit reads the device block table — every audit_every dispatches, off by default)
                self._run_audit(sched, cache)
                if trace:
                    trace.instant("audit", args=dict(step=step_idx))
            if lazy_mirror is not None and active:
                # lazy growth: every slot joining this dispatch needs table
                # coverage for the row it appends. A slot the pool cannot
                # grow climbs the ladder, or without it retires "oom" (its
                # in-flight token recorded first). Refilled slots join the
                # worklist, so their first append is covered too.
                worklist = list(active)

                def evict(v: int) -> None:
                    preempt_slot(v)
                    for q in (active, worklist):
                        if v in q:
                            q.remove(v)

                while worklist:
                    s = worklist.pop(0)
                    rows = lazy_mirror.rows_after_feeds(s, 1)
                    if self._climb_ladder(
                            sched, s,
                            lambda: self._grow_blocks(sched, cache, s, rows),
                            evict, tuple(replay)) != "oom":
                        continue
                    sched.retire(s, fold_pending(s) or "oom")
                    reset(s)
                    active.remove(s)
                    if sched.pending and not use_adm:
                        for i in sched.free_slots():
                            if not sched.pending or not admit_into(i):
                                break
                            set_tokens({i: int(next_tok[i])})
                            active.append(i)
                            worklist.append(i)
            if share is not None and active:
                # copy-on-write: a slot whose next append could flush an
                # eviction into its shared prefix blocks un-shares them
                # first (fresh blocks, a device row copy, a table
                # rewrite); all leading shared blocks swap at once, since
                # the evicted group depends on the data
                for s in [s for s in list(active) if share["upto"].get(s)]:
                    if not self._cow_due(share["mirror"], s):
                        continue
                    n_watch = share["upto"][s]
                    res = sched.cow_swap(s, n_watch)
                    if res is None:
                        # the pool cannot cover the whole un-share. A copy
                        # is needed only for blocks another resident slot
                        # maps (refcount >= 3: slot + index + other); the
                        # index gives up its claim on the rest (refcounts
                        # fall with trie depth, so the must-copy set is a
                        # prefix)
                        ids_w = sched.slot_blocks(s)[:n_watch]
                        rc = self.block_allocator.refcount
                        n_copy = 0
                        while n_copy < n_watch and rc(ids_w[n_copy]) >= 3:
                            n_copy += 1
                        dropped = share["index"].disown(ids_w[n_copy:])
                        share["stats"]["evicted_blocks"] += len(dropped)
                        sched.release(-1, dropped)
                        if tier is not None:
                            # demoted descendants the cascade unrooted:
                            # their bytes die with the trie
                            for hh in share["index"].take_orphaned_handles():
                                tier.drop(hh)
                        res = (([], []) if n_copy == 0
                               else sched.cow_swap(s, n_copy))
                    if res is not None:
                        old, new = res
                        if new:
                            paging.copy_pool_blocks(
                                cache.attn, self._h2d_ids(old),
                                self._h2d_ids(new), batch_axis=2)
                            paging.write_block_table(
                                cache.attn, s, 0,
                                self._h2d_ids(new, np.int32), batch_axis=2)
                            share["stats"]["cow_copies"] += 1
                            if trace:
                                trace.instant("cow", tid=s + 1,
                                              args=dict(blocks=len(new)))
                        share["upto"].pop(s)
                        continue
                    # the pool cannot cover the un-share: retire the slot
                    # "oom", its committed-but-unread token recorded first
                    sched.retire(s, fold_pending(s) or "oom")
                    reset(s)
                    active.remove(s)
            new_pending = None
            if active:
                tok_dev = self._decode(cache, tok_in[:, None], ring.advance())
                sched.note_decode_step()
                step_idx += 1
                new_pending = (fetch.start(tok_dev), list(active))
                tok_in = tok_dev                # feed N+1 from N, no sync
                if replay:
                    # recompute-on-resume: while a slot replays, a
                    # dispatch's output recomputes an already-committed
                    # token: drop it from the valid set and feed the next
                    # committed token instead. With the queue empty the
                    # dispatch just fed the last committed token, so its
                    # output is the first new one and stays valid.
                    feed = {}
                    for s in [s for s in list(replay) if s in active]:
                        if replay[s]:
                            new_pending[1].remove(s)
                            feed[s] = replay[s].pop(0)
                        else:
                            del replay[s]
                    if feed:
                        set_tokens(feed)
                if lazy_mirror is not None:
                    for s in active:
                        lazy_mirror.append(s, 1)
                if share is not None:
                    for s in active:
                        share["mirror"].append(s, 1)
            if first_pending is not None:
                slot0, fhandle = first_pending
                with trace.span("token_wait") as sp:
                    # kvlint: ok(host-sync: pipelined — last iteration's chunk-admitted first token, read behind this dispatch)
                    tok_i = int(first_fetch.get(fhandle)[0])
                self.token_wait_s += sp.elapsed
                next_tok[slot0] = tok_i
                reason = sched.record_token(slot0, tok_i)
                if reason is not None:
                    sched.retire(slot0, reason)         # 1-token request
                    if new_pending is not None and slot0 in new_pending[1]:
                        new_pending[1].remove(slot0)
                    reset(slot0)
                first_pending = None
            if use_adm:
                # at most one admission step per decode step; with nothing
                # decoding there is nothing to stall, so drain it
                adm, first, dt = self._advance_chunked_admission(
                    adm, sched, cache, run_all=not active)
                prefill_s += dt
                if first is not None:
                    slot0, ftok = first
                    ring.fill(slot0)
                    clean_slots.discard(slot0)
                    creq = sched.slot_request(slot0)
                    if lazy_mirror is not None:
                        lazy_mirror.admit(slot0, len(creq.tokens))
                    if creq.emitted_prefix:
                        # chunk-admitted continuation: its recomputed first
                        # token is in the prefix already; seed the replay
                        set_tokens({slot0: int(creq.emitted_prefix[0])})
                        replay[slot0] = list(creq.emitted_prefix[1:])
                    else:
                        tok_in[slot0:slot0 + 1] = ftok   # device to device
                        first_pending = (slot0, first_fetch.start(ftok))
            if share is not None:
                # distinct blocks the occupied slots map (the allocator's
                # peak also counts the lingering prompt cache)
                mapped = len({i for ids in sched.occupied_blocks().values()
                              for i in ids})
                st = share["stats"]
                st["peak_mapped_blocks"] = max(st["peak_mapped_blocks"],
                                               mapped)
            n_active = len(active)
            if mx:
                g_active.set(n_active)
                c_iters.inc()
                if self.paged:
                    g_free.set(self.block_allocator.available
                               / max(self.pool_blocks, 1))
            if trace:
                trace.complete("step", it_t0, args=dict(active=n_active))
                if self.paged:
                    trace.counter("pool", dict(
                        free=self.block_allocator.available,
                        active=n_active))
            if (pending is None and new_pending is None and adm is None
                    and first_pending is None and not sched.pending):
                break
            if pending is not None:
                handle, pvalid = pending
                with trace.span("token_wait") as sp:
                    # kvlint: ok(host-sync: the one pipelined read — step N-1's tokens, behind step N's dispatch)
                    toks = fetch.get(handle)
                self.token_wait_s += sp.elapsed
                with trace.span("retire"):
                    admitted = []
                    retired_any = False
                    for i in pvalid:
                        decode_tokens += 1
                        reason = sched.record_token(i, toks[i])
                        if reason is not None:
                            sched.retire(i, reason)
                            retired_any = True
                            if new_pending is not None and i in new_pending[1]:
                                new_pending[1].remove(i)
                            if use_adm:
                                # admissions start at the top of the loop
                                reset(i)
                            elif admit_into(i):
                                admitted.append(i)
                    if self.paged and retired_any and sched.pending \
                            and not use_adm:
                        # a retire frees blocks, not just its slot: a slot
                        # refused while the pool was exhausted may fit now
                        # (FIFO: the first refusal settles the rest)
                        for i in sched.free_slots():
                            if not sched.pending or not admit_into(i):
                                break
                            admitted.append(i)
                    if admitted:
                        set_tokens({i: int(next_tok[i]) for i in admitted})
            pending = new_pending
        decode_s = ((time.perf_counter() - loop_t0)
                    - (prefill_s - prefill_at_loop))
        self._close_graphs()
        if self.paged:
            # every run ends with a host-side audit: all slots retired, so
            # every block still allocated must be the prefix index's
            if tier is not None:
                tier.drain()
            self._run_audit(sched)
        return self._continuous_result(sched, cache, prefill_s=prefill_s,
                                       decode_s=decode_s,
                                       decode_tokens=decode_tokens)

    def _continuous_result(self, sched: Scheduler, cache: M.ModelCache, *,
                           prefill_s: float, decode_s: float,
                           decode_tokens: int, spec_stats=None
                           ) -> ContinuousGenerationResult:
        """Accounting shared by the plain and speculative loops."""
        pool_stats = {}
        if self.paged:
            # real pool usage, not the reserved worst case: the blocks the
            # run pinned at its high-water mark, plus the dense metadata
            per_block = paging.bytes_per_block(cache.attn)
            meta = (kvcache.tree_bytes(cache.attn)
                    - paging.pool_bytes(cache.attn)
                    + kvcache.tree_bytes(cache.ssm))
            peak = self.block_allocator.peak_used
            phys = meta + peak * per_block
            pool_stats = dict(pool_blocks=self.pool_blocks,
                              pool_block_bytes=per_block,
                              pool_peak_blocks=peak)
        else:
            phys = (kvcache.cache_physical_bytes(cache.attn)
                    + kvcache.tree_bytes(cache.ssm))
        results = sorted(sched.results, key=lambda r: r.uid)
        ttfts = [r.ttft_s for r in results if r.finish_reason != "failed"]
        prefix_stats = None
        if self._share_state is not None:
            prefix_stats = dict(self._share_state["stats"],
                                index_blocks=len(self._share_state["index"]))
        tier_stats = None
        if self.host_tier is not None:
            tier_stats = dict(self.host_tier.stats)
            tier_stats.update(
                host_blocks=self.host_tier.capacity_blocks,
                host_entries=len(self.host_tier.handles()),
                host_resident=self.host_tier.resident_blocks,
                n_spills=sched.n_spills, n_fetches=sched.n_fetches,
                bytes_moved=sched.bytes_moved,
                fetch_stall_s=sched.fetch_stall_s,
                grants_stripped=self._tier_stripped,
                # transport compression: what one block costs to move
                # against fp16 (the uncompressed-offload baseline)
                block_bytes=paging.bytes_per_block(cache.attn),
                fp16_block_bytes=paging.block_fp16_bytes(cache.attn,
                                                         self.spec))
            if self.tier_pressure is not None:
                tier_stats["pressure"] = dict(self.tier_pressure.stats)
        logical = self._logical_bytes_per_seq() * self.slots
        full = (self.cfg.kv_bytes_per_token()
                * (self.prompt_len + self.max_new) * self.slots)
        res = ContinuousGenerationResult(
            results=results, prefill_seconds=prefill_s,
            decode_seconds=decode_s, decode_steps=sched.decode_steps,
            decode_tokens=decode_tokens,
            decode_tokens_per_s=decode_tokens / max(decode_s, 1e-9),
            occupancy=sched.occupancy,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            cache_physical_bytes=int(phys),
            cache_logical_bytes=float(logical),
            full_cache_bytes=float(full),
            compression_ratio=float(full / max(logical, 1.0)),
            policy_name=self.policy.name, spec=spec_stats,
            prefix=prefix_stats, kv_flush_steps=self.flush_steps,
            replayed_tokens=self.replayed_tokens,
            readmit_prefill_s=self.readmit_prefill_s,
            recomputed_uids=list(self.recomputed_uids), tier=tier_stats,
            dispatch_seconds=self.dispatch_s,
            token_wait_seconds=self.token_wait_s,
            graph_steps=self.graph_steps, graph_captures=self.graph_captures,
            graph_capture_seconds=self.graph_capture_s, **pool_stats)
        self._publish_metrics(sched, res)
        return res

    def _publish_metrics(self, sched: Scheduler,
                         res: ContinuousGenerationResult) -> None:
        """End-of-run aggregates into the metrics registry (nothing under
        the default `NULL_METRICS`), named as the JAX engine names them:
        gauges carry run-level rates, counters event totals, histograms
        the per-request latency distributions (TTFT, inter-token gaps)."""
        mx = self.metrics
        if not mx:
            return
        mx.gauge("run.prefill_s").set(res.prefill_seconds)
        mx.gauge("run.decode_s").set(res.decode_seconds)
        mx.gauge("run.decode_tok_s").set(res.decode_tokens_per_s)
        mx.gauge("run.occupancy").set(res.occupancy)
        mx.gauge("run.ttft_mean_s").set(res.ttft_mean_s)
        mx.gauge("run.compression_ratio").set(res.compression_ratio)
        mx.gauge("cache.physical_bytes").set(res.cache_physical_bytes)
        mx.gauge("cache.logical_bytes").set(res.cache_logical_bytes)
        mx.counter("engine.decode_steps").inc(res.decode_steps)
        mx.counter("engine.decode_tokens").inc(res.decode_tokens)
        mx.counter("sched.preemptions").inc(sched.n_preemptions)
        mx.counter("sched.retries").inc(sched.n_retries)
        h_ttft = mx.histogram("request.ttft_s")
        h_gap = mx.histogram("request.inter_token_s")
        n_done = n_failed = 0
        for r in res.results:
            if r.finish_reason == "failed":
                n_failed += 1
                continue
            n_done += 1
            h_ttft.observe(r.ttft_s)
            for gap in np.diff(r.token_times):
                h_gap.observe(float(gap))
        mx.counter("requests.completed").inc(n_done)
        mx.counter("requests.failed").inc(n_failed)
        if res.tier is not None:
            mx.counter("tier.spills").inc(res.tier["n_spills"])
            mx.counter("tier.fetches").inc(res.tier["n_fetches"])
            mx.counter("tier.bytes_moved").inc(res.tier["bytes_moved"])
            mx.gauge("tier.fetch_stall_s").set(res.tier["fetch_stall_s"])
        if self.pressure is not None:
            mx.counter("pressure.degrades").inc(
                self.pressure.stats["degrades"])
            mx.counter("pressure.blocks_dropped").inc(
                self.pressure.stats["blocks_dropped"])
        if res.prefix is not None:
            mx.counter("prefix.warm_hits").inc(res.prefix["warm_hits"])
            mx.counter("prefix.cold").inc(res.prefix["cold"])
            mx.counter("prefix.near_hits").inc(res.prefix["near_hits"])
            mx.counter("prefix.cow_copies").inc(res.prefix["cow_copies"])
        if res.spec is not None:
            mx.gauge("spec.accept_rate").set(res.spec.acceptance_rate)
            mx.counter("spec.rounds").inc(res.spec.rounds)
