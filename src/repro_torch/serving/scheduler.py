"""Continuous-batching request lifecycle: queue, slots, accounting (the
dense-path part of `repro.serving.scheduler`, which the port cannot
import without importing the JAX engine).

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
Block grants (paged pool), chunked admission, preemption and tiering
come with the slices that port those paths.
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

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {self.tokens.shape}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")


@dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray            # [n_emitted] generated (EOS included)
    prompt_len: int
    bucket: int
    slot: int
    finish_reason: str            # "eos" | "length"
    ttft_s: float                 # submit -> first token
    total_s: float                # submit -> retirement
    decode_s: float               # first token -> retirement
    token_times: np.ndarray = field(  # [n_emitted] clock at each token —
        default_factory=lambda: np.zeros(0))  # inter-token stall analysis

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class _SlotState:
    req: Request
    bucket: int
    t_submit: float
    t_admit: float
    t_first: float = 0.0
    emitted: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)


class Scheduler:
    """Per-slot request lifecycle for a `slots`-wide persistent cache.

    QUEUED -> (admit_next) ACTIVE -> (record_token x N) -> (retire) DONE.
    The engine calls `admit_next` whenever a slot is free, feeds every
    sampled token through `record_token` (which returns a finish reason
    once EOS or the request's max_new is hit), then `retire`s the slot —
    freeing it for the next queued request immediately, mid-decode.
    """

    def __init__(self, buckets: Sequence[int], n_slots: int, *,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"need positive prompt buckets, got {buckets}")
        if n_slots < 1:
            raise ValueError(f"need >= 1 slot, got {n_slots}")
        self.buckets = buckets
        self.n_slots = n_slots
        self._clock = clock
        # lifecycle tracing: the scheduler owns every request timestamp,
        # so it emits the request spans — submit / admit / first-token
        # instants, the queued + request complete events at retire.
        # Host values only.
        self.trace = tracer if tracer is not None else NULL_TRACER
        self._queue: Deque[Tuple[Request, float]] = deque()
        self._slots: List[Optional[_SlotState]] = [None] * n_slots
        self.results: List[RequestResult] = []
        self._decode_steps = 0
        self._active_slot_steps = 0

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

    # ---- slots -----------------------------------------------------------
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def admit_next(self, slot_idx: int) -> Optional[Request]:
        """Pop the next queued request into a free slot (FIFO). Returns
        None when the queue is empty."""
        if self._slots[slot_idx] is not None:
            raise ValueError(f"slot {slot_idx} is occupied")
        if not self._queue:
            return None
        req, t_submit = self._queue.popleft()
        self._slots[slot_idx] = _SlotState(
            req, self.bucket_for(len(req.tokens)), t_submit, self._clock())
        if self.trace:
            self.trace.instant("admit", tid=slot_idx + 1,
                               args=dict(uid=req.uid, slot=slot_idx))
        return req

    # ---- token stream ----------------------------------------------------
    def record_token(self, slot_idx: int, token: int) -> Optional[str]:
        """Append one sampled token; returns the finish reason ("eos" |
        "length") when this token completes the request, else None."""
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        token = int(token)
        now = self._clock()
        if not st.emitted:
            st.t_first = now
            if self.trace:
                self.trace.instant("first_token", tid=slot_idx + 1,
                                   args=dict(uid=st.req.uid))
        st.emitted.append(token)
        st.token_times.append(now)
        if st.req.eos_id is not None and token == st.req.eos_id:
            return "eos"
        if len(st.emitted) >= st.req.max_new:
            return "length"
        return None

    def retire(self, slot_idx: int, reason: str) -> RequestResult:
        st = self._slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is empty")
        self._slots[slot_idx] = None
        now = self._clock()
        req = st.req
        res = RequestResult(
            uid=req.uid,
            tokens=np.asarray(st.emitted, np.int32),
            prompt_len=len(req.tokens),
            bucket=st.bucket,
            slot=slot_idx,
            finish_reason=reason,
            ttft_s=st.t_first - st.t_submit,
            total_s=now - st.t_submit,
            decode_s=now - st.t_first,
            token_times=np.asarray(st.token_times, np.float64),
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
                          tokens=len(st.emitted)))
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
