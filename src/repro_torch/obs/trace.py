"""Chrome-trace event recording for the serving loops (counterpart of
`repro.obs.trace`; stdlib only, the port keeps its own copy).

A `Tracer` collects typed events — request lifecycle spans from the
scheduler, per-iteration step spans and rare instants (preempt, spill /
fetch, degrade, CoW, prefix hits, audits) from the engine — into a
bounded in-memory ring and exports Chrome ``trace_event`` JSON that
loads directly in Perfetto / ``chrome://tracing``.

Zero-sync contract: every emit method takes only host-side Python
values (ints, floats, strings, small dicts thereof). Nothing here may
touch a device tensor: reading one would wait for the device. A span
therefore ends when the host has finished enqueueing its work, not when
the device has finished it — span times are host times.

Timestamps are absolute ``time.perf_counter()`` seconds — the same
clock the `Scheduler` uses by default — so scheduler lifecycle times and
engine phase times land on one axis; export rebases them to the
tracer's creation time in microseconds.

Lanes (Chrome ``tid``): 0 is the engine loop; ``slot + 1`` is the lane
of batch slot ``slot``. Export emits ``M`` metadata records naming
them, so Perfetto shows "engine" / "slot 0" / "slot 1" / ... tracks.

`NullTracer` (the engine default) is falsy and no-ops every emit, so a
trace-off run pays one truthiness check per event site. `Span` is the
timing seam shared by both: it always measures with ``perf_counter``
(the engine's reported prefill / decode / dispatch / token-wait seconds
come from ``.elapsed``) and only the emit is conditional, so trace-on and
trace-off runs report the same kind of numbers.

**The profiler's clock.** On a truthy tracer a `Span` also opens a
``torch.profiler.record_function`` range of its name, so under a running
`torch.profiler` every program span appears in the profiler's own trace,
on its clock, and the profiler adds each range's device extent. A
`NullTracer` span opens none. torch is imported at the first range, so
the module itself stays stdlib-only.

**Model-step ranges.** `model_range` gives the decode step's per-layer
ranges (``attn`` ⊃ ``kv`` ⊃ ``attend``, then ``mlp``; ``ssm`` for a
Mamba-2 mixer; ``logits`` per step) as spans of the tracer that
`model_tracing` sets around the engine's dispatch; outside it (and always
when tracing is off) it returns the shared no-op `_OFF`: one global read
and no object a layer.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional

_DEFAULT_CAPACITY = 65536


_profiler = None     # torch.profiler, imported at the first range


def _open_range(name: str):
    """Enter a ``torch.profiler.record_function`` range; returns the
    handle `Span.__exit__` closes. Without a running profiler the range
    records nothing."""
    global _profiler
    if _profiler is None:
        import torch.profiler
        _profiler = torch.profiler
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """Phase stopwatch + (when tracing) one Chrome complete event and one
    profiler range.

    Phases are bracketed with ``with tracer.span(name) as sp: ...`` and
    the caller reads ``sp.elapsed`` for its reported seconds, always from
    ``time.perf_counter``; a `NullTracer` span times the same way and
    only skips the emit and the range. The range opens before ``t0`` and
    closes after the stop, so its host cost stays out of ``elapsed``."""

    __slots__ = ("_trace", "name", "tid", "args", "t0", "elapsed", "_rf")

    def __init__(self, trace, name: str, tid: int = 0,
                 args: Optional[dict] = None) -> None:
        self._trace = trace
        self.name = name
        self.tid = tid
        self.args = args
        self.t0 = 0.0
        self.elapsed = 0.0
        self._rf = None

    def __enter__(self) -> "Span":
        if self._trace:
            self._rf = _open_range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = time.perf_counter() - self.t0
        t = self._trace
        if t:
            self._rf.__exit__(None, None, None)
            t.complete(self.name, self.t0, self.t0 + self.elapsed,
                       tid=self.tid, args=self.args)
        return False


class _Off:
    """The shared no-op context of `model_range` with tracing off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_model_trace = None  # the tracer `model_tracing` set, or None


def model_range(name: str):
    """A range of the model's decode step: a `Span` of the tracer that
    `model_tracing` set, else `_OFF` (one global read, no object made)."""
    t = _model_trace
    return _OFF if t is None else Span(t, name)


class _ModelTracing:
    __slots__ = ("_trace", "_prev")

    def __init__(self, trace) -> None:
        self._trace = trace
        self._prev = None

    def __enter__(self) -> None:
        global _model_trace
        self._prev, _model_trace = _model_trace, self._trace

    def __exit__(self, *exc) -> bool:
        global _model_trace
        _model_trace = self._prev
        return False


def model_tracing(trace):
    """Route `model_range` to `trace` inside the ``with`` block; a falsy
    tracer leaves the ranges off (`_OFF`, no object)."""
    return _ModelTracing(trace) if trace else _OFF


class Tracer:
    """Bounded ring of trace events with Chrome-JSON export.

    Events are plain tuples ``(ph, name, tid, ts, dur, args)`` with
    ``ts`` / ``dur`` in absolute perf_counter seconds; the ring
    (`collections.deque(maxlen=capacity)`) drops the oldest events on
    overflow and counts the drops, so a long run keeps its tail."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *,
                 pid: int = 1, process_name: str = "repro-serve") -> None:
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.pid = int(pid)
        self.process_name = process_name
        self.t0 = time.perf_counter()
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0

    # -- emit ------------------------------------------------------------
    now = staticmethod(time.perf_counter)

    def _push(self, ev: tuple) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)

    def instant(self, name: str, *, tid: int = 0,
                args: Optional[dict] = None) -> None:
        """A point event (Chrome ``ph="i"``) at now."""
        self._push(("i", name, tid, time.perf_counter(), 0.0, args))

    def complete(self, name: str, t0: float, t1: Optional[float] = None, *,
                 tid: int = 0, args: Optional[dict] = None) -> None:
        """A duration event (Chrome ``ph="X"``) over absolute
        perf_counter times ``[t0, t1]`` (``t1`` defaults to now)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._push(("X", name, tid, t0, max(t1 - t0, 0.0), args))

    def counter(self, name: str, values: Dict[str, float], *,
                tid: int = 0) -> None:
        """A counter sample (Chrome ``ph="C"``): Perfetto renders each
        key of `values` as a stacked counter track."""
        self._push(("C", name, tid, time.perf_counter(), 0.0,
                    dict(values)))

    def span(self, name: str, *, tid: int = 0,
             args: Optional[dict] = None) -> Span:
        return Span(self, name, tid, args)

    # -- inspect ---------------------------------------------------------
    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> List[tuple]:
        return list(self._ring)

    # -- export ----------------------------------------------------------
    def _lane_name(self, tid: int) -> str:
        return "engine" if tid == 0 else "slot %d" % (tid - 1)

    def to_chrome(self) -> dict:
        """The run as a Chrome ``trace_event`` JSON object (dict form):
        ``{"traceEvents": [...]}`` with microsecond timestamps rebased
        to the tracer's creation time, plus ``M`` metadata naming the
        process and every lane that carried an event."""
        events: List[dict] = []
        tids = {0}
        for ph, name, tid, ts, dur, args in self._ring:
            tids.add(tid)
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "pid": self.pid, "tid": tid,
                "ts": round((ts - self.t0) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"           # thread-scoped instant
            if args is not None:
                ev["args"] = args
            events.append(ev)
        meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for tid in sorted(tids):
            meta.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                         "tid": tid, "args": {"name": self._lane_name(tid)}})
            meta.append({"ph": "M", "name": "thread_sort_index",
                         "pid": self.pid, "tid": tid,
                         "args": {"sort_index": tid}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NullTracer:
    """Falsy no-op tracer — the default of the engine, the scheduler, the
    allocator and the host tier. Every emit is a pass; `span` still
    times (reported seconds do not depend on whether tracing is on)."""

    __slots__ = ()

    now = staticmethod(time.perf_counter)

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def instant(self, name: str, *, tid: int = 0,
                args: Optional[dict] = None) -> None:
        pass

    def complete(self, name: str, t0: float, t1: Optional[float] = None, *,
                 tid: int = 0, args: Optional[dict] = None) -> None:
        pass

    def counter(self, name: str, values: Dict[str, float], *,
                tid: int = 0) -> None:
        pass

    def span(self, name: str, *, tid: int = 0,
             args: Optional[dict] = None) -> Span:
        return Span(self, name, tid, args)

    def events(self) -> List[tuple]:
        return []


NULL_TRACER = NullTracer()
