"""Tracer seam of the serving loops (the no-op half of `repro.obs.trace`;
stdlib only).

The `Scheduler` emits request lifecycle events through a tracer object:
``instant(name, *, tid, args)`` for a point event and ``complete(name,
t0, t1, *, tid, args)`` for a span over absolute ``time.perf_counter()``
seconds, host values only. `NULL_TRACER`, the default, is falsy, so a
trace-off run pays one truthiness check per event site. The recording
`Tracer` with Chrome-trace export comes with the telemetry wiring.
"""
from __future__ import annotations

from typing import Optional


class NullTracer:
    """Falsy no-op tracer — the scheduler's default."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def instant(self, name: str, *, tid: int = 0,
                args: Optional[dict] = None) -> None:
        pass

    def complete(self, name: str, t0: float, t1: Optional[float] = None, *,
                 tid: int = 0, args: Optional[dict] = None) -> None:
        pass


NULL_TRACER = NullTracer()
