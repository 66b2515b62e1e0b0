"""The traced run's device slice: `torch.profiler` over a few engine steps.

`SliceTracer` is the port's `Tracer` (its spans and instants are kept for
the per-layer readers) that also counts the engine's ``step`` spans: it
starts the profiler at the end of step ``start`` and stops it at the end of
step ``start + iters``, so the slice covers whole loop iterations of a
steady batch. A ``bench.sync`` annotation at the start ties the
profiler's clock to ``time.perf_counter``, on which the engine's spans and
the requests' token times lie.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from repro_torch.obs.trace import Tracer

from . import work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class SliceTracer(Tracer):
    def __init__(self, start: int, iters: int) -> None:
        super().__init__(capacity=1 << 20, process_name="bench")
        self.start, self.iters = int(start), int(iters)
        self.step_ends: List[float] = []
        self.prof = None
        self.t_sync = self.p0 = self.p1 = 0.0
        self.overhead_s = 0.0           # the profiler's start and stop

    def complete(self, name, t0, t1=None, *, tid=0, args=None) -> None:
        super().complete(name, t0, t1, tid=tid, args=args)
        if name != "step":
            return
        self.step_ends.append(time.perf_counter())
        n = len(self.step_ends)
        if n == self.start and self.prof is None:
            t = time.perf_counter()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            with torch.profiler.record_function("bench.sync"):
                self.t_sync = time.perf_counter()
            self.p0 = self.t_sync
            self.overhead_s += self.p0 - t
        elif n == self.start + self.iters and self.prof is not None \
                and not self.p1:
            self.p1 = time.perf_counter()
            self.prof.stop()
            self.overhead_s += time.perf_counter() - self.p1

    @property
    def done(self) -> bool:
        return bool(self.p1)


@dataclass
class Slice:
    """What the profiled slice holds, on the host's clock (seconds)."""
    t0: float
    wall_s: float
    ops: List[Tuple[str, float, float]]         # device ops: name, t0, t1
    spans: List[Tuple[str, float, float, dict]]  # host spans in the slice
    decode_items: List[Tuple[int, int, int]] = field(default_factory=list)
    prefill_lens: List[int] = field(default_factory=list)
    decode_steps: int = 0

    @property
    def busy_s(self) -> float:
        return work.union_seconds([(a, b) for _, a, b in self.ops])

    def seconds_of(self, patterns) -> float:
        return sum(b - a for n, a, b in self.ops
                   if any(p in n for p in patterns))


def read_slice(tr: SliceTracer, results) -> Optional[Slice]:
    """Parse the profiler's trace and attribute the slice's work: the
    tokens each decode step in it emitted (read after the step span that
    follows it) and the admissions it prefilled."""
    if not tr.done:
        return None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        tr.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    sync = [e for e in events if e.get("name") == "bench.sync"
            and e.get("cat") == "user_annotation"]
    if not sync:
        raise RuntimeError("the profiler's trace lacks the sync annotation")
    off = tr.t_sync - sync[0]["ts"] * 1e-6
    p0, p1 = tr.p0, tr.p1
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = max(e["ts"] * 1e-6 + off, p0)
            b = min((e["ts"] + e["dur"]) * 1e-6 + off, p1)
            if b > a:
                ops.append((e["name"], a, b))
    spans = [(ev[1], ev[3], ev[3] + ev[4], ev[5] or {})
             for ev in tr.events()
             if ev[0] == "X" and ev[3] < p1 and ev[3] + ev[4] > p0]
    sl = Slice(t0=p0, wall_s=p1 - p0, ops=ops, spans=spans)
    # step j's tokens are read after span j + 1: the slice dispatched steps
    # start + 1 .. start + iters, read in (E[start + 2], E[start+iters+2])
    E = tr.step_ends
    s = tr.start
    first, last = s + 1, s + tr.iters
    if len(E) >= last + 2:
        lo, hi = E[first], E[last + 1]
        bounds = E[first:last + 2]
        for r in results:
            tt = r.token_times
            for k in range(1, len(tt)):
                if lo < tt[k] < hi:
                    step = sum(1 for b in bounds if b < tt[k])
                    sl.decode_items.append((step, r.prompt_len, k))
        sl.decode_steps = len({it[0] for it in sl.decode_items})
    uid_len = {r.uid: r.prompt_len for r in results}
    sl.prefill_lens = [uid_len[a["uid"]] for n, t0, t1, a in spans
                       if n == "prefill" and t0 >= p0 and t1 <= p1
                       and a.get("uid") in uid_len]
    return sl


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host span open when each began."""
    by_name = {}
    for n, a, b in sl.ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ivs = sorted((a, b) for _, a, b in sl.ops)
    gaps, end = [], None
    for a, b in ivs:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t):
        inner = [(s1 - s0, n) for n, s0, s1, _ in sl.spans if s0 <= t < s1]
        return min(inner)[1] if inner else "between engine spans"
    idle = [[f"{host_at(a)} at +{a - sl.t0:.4f}s", b - a]
            for a, b in gaps[:top]]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": idle}
