"""Counter / gauge / histogram registry for the serving stack
(counterpart of `repro.obs.metrics`; stdlib only, the port keeps its own
copy with the same `SCHEMA`, names and default bounds, so a
``--metrics-json`` from either package has one layout).

One `Metrics` registry per run: the engine samples host-side mirrors
(allocator free list, scheduler occupancy) once per loop iteration into
pre-bound instruments and publishes end-of-run aggregates (tok/s, TTFT,
inter-token gaps, tier bytes moved, acceptance rate, preemption/degrade
counts) at `_continuous_result` time. `serve.py --metrics-json` and the
benchmarks dump the same `snapshot()` — one schema everywhere, so the
repo accumulates a comparable perf trajectory.

Stdlib-only and host-values-only, like `repro_torch.obs.trace` — see
that module's zero-sync contract. `NULL_METRICS` is the falsy no-op default.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

SCHEMA = "repro.obs.metrics/1"

# 1-2.5-5 ladder in seconds: spans TTFT / inter-token-gap / stall scales
# from 0.1 ms to 10 s without configuration
_DEFAULT_BOUNDS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bound histogram with count/sum/min/max. Bounds are upper
    edges (``le``); one overflow bucket catches the rest."""

    __slots__ = ("name", "bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str,
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds else _DEFAULT_BOUNDS
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must ascend: {self.bounds}")
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, le in enumerate(self.bounds):
            if v <= le:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def snapshot(self) -> dict:
        return dict(
            count=self.count,
            sum=self.sum,
            min=self.min if self.count else 0.0,
            max=self.max if self.count else 0.0,
            mean=(self.sum / self.count) if self.count else 0.0,
            buckets=[[le, n] for le, n in zip(self.bounds, self.buckets)]
            + [["inf", self.buckets[-1]]],
        )


class Metrics:
    """Get-or-create registry. Instrument names are free-form dotted
    strings (``pool.free_frac``, ``request.ttft_s``); re-registering a
    name with a different instrument type is an error, not a shadow."""

    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, *args)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"not a {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._instruments)

    def names(self) -> List[str]:
        return list(self._instruments)

    def snapshot(self) -> dict:
        """name -> value (counters/gauges) or stats dict (histograms),
        sorted by name — the standard serialized form."""
        out: dict = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            out[name] = (inst.snapshot() if isinstance(inst, Histogram)
                         else inst.value)
        return out


class NullMetrics:
    """Falsy no-op registry: instruments swallow writes, `snapshot` is
    empty. The engine default — sampling sites pre-bind instruments
    behind one truthiness check."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def counter(self, name: str) -> "_NullInstrument":
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> "_NullInstrument":
        return _NULL_INSTRUMENT

    def histogram(self, name: str, bounds=None) -> "_NullInstrument":
        return _NULL_INSTRUMENT

    def names(self) -> List[str]:
        return []

    def snapshot(self) -> dict:
        return {}


class _NullInstrument:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()
NULL_METRICS = NullMetrics()


def write_metrics_json(metrics, path: str, *, extra: Optional[dict] = None
                       ) -> dict:
    """Serialize a registry snapshot to `path` in the one standard
    layout shared by ``serve.py --metrics-json`` and the benchmarks'
    ``BENCH_serving.json``. Returns the written payload."""
    payload = {"schema": SCHEMA, "metrics": metrics.snapshot()}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload
