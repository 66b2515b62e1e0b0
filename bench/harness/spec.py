"""The benchmark's data: `BENCHMARK.json`, and the files it names by name.

* ``bench/configs/<config>.json``: a model configuration, in Hugging Face
  key names, with ``arch`` (the port's config it is run through);
* ``bench/workloads/<cell>.json``: one cell: its configuration, traffic
  mix, policy, cache layout, slots, profiled slice and correctness check;
* ``bench/traffic/<traffic>.json``: a traffic mix, read by
  `harness.traffic`;
* ``bench/layer_metrics/<metric>.py``: the reader of a per-layer metric;
* ``bench/kernel_names/<metric>.json``: the profiler kernel names a
  roofline metric sums.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def kernel_names(metric: str) -> list:
    return _json(BENCH / "kernel_names" / f"{metric}.json")["contains"]


def layer_reader(metric: str) -> Callable:
    """The ``read(record)`` function of ``layer_metrics/<metric>.py``."""
    path = BENCH / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "layer_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell: str, bench: dict) -> Dict[str, list]:
    """The end-to-end and per-layer metric entries a cell reports: those
    that list it under ``workloads``, or list no workloads."""
    def mine(m):
        return cell in m.get("workloads", [cell])
    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}
