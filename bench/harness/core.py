"""One run of one cell: set-up, the measured window, the check.

Set-up draws the weights from the seed on the device, builds the port's
`Engine` for the cell and warms it with one short request per prompt
bucket (every shape the window uses; the nvcc products land in the
checkout's ``build/kernels/``). The window then serves whole batches back
to back through `Engine.generate_continuous`: a new batch starts while
less than ``seconds`` have passed, and the window closes when the batch in
flight retires its last request. After it, the program's state is freed
and the reference checks a sample of the served requests (`harness.check`).
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
from repro_torch.obs.trace import NULL_TRACER

from . import check, spec, traffic, weights, work
from .profile import SliceTracer, breakdown, read_slice

GIB = float(1 << 30)
# the window's batch that a traced run profiles: the first warms what the
# window reaches only in it, and host-clock readings come from the others
PROFILED_BATCH = 2


def program_config(config: dict):
    """The port's `ModelConfig` with every size the configuration file
    states (the file is the configuration as it is run)."""
    from repro_torch.configs.base import get_config
    return get_config(config["arch"]).replace(
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"],
        d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"],
        qkv_bias=config["attention_bias"],
        tie_embeddings=config["tie_word_embeddings"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        dtype=getattr(torch, config["torch_dtype"]))


def policy_of(cell: dict):
    """The port's preset for the cell, held to the cache the cell states."""
    from repro_torch.core.policy import presets
    c = cell["cache"]
    pol = presets(c.get("budget", 0), c.get("window", 128),
                  c.get("sinks", 4))[cell["policy"]]
    s = pol.spec
    want = (c.get("budget", 0), c.get("window", 0), c.get("bits", 16))
    if (s.budget, s.window, s.bits) != want:
        raise ValueError(f"preset {cell['policy']} is {s}, the cell states "
                         f"{c}")
    return pol


def make_engine(cfg, params, cell: dict, tr: dict, seed: int, device):
    """The port's `Engine` for the cell: its policy, slots and prompt
    buckets, and every other `Engine` option as the cell's ``engine``
    object states it (layout, chunking, pool, prefix sharing, the
    overload ladder), so a new layout is a workload file alone."""
    from repro_torch.serving import sampler as sampler_lib
    from repro_torch.serving.engine import Engine
    return Engine(cfg, params, policy_of(cell),
                  prompt_len=max(tr["prompt_buckets"]),
                  max_new=traffic.max_output(tr), slots=cell["slots"],
                  buckets=tr["prompt_buckets"], device=device,
                  sampler=sampler_lib.greedy, seed=int(seed) % (2 ** 63),
                  **cell.get("engine", {}))


def requests_of(batch):
    from repro_torch.serving.scheduler import Request
    return [Request(tokens=p, max_new=int(m), eos_id=None) for p, m in batch]


@dataclass
class Batch:
    t_submit: float
    requests: list          # the `Request`s, in submission order
    result: object          # ContinuousGenerationResult
    t_end: float = 0.0
    profiled: bool = False


@dataclass
class Record:
    """What the per-layer readers read: the cell, the window's batches
    that ran without the profiler and their summed wall time, and the
    profiled batch's slice (None where the run traced none). The
    profiler slows the batch it runs in and, through the CUDA tracing it
    leaves behind, the rest of the process: so it runs in the window's
    batch `PROFILED_BATCH`, and host-clock readings come from the others."""
    cell_name: str
    cell: dict
    shape: work.Shape
    batches: List[Batch]
    window_s: float
    slice: Optional[object]

    @property
    def results(self):
        return [r for b in self.batches for r in b.result.results]

    @property
    def window(self) -> dict:
        return window_metrics(self.batches, self.window_s)

    def kernel_names(self, metric: str) -> list:
        return spec.kernel_names(metric)


def window_metrics(batches: List[Batch], window_s: float) -> dict:
    """Throughput over all the window's work and time; tails over all its
    requests (a failed request never gets a first token: +inf) and all
    gaps between consecutive tokens."""
    ttft, gaps, tokens = [], [], 0
    for b in batches:
        for r in b.result.results:
            tokens += r.n_tokens
            tt = np.asarray(r.token_times, dtype=np.float64)
            ttft.append(tt[0] - b.t_submit if r.finish_reason != "failed"
                        and len(tt) else math.inf)
            gaps.extend(np.diff(tt).tolist())
    return {"output_tok_s": tokens / window_s,
            "ttft_p90_s": work.percentile(ttft, 0.90),
            "itl_p95_ms": 1e3 * work.percentile(gaps, 0.95),
            "requests": len(ttft), "gaps": len(gaps), "tokens": tokens}


def run(cell_name: str, cell: dict, config: dict, tr: dict, *, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        bench: Optional[dict] = None,
        log: Callable = lambda s: print(s, file=sys.stderr)) -> dict:
    """One run; returns the result line's object."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = program_config(config)
    shape = work.Shape.of(config, cell)
    params = weights.draw(cfg, seed, dev)
    eng = make_engine(cfg, params, cell, tr, seed, dev)
    rng = np.random.default_rng(int(seed) & (2 ** 63 - 1))
    warm = [(rng.integers(0, config["vocab_size"], b).astype(np.int32), 3)
            for b in tr["prompt_buckets"]]
    eng.generate_continuous(requests_of(warm))
    tracer, prof_at = None, 0
    if trace:
        p = cell["profile"]
        tracer = SliceTracer(p["start_step"], p["steps"])
        prof_at = PROFILED_BATCH
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    batches: List[Batch] = []
    t0 = time.perf_counter()
    while (not batches or time.perf_counter() - t0 < seconds
           or len(batches) < prof_at):
        reqs = requests_of(traffic.batch(tr, seed, len(batches),
                                         config["vocab_size"]))
        profiled = len(batches) + 1 == prof_at
        if profiled:
            eng.trace = tracer
        t_sub = time.perf_counter()
        res = eng.generate_continuous(reqs)
        batches.append(Batch(t_sub, reqs, res, time.perf_counter(),
                             profiled))
        eng.trace = NULL_TRACER
        log(f"batch {len(batches)}: {len(reqs)} requests in "
            f"{batches[-1].t_end - t_sub:.3f} s")
    window_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(dev)
    else:
        setup_peak = peak = 0
        kind = "cpu"
    log(f"window: {len(batches)} batches in {window_s:.3f} s, set-up "
        f"{setup_s:.3f} s")

    m = window_metrics(batches, window_s)
    m["peak_mem_gib"] = peak / GIB
    m["setup_s"] = setup_s
    bench = bench if bench is not None else spec.benchmark()
    mine = spec.metrics_of(cell_name, bench)
    attempted = sum(len(b.requests) for b in batches)
    out = {"attempted": attempted, "failed": check.served(batches)[1]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(max(peak, setup_peak))}
    if trace:
        sl = read_slice(tracer, [r for b in batches if b.profiled
                                 for r in b.result.results])
        clean = [b for b in batches if not b.profiled]
        rec = Record(cell_name, cell, shape, clean,
                     sum(b.t_end - b.t_submit for b in clean), sl)
        vals = {}
        for me in mine["per_layer"]:
            v = spec.layer_reader(me["name"])(rec)
            if v is not None:
                vals[me["name"]] = {"value": float(v), "unit": me["unit"]}
        out["metrics"] = vals
        log(f"profiler start + stop {tracer.overhead_s:.3f} s in the "
            f"window; slice {sl.wall_s if sl else 0:.3f} s")
        if sl is not None:
            device_info["busy_s"] = sl.busy_s
            device_info["window_s"] = sl.wall_s
            out["breakdown"] = breakdown(sl)
    else:
        out["metrics"] = {me["name"]: {"value": float(m[me["name"]]),
                                       "unit": me["unit"]}
                          for me in mine["end_to_end"]}
    out["device"] = device_info
    log(f"requests {m['requests']}, token gaps {m['gaps']}, tokens "
        f"{m['tokens']}; whole window: output_tok_s {m['output_tok_s']!r}, "
        f"ttft_p90_s {m['ttft_p90_s']!r}, itl_p95_ms {m['itl_p95_ms']!r}")

    # the check: the program's state goes first, then the reference runs
    del eng, tracer
    if on_card:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    ck = check.check(cell, config, params, batches, seed, log=log)
    log(f"check took {time.perf_counter() - t_chk:.3f} s")
    out["correct"] = ck["correct"]
    out["check"] = ck["compared"]
    return out
