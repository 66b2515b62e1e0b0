#!/usr/bin/env python3
"""KIVI quantize-and-pack (B6) on the card: a previous version of
`src/repro_torch/kernels/kvquant` against the checkout's, in one process.

    mkdir -p build/old_kvquant/csrc
    git show <commit>:src/repro_torch/kernels/kvquant/ops.py \\
        > build/old_kvquant/ops.py
    git show <commit>:src/repro_torch/kernels/kvquant/csrc/kvquant.cu \\
        > build/old_kvquant/csrc/kvquant.cu
    python3 scripts/kvquant_old_new.py --old build/old_kvquant

The previous `ops.py` is loaded under its own name; its `CudaSource`
builds its own library beside the current one (the library's name
carries a hash of the source). Then, on one card:

1. bit-equality: the current standalone `kquant_cuda` / `vquant_cuda`
   against the previous ones on the inputs of
   `tests/test_torch_gpu.py::test_kvquant_kernels_match_plain` (every
   shape, f32 and bf16, bits 2 / 4 / 8), and the current `kvquant_cuda`
   against both;
2. timing at the serve path's shapes (bf16 2-bit: the kivi2 ring flush
   of 8 slots [8, 128, 8, 128] and the prompt compressions [1, 512 |
   1920, 8, 128]): event-timed ms of a wrapper call and device ms
   (torch.profiler), previous / current / current / previous, for B6k,
   B6v, and one flush's K and V: the previous two calls, the current two
   calls, and the current one fused call (and the previous fused call,
   where the previous version has one); beside them, as a yardstick of
   one launch that moves as many bytes, the device ms of `v.clone()`
   and of `torch.cat([k, v])`.

Prints one line a comparison and, last, a JSON object of every reading
(also written to --json PATH when given). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

TEST_SHAPES = ((8, 128, 8, 128, 128), (1, 512, 8, 128, 128),
               (1, 1920, 8, 128, 128), (2, 64, 2, 32, 16),
               (1, 64, 3, 40, 16), (2, 32, 1, 20, 16),
               (1, 1024, 2, 16, 512))
SERVE_SHAPES = ((8, 128), (1, 512), (1, 1920))


def load_previous(path: str):
    spec = importlib.util.spec_from_file_location(
        "previous_kvquant_ops", os.path.join(path, "ops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=os.path.join(ROOT, "build",
                                                  "old_kvquant"),
                    help="directory holding the previous ops.py and "
                         "csrc/kvquant.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", default=None,
                    help="file to write the readings to, as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kvquant_old_new: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.kvquant import ops as new
    old = load_previous(args.old)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[b6] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [(s, ex.submit(s.build)) for s in (new.SOURCE, old.SOURCE)]
        for src, fut in futs:
            fut.result()
            for line in src.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[b6] build {src.path}: {line.strip()}")
    out: dict = {"device": smi, "equal": [], "race": {}}

    # 1. bit-equality
    n_bad = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, S, H, D, G in TEST_SHAPES:
            for bits in (2, 4, 8):
                g = torch.Generator(device="cuda").manual_seed(S + bits)
                x = (torch.randn(B, S, H, D, generator=g, device="cuda")
                     * 2).to(dt)
                y = x.flip(1).contiguous()
                kw = dict(bits=bits, group=G)
                k_new, k_old = new.kquant_cuda(x, **kw), old.kquant_cuda(x, **kw)
                v_new, v_old = new.vquant_cuda(y, **kw), old.vquant_cuda(y, **kw)
                fk, fv = new.kvquant_cuda(x, y, **kw)
                torch.cuda.synchronize()
                eq = dict(
                    kquant=all(map(torch.equal, k_new, k_old)),
                    vquant=all(map(torch.equal, v_new, v_old)),
                    fused=all(map(torch.equal, fk + fv, k_old + v_old)))
                n_bad += not all(eq.values())
                out["equal"].append(dict(dtype=str(dt)[6:], shape=[B, S, H, D],
                                         group=G, bits=bits, **eq))
    print(f"[b6] bit-equal to the previous kernels on "
          f"{len(out['equal'])} cases (kquant, vquant, fused): "
          f"{len(out['equal']) - n_bad} all equal, {n_bad} not", flush=True)
    for r in out["equal"]:
        if not (r["kquant"] and r["vquant"] and r["fused"]):
            print("[b6]   differs:", r)

    # 2. previous / current / current / previous at the serve shapes
    def race(label, prev, cur):
        ev = {"prev": [], "cur": []}
        for who in ("prev", "cur", "cur", "prev"):
            ev[who].append(cs.median_ms(prev if who == "prev" else cur,
                                        reps=args.reps))
        dev = {"prev": [], "cur": []}
        for who in ("prev", "cur", "cur", "prev"):
            dev[who].append(cs.device_ms(prev if who == "prev" else cur))
        out["race"][label] = dict(ms=ev, device_ms=dev)
        print(f"[b6] {label}: ms previous {ev['prev'][0]:.4f} / current "
              f"{ev['cur'][0]:.4f} / current {ev['cur'][1]:.4f} / previous "
              f"{ev['prev'][1]:.4f}; device previous {dev['prev'][0]:.4f} "
              f"/ current {dev['cur'][0]:.4f} / current {dev['cur'][1]:.4f}"
              f" / previous {dev['prev'][1]:.4f}", flush=True)

    for B, S in SERVE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * S)
        k = (torch.randn(B, S, 8, 128, generator=g, device="cuda")
             * 2).to(torch.bfloat16)
        v = (torch.randn(B, S, 8, 128, generator=g, device="cuda")
             * 2).to(torch.bfloat16)
        kw = dict(bits=2, group=128)
        shape = f"[{B}, {S}, 8, 128]"
        race(f"B6k {shape}", lambda: old.kquant_cuda(k, **kw),
             lambda: new.kquant_cuda(k, **kw))
        race(f"B6v {shape}", lambda: old.vquant_cuda(v, **kw),
             lambda: new.vquant_cuda(v, **kw))
        race(f"K+V previous two calls vs current fused call {shape}",
             lambda: (old.kquant_cuda(k, **kw), old.vquant_cuda(v, **kw)),
             lambda: new.kvquant_cuda(k, v, **kw))
        race(f"K+V current two calls vs current fused call {shape}",
             lambda: (new.kquant_cuda(k, **kw), new.vquant_cuda(v, **kw)),
             lambda: new.kvquant_cuda(k, v, **kw))
        if hasattr(old, "kvquant_cuda"):
            race(f"K+V previous fused call vs current fused call {shape}",
                 lambda: old.kvquant_cuda(k, v, **kw),
                 lambda: new.kvquant_cuda(k, v, **kw))
        kf, vf = new.kvquant_cuda(k, v, **kw)
        out["race"][f"K+V bound {shape}"] = cs.bound(
            cs.nbytes(k, v, *kf, *vf), 0.0, "bfloat16")
        floor = {"v.clone()": cs.device_ms(lambda: v.clone()),
                 "torch.cat([k, v])": cs.device_ms(lambda: torch.cat([k, v]))}
        out["race"][f"copy yardstick {shape}"] = floor
        print(f"[b6] yardstick {shape}: device "
              + ", ".join(f"{n} {t:.4f}" for n, t in floor.items()),
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
