"""Readings that set a cell's check limit: the program's gap on many seeds,
the control's (the reference in float8 in the program's place) on a few,
and the program's with a fault planted under the timed path
(`harness.faults`), in one process at the cell's own size and load.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults state_unchanged:4,half_batch:5] \
        [--batches 1] [--out FILE]

Per seed: the weights are drawn anew into the same tensors, an engine is
built for the cell (under a ``--faults`` entry, with that fault planted),
`batches` batches of the cell's traffic are served, and the check's sample
is run through the f32 reference (and, for a control seed, the fp8 one).
One JSON line per run goes to standard output and to FILE, with whether
the cell's limits pass it.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _serve(core, traffic, cfg, params, cell, tr, config, seed, dev,
           n_batches):
    eng = core.make_engine(cfg, params, cell, tr, seed, dev)
    t0 = time.perf_counter()
    batches = []
    for i in range(n_batches):
        reqs = core.requests_of(traffic.batch(tr, seed, i,
                                              config["vocab_size"]))
        t_sub = time.perf_counter()
        batches.append(core.Batch(t_sub, reqs, eng.generate_continuous(reqs)))
    return batches, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="name:seed,... (names: harness/faults.py)")
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import check, core, faults, spec, traffic, weights

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.workload(args.workload)
    config = spec.config(cell["config"])
    tr = spec.traffic(cell["traffic"])
    cfg = core.program_config(config)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    for item in args.faults.split(","):
        if item:
            name, seed = item.split(":")
            runs.append((int(seed), name))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    params = weights.draw(cfg, runs[0][0], dev)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed, fault in runs:
        weights.draw(cfg, seed, dev, params=params)
        try:
            with (faults.planted(fault) if fault
                  else contextlib.nullcontext()):
                batches, serve_s = _serve(core, traffic, cfg, params, cell,
                                          tr, config, seed, dev,
                                          args.batches)
        except Exception as e:      # a fault that crashes is not correct
            if fault is None:
                raise
            emit({"workload": args.workload, "seed": seed, "fault": fault,
                  "crashed": repr(e)[:400], "passes_limits": False})
            continue
        whole, missing = check.served(batches)
        picked = check.sample(whole, int(cell["check"]["requests"]), seed)
        t1 = time.perf_counter()
        ref = check.reference_logits(cell, config, params, picked)
        nums = check.gap_numbers(ref, [r.tokens.tolist() for _, r in picked])
        rec = {"workload": args.workload, "seed": seed, "fault": fault,
               "missing": missing,
               "served_tokens": sum(r.n_tokens for _, r in picked),
               "serve_s": serve_s, "reference_s": time.perf_counter() - t1,
               "program": nums,
               "passes_limits": missing == 0 and all(
                   nums[k] <= lim
                   for k, lim in cell["check"]["limits"].items())}
        if seed in controls and fault is None:
            t2 = time.perf_counter()
            low = check.reference_logits(cell, config, params, picked,
                                         precision="fp8")
            rec["control"] = check.control_gaps(ref, low)
            rec["control_s"] = time.perf_counter() - t2
            del low
        del ref, batches
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
