r"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, without the CUDA devices the cell asks
for, without the port beside it, or when JAX or the JAX package was loaded.
The last lines of standard error are the numbers the check compared, each
with its limit; the last line of standard output is the result object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench.harness import core, spec

    torch.set_num_threads(4)
    cells = {w["name"]: w for w in spec.benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    entry = cells[args.workload]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    cell = spec.workload(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        print("BENCHMARK.json and the workload file disagree",
              file=sys.stderr)
        return 2
    out = core.run(args.workload, cell, spec.config(cell["config"]),
                   spec.traffic(cell["traffic"]), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=T_START)
    bad = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device", "breakdown") if k in out}
    line["check"] = out["check"]
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
