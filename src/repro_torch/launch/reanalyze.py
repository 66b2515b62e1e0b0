"""Re-derive the dry run's op-count stats (dot FLOPs, collectives, bytes
accessed) from its saved op logs WITHOUT re-running a step — updates the
dry-run JSONs in place (counterpart of `repro.launch.reanalyze`, which
re-reads the gzipped HLO text). Pure text processing over
`<dir>/ops/<tag>.jsonl.gz`, the logs `launch.dryrun`'s CLI writes: each
line is one counted local op (its input and output shapes, dtypes and
element sizes; a collective's kind and group size), and
`launch.dryrun.account` adds it up exactly as the run did.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [DIR]
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Optional, Sequence

from repro_torch.launch.dryrun import DEFAULT_OUT, account, new_totals


def derive(log_path: str) -> dict:
    """The op-count stats of one saved op log."""
    totals = new_totals()
    with gzip.open(log_path, "rt") as f:
        for line in f:
            if line.strip():
                account(json.loads(line), totals)
    return {"dot_flops_per_device": totals["dot_flops"],
            "collectives": totals["collectives"],
            "bytes_accessed_per_device": totals["bytes"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    d = os.path.abspath(argv[0] if argv else DEFAULT_OUT)
    n_done = 0
    for jf in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(jf) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        tag = os.path.basename(jf)[:-5]
        log = os.path.join(d, "ops", tag + ".jsonl.gz")
        if not os.path.exists(log):
            print("no op log for", tag)
            continue
        stats = derive(log)
        rec.update(stats)
        rec["flops_per_device"] = stats["dot_flops_per_device"]
        with open(jf, "w") as f:
            json.dump(rec, f, indent=1)
        n_done += 1
        coll = sum(v["bytes_weighted_n"]
                   for v in stats["collectives"].values())
        print(f"{tag}: dot_flops/dev={stats['dot_flops_per_device']:.3g} "
              f"coll_bytes={coll:.3g} "
              f"bytes/dev={stats['bytes_accessed_per_device']:.3g}")
    print(f"reanalyzed {n_done}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
