"""CLI: ``python -m repro_torch.analysis [--check] [--json] PATHS...``

Default mode prints everything (violations, suppressed findings,
informational notes). ``--check`` is the CI contract: print only
unsuppressed violations with the suppression syntax hint and exit 1
when any exist. ``--json`` dumps the full finding list as JSON
(suppressed entries carry their reasons — the annotation inventory).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis.driver import Analyzer
from repro_torch.analysis.model import SEVERITY_INFO


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kvlint for the PyTorch port (stdlib-only)")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to analyze")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: fail (exit 1) on any unsuppressed "
                         "violation")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    analyzer = Analyzer()
    files = analyzer.load_paths(args.paths)
    findings = analyzer.run(files)
    dt = time.perf_counter() - t0

    if args.as_json:
        print(json.dumps({
            "files": len(files),
            "seconds": round(dt, 3),
            "findings": [f.as_dict() for f in findings],
        }, indent=2))
        return 1 if args.check and any(f.is_violation
                                       for f in findings) else 0

    violations = [f for f in findings if f.is_violation]
    suppressed = [f for f in findings if f.suppressed]
    infos = [f for f in findings if f.severity == SEVERITY_INFO
             and not f.suppressed]

    for f in violations:
        print(f.render())
        print("  fix it, or suppress with a reason:  "
              "# kvlint: ok(%s: <reason>)" % f.rule)
    if not args.check:
        for f in infos:
            print(f.render())
        for f in suppressed:
            print(f.render())

    print("kvlint: %d file(s), %d violation(s), %d suppressed, "
          "%d note(s) in %.2fs"
          % (len(files), len(violations), len(suppressed), len(infos), dt))
    if args.check and violations:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
