"""``python -m repro_torch.verify`` — verify ``.gagi`` bundles from a shell.

    python -m repro_torch.verify out/*.gagi --json rep.json --md rep.md
    python -m repro_torch.verify out/           # every .gagi under the dir
    python -m repro_torch.verify prog.gagi --trace trace.json

Bundles written by either package verify the same way.  Exit status 0
iff every program (and, with ``--trace``, the recorded
span ordering) verifies clean.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List

from .checks import verify_gagi
from .race import check_trace
from .report import VerifyReport


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.gagi"))))
        else:
            out.append(p)
    return out


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="Statically verify compiled GraphAGILE programs.")
    ap.add_argument("paths", nargs="+",
                    help=".gagi files (or directories of them)")
    ap.add_argument("--json", metavar="OUT",
                    help="write the combined VerifyReports as JSON")
    ap.add_argument("--md", metavar="OUT",
                    help="write the combined VerifyReports as markdown")
    ap.add_argument("--trace", metavar="TRACE_JSON",
                    help="also race-check a recorded trace against each "
                         "program's dep_graph")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-program stdout lines")
    args = ap.parse_args(argv)

    paths = _expand(args.paths)
    if not paths:
        print("no .gagi programs found", file=sys.stderr)
        return 2

    reports: List[VerifyReport] = []
    ok = True
    for path in paths:
        rep = verify_gagi(path)
        reports.append(rep)
        ok = ok and rep.ok
        if args.trace:
            from repro_torch.engine.program import CompiledProgram
            trep = check_trace(args.trace,
                               CompiledProgram.load(path).manifest)
            trep.program = f"{rep.program} [trace]"
            reports.append(trep)
            ok = ok and trep.ok
        if not args.quiet:
            status = "PASS" if rep.ok else "FAIL"
            print(f"[{status}] {rep.program}: "
                  f"{len(rep.checks_passed)}/{len(rep.checks_run)} "
                  f"checks passed, {len(rep.violations)} violation(s)")
            for v in rep.violations:
                print(f"    {v}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ok": ok,
                       "reports": [r.to_dict() for r in reports]},
                      f, indent=1)
    if args.md:
        with open(args.md, "w") as f:
            f.write("# Program verification\n\n")
            for r in reports:
                f.write(r.to_markdown() + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
