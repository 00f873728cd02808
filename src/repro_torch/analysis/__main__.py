"""CLI for the analysis pass: ``python -m repro_torch.analysis --check``.

Exit 0 when every analyzer is clean, 1 with one finding per line on
stderr otherwise.  The lock graph's text, waived holds included with
their reasons, goes to stdout either way.  ``--dot PATH`` additionally
renders the lock-order graph as Graphviz DOT.  There is no HLO manifest
to validate: the port's counterpart of the collective budgets is the
byte ledger the multipod dry-run checks (``repro_torch.analysis``).
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.checkers import run_checkers
from repro_torch.analysis.lockgraph import build_lock_graph, render_text, to_dot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--check", action="store_true",
                    help="run all analyzers; exit nonzero on any finding")
    ap.add_argument("--dot", metavar="PATH", default=None,
                    help="write the lock-order graph as Graphviz DOT")
    args = ap.parse_args(argv)
    if not args.check and not args.dot:
        ap.error("nothing to do: pass --check and/or --dot PATH")

    graph = build_lock_graph()
    if args.dot:
        os.makedirs(os.path.dirname(os.path.abspath(args.dot)),
                    exist_ok=True)
        with open(args.dot, "w", encoding="utf-8") as f:
            f.write(to_dot(graph))
        print(f"lock graph DOT -> {args.dot}")
    if not args.check:
        return 0

    findings = list(graph.findings)
    findings += run_checkers()

    print(render_text(graph), end="")
    if findings:
        print(f"\n{len(findings)} finding(s):", file=sys.stderr)
        for f in findings:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("analysis: clean (lock graph, lint rules)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
