"""Shared finding type + source iteration for the analysis pass.

Every analyzer in ``repro_torch.analysis`` (lock graph, AST lint rules)
reports through one ``Finding`` shape so the CLI can render and gate
them uniformly.  Analyzers take ``(path, source)`` pairs rather than
reading the tree themselves — that is what lets the seeded-violation
tests feed synthetic modules through the exact code the CLI runs
(tests/test_torch_analysis.py).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer verdict, pointing at a source location."""
    rule: str                      # e.g. "lock-cycle", "tracer-guard"
    file: str                      # repo-relative path
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.msg}"


def repo_root(start: str = __file__) -> str:
    """The repo root, resolved from this file (src/repro_torch/analysis/..)."""
    return os.path.abspath(
        os.path.join(os.path.dirname(os.path.abspath(start)),
                     "..", "..", ".."))


def iter_py_sources(*dirs: str, root: str = "") -> list:
    """``(repo-relative path, source text)`` for every .py under ``dirs``
    (a path naming one .py file reads that file).

    Paths are sorted for deterministic analyzer output; ``root`` defaults
    to the repo root so callers can pass "src/repro_torch", "chip_smoke.py"
    ...
    """
    root = root or repo_root()
    out = []
    for d in dirs:
        base = os.path.join(root, d)
        if os.path.isfile(base):
            with open(base, encoding="utf-8") as f:
                out.append((os.path.relpath(base, root), f.read()))
            continue
        for dirpath, dirnames, files in os.walk(base):
            dirnames[:] = [x for x in dirnames if x != "__pycache__"]
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dirpath, fn)
                with open(p, encoding="utf-8") as f:
                    out.append((os.path.relpath(p, root), f.read()))
    out.sort()
    return out


def module_name(path: str) -> str:
    """Dotted module name for a repo-relative path — the prefix used in
    lock-node names (``serving.fleet.JoinFleet._cond``)."""
    p = path.replace(os.sep, "/")
    for prefix in ("src/repro_torch/", "src/"):
        if p.startswith(prefix):
            p = p[len(prefix):]
            break
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[:-len("/__init__")]
    return p.replace("/", ".")
