"""Repo-invariant static analysis over the port (DESIGN.md §9).

``python -m repro_torch.analysis --check`` runs, in one pass over
``src/repro_torch``:

  * ``lockgraph``  — static lock-order graph over the threaded stack
    (cycle = potential deadlock = failure) + blocking-under-lock checks
    (the port's host syncs and ``torch.distributed`` calls included),
    with an opt-in runtime witness (``witness.lock_witness``) that
    cross-validates real acquisition orders during threaded tests;
  * ``checkers``   — AST lint rules ruff cannot express: tracer guards,
    legacy-kwarg bans, metric-name declarations, monotonic-clock
    enforcement on span paths.

The JAX package's third analyzer, ``hlo_contracts`` (collective budgets
read from compiled XLA HLO), has no copy: the port compiles no HLO.  Its
counterpart is the byte ledger of ``distributed/collectives.py``, which
counts every collective's bytes by group and which the multipod dry-run
(``launch/multipod_dryrun.py``) checks against its budgets.
"""

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lockgraph import build_lock_graph
from repro_torch.analysis.checkers import run_checkers
from repro_torch.analysis.witness import lock_witness

__all__ = ["Finding", "build_lock_graph", "run_checkers", "lock_witness"]
