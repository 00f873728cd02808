"""Client-side runner for ``launch.multipod_dryrun`` subprocesses.

The dry-run spawns a world of processes of its own, so callers never
import and run it in-process: they start it and parse the
``MULTIPOD_DRYRUN_JSON`` marker line.  This is the one implementation of
that protocol (tests and ``chip_smoke.py`` drive it); keep marker, env and
exit-code handling here so the contract cannot drift between consumers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

MARKER = "MULTIPOD_DRYRUN_JSON "

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def run_dryrun(mesh: str, *extra: str, device: str = "cpu",
               timeout: int = 420, repo: str = REPO_ROOT) -> dict:
    """Run the multipod dry-run on ``mesh`` ("P,D,M") with every rank on
    ``device`` ("cpu" or "cuda"); returns the parsed report.  Raises AssertionError (with captured output) when the
    subprocess exits nonzero, reports a failed status, or emits no
    marker line; ``subprocess.TimeoutExpired`` past ``timeout`` seconds
    (the dry-run's own world timeout is shorter, so a hung rank fails the
    run before this fires)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(repo, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multipod_dryrun",
         "--mesh", mesh, "--device", device,
         "--timeout", str(max(30, timeout - 30)), *extra],
        capture_output=True, text=True, timeout=timeout, cwd=repo, env=env)
    rep = None
    for line in proc.stdout.splitlines():
        if line.startswith(MARKER):
            rep = json.loads(line[len(MARKER):])
    assert rep is not None, (
        f"no dry-run report (exit {proc.returncode})\n"
        f"stdout: {proc.stdout[-2000:]}\nstderr: {proc.stderr[-2000:]}")
    assert proc.returncode == 0 and rep.get("status") == "ok", (
        f"multipod dry-run failed (exit {proc.returncode}): "
        f"{json.dumps(rep, indent=1, default=str)[:4000]}\n"
        f"stderr: {proc.stderr[-2000:]}")
    return rep
