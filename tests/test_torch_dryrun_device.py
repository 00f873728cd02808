"""The multipod dry-run runs on the card unless asked for the CPU.

``python -m repro_torch.launch.multipod_dryrun`` and ``run_world`` default
to ``cuda``, as every other launcher of the port does, and raise through
``device.resolve_device`` when torch sees no card; ``run_dryrun`` passes
``--device`` explicitly (``cpu`` unless asked), so the CPU tests of
``tests/test_torch_multipod.py`` stay on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun_client, multipod_dryrun
from repro_torch.launch.dryrun_client import MARKER, REPO_ROOT, run_dryrun


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")


def test_run_world_defaults_to_cuda_and_refuses_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multipod_dryrun.run_world((1, 1, 1))


def test_the_launcher_defaults_to_cuda_and_refuses_without_a_card(no_card):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multipod_dryrun",
         "--mesh", "1,1,1"], capture_output=True, text=True, env=env,
        cwd=REPO_ROOT, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert MARKER not in proc.stdout


@pytest.mark.parametrize("kw,want", [({}, "cpu"), ({"device": "cuda"},
                                                   "cuda")])
def test_run_dryrun_passes_the_device(monkeypatch, kw, want):
    seen = {}

    def fake_run(argv, **_):
        seen["argv"] = argv
        rep = {"status": "ok"}
        return subprocess.CompletedProcess(argv, 0, MARKER + json.dumps(rep),
                                           "")
    monkeypatch.setattr(dryrun_client.subprocess, "run", fake_run)
    assert run_dryrun("2,1,1", "--skip-serving", **kw) == {"status": "ok"}
    argv = seen["argv"]
    assert argv[argv.index("--device") + 1] == want
    assert argv.count("--device") == 1 and argv[-1] == "--skip-serving"
