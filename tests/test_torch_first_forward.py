"""A guard on the port's f32 rounding on the CPU: the first forward of a
fresh process equals the later ones.

An earlier report said a fresh process's first f32 forward of the zamba2
smoke model sometimes differed from later ones, starting at a silu of
equal inputs, and the chaotic random model carried that past 1e-4.  This
test repeats it under the conditions of the tier-1 run: three fresh
subprocesses at once (each as an xdist worker would be, after the
reference has run in the same process: its zamba2 smoke forward, jitted),
each running three forwards of the port's zamba2 smoke model in f32
(weights from seed 0, tokens (2, 70) from seed 1).  Every forward must be
bit-equal to the process's first, and the first forwards of the three
processes bit-equal to each other.  Tried 26 times in fresh processes
before it was committed: every forward bit-equal (ROADMAP queue 3).
"""

import json
import os
import subprocess
import sys

_SCRIPT = r"""
import dataclasses, hashlib, json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke
from repro_torch.models import transformer as tr

arch = "zamba2-1.2b"
rcfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 70))
params = ref_tr.init_params(rcfg, jax.random.PRNGKey(0))
ref = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, t, rcfg)[0])(
    params, jnp.asarray(toks)))
cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
outs = []
with torch.no_grad():
    for _ in range(3):
        outs.append(model(torch.as_tensor(toks))[0].numpy())
print("FORWARDS " + json.dumps({
    "sha": [hashlib.sha256(o.tobytes()).hexdigest() for o in outs],
    "finite": bool(np.isfinite(ref).all() and np.isfinite(outs[0]).all())}))
"""


def test_first_f32_forward_equals_later_ones_in_fresh_processes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _SCRIPT], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    shas = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        rep = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("FORWARDS ")][-1][9:])
        assert rep["finite"]
        assert len(set(rep["sha"])) == 1, rep["sha"]
        shas.append(rep["sha"][0])
    assert len(set(shas)) == 1, shas
