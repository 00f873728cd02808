"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \
         csrc/<name>.cu

The output lands in ``build/kernels/`` at the repository root (gitignored),
at first use.  The file name carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded.  A failed build
raises with nvcc's stderr.  ``build_all`` starts one nvcc per source, all
at once, so a cold start pays for the slowest source only.  ptxas's report
of each kernel's registers, shared memory and spills is kept beside the
library (``<name>-<hash>.ptxas.txt``) and returned by ``ptxas_report``.

Nothing here runs at import time: this module is imported on machines
without nvcc or a GPU, where only the plain-torch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the lines of ptxas -v that describe a kernel: its name, its registers
# and shared memory, its stack and spills
_PTXAS_KEEP = re.compile(r"Compiling entry function|Used \d+ registers|"
                         r"spill stores")

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}     # source name -> nvcc wall seconds (0 if cached)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (src, out, tmp, Popen or None, t0)."""
    src, out = _target(name)
    if os.path.exists(out):
        return src, out, None, None, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return src, out, tmp, proc, time.perf_counter()


def _finish(name: str, started) -> ctypes.CDLL:
    src, out, tmp, proc, t0 = started
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {proc.returncode}):\n{err}")
        report = [ln.strip() for ln in err.splitlines()
                  if _PTXAS_KEEP.search(ln)]
        with open(f"{out}.ptxas.txt", "w") as f:
            f.write("\n".join(report) + "\n")
        os.replace(tmp, out)           # atomic: a half-written .so never loads
    BUILD_SECONDS[name] = time.perf_counter() - t0 if proc is not None else 0.0
    return ctypes.CDLL(out)


def build_all(names) -> dict:
    """Build (in parallel) and load every named source; returns
    {name: seconds spent in nvcc}."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        started = {n: _start(n) for n in todo}
        for n in todo:
            _LIBS[n] = _finish(n, started[n])
    return {n: BUILD_SECONDS.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def ptxas_report(name: str) -> list:
    """ptxas's per-kernel lines for ``csrc/<name>.cu`` as built (registers,
    shared memory, spill bytes); empty if the source is not built."""
    path = f"{_target(name)[1]}.ptxas.txt"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if ln]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if status != 0:
        lib.fdj_error_string.restype = ctypes.c_char_p
        lib.fdj_error_string.argtypes = [ctypes.c_int]
        msg = lib.fdj_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} "
                           f"(cudaError_t {status})")
