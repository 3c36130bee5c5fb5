"""Build and load the port's hand-written CUDA kernels.

Each ``pyhgt_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library that
:mod:`ctypes` loads — no PyTorch headers, so a build takes seconds. Builds
land in ``pyhgt_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the shared headers, so an edited source rebuilds and an unchanged
one is reused.
Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# what nvcc printed for each built library (ptxas register/spill report)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source and
    of every shared header (``csrc/*.cuh``)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source not yet built, one ``nvcc`` process per
    source, all started together. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, path in out.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build sees old or new
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build([name])[name]))
