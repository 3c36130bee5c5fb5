"""Lazy g++ build + ctypes load of the host-side C++ library.

The sources are this package's own copies of the JAX package's (the
HGSampling sampler, ``hgsampler.cpp``, and the batch-prep core of the
sorted-edge layout, ``sortbatch.cpp``). They compile with
``g++ -O3 -std=c++17 -shared -fPIC`` into one library under
``pyhgt_tpu_torch/_build/`` (git-ignored), named by a hash of the sources,
so a fresh checkout builds it at first use and an unchanged one reuses it.
Nothing here runs at import time.

``CALLS`` counts the calls into the library's entry points (by C name), as
the CUDA kernels' wrappers count their launches: set an entry to 0, run a
path, read it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = (_DIR / "hgsampler.cpp", _DIR / "sortbatch.cpp")

CALLS: "collections.Counter[str]" = collections.Counter()


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhgt_native-{h.hexdigest()[:12]}.so"


def build_library(force: bool = False) -> Path:
    """Compile the sources to one shared library unless it is built.
    Raises with the compiler's output on failure."""
    out = library_path()
    if force or not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-o", str(tmp), *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed and load; declares argtypes for the C ABI."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library()))
        c = ctypes
        lib.hgs_graph_create.restype = c.c_void_p
        lib.hgs_graph_create.argtypes = [
            c.c_int, c.c_int,
            c.POINTER(c.c_int), c.POINTER(c.c_int),
            c.POINTER(c.POINTER(c.c_int64)), c.POINTER(c.c_int64),
            c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.POINTER(c.c_int32)),
        ]
        lib.hgs_graph_destroy.restype = None
        lib.hgs_graph_destroy.argtypes = [c.c_void_p]
        lib.hgs_sample.restype = c.c_int
        lib.hgs_sample.argtypes = [
            c.c_void_p, c.c_uint64,
            c.c_int, c.c_int,
            c.c_int64, c.c_int,
            c.POINTER(c.c_int), c.POINTER(c.c_int64), c.POINTER(c.c_int32),
            c.c_int64,
            c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
            c.POINTER(c.c_int64),
            c.c_int64, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int64),
        ]
        i32p = c.POINTER(c.c_int32)
        lib.sb_counting_sort.restype = c.c_int
        lib.sb_counting_sort.argtypes = [
            i32p, c.c_int64, c.c_int32, i32p, i32p,
        ]
        lib.sb_tiled_aux.restype = c.c_int64
        lib.sb_tiled_aux.argtypes = [
            i32p, c.c_int64, c.c_int32, c.c_int32,
            i32p, i32p, i32p, i32p, i32p,
        ]
        lib.sb_pallas_aux.restype = c.c_int64
        lib.sb_pallas_aux.argtypes = [
            i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, c.c_int64,
            i32p, i32p, i32p, i32p,
        ]
        lib.sb_tab_window_aux.restype = c.c_int
        lib.sb_tab_window_aux.argtypes = [
            i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            i32p, i32p,
        ]
        u8p = c.POINTER(c.c_uint8)
        lib.sb_permute_build.restype = c.c_int
        lib.sb_permute_build.argtypes = [
            i32p, i32p, i32p, u8p, i32p, i32p, i32p, i32p,
            c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
            c.c_int32, c.c_int32,
            i32p, i32p, i32p, u8p, i32p, i32p, i32p,
            c.POINTER(c.c_float),
        ]
        _LIB = lib
        return lib
