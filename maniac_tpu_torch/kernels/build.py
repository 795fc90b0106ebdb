"""Build the CUDA sources under csrc/ into one shared library and load it.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into a
library with a plain C interface (each kernel has an ``extern "C"``
launcher that returns its ``cudaError_t``), loaded with ctypes. The build
runs at first use, goes into ``kernels/_build/`` (git-ignored) and is keyed
by a hash of the sources and flags, so an unchanged tree reuses it.

No ``--use_fast_math``: expf, sincosf and erfcf must stay at full f32
accuracy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# last build's wall time in seconds (0.0 when the cached library was used)
# and the compiler's output (ptxas -v: registers, shared memory, spills)
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Path of the built library, building it first if needed."""
    global build_seconds, build_log
    so = BUILD_DIR / f"libmaniac_kernels_{_source_hash()}.so"
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every launcher's signature declared.
    Each launcher takes (pointer table, int table, float table, counts,
    stream) and returns a cudaError_t."""
    lib = ctypes.CDLL(str(library_path()))
    for name in ("resync_launch", "blockg_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.maniac_error_string.argtypes = [ctypes.c_int]
    lib.maniac_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, ptrs, ints, floats) -> None:
    """Call launcher ``name`` on the current CUDA stream with its pointer,
    int and float tables; raise if it reports an error (a refused launch
    never runs, and synchronize() would not report it)."""
    lib = library()
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i = (ctypes.c_int * len(ints))(*ints)
    f = (ctypes.c_float * len(floats))(*floats)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(p, len(ptrs), i, len(ints), f, len(floats),
                             stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: error {err} "
                           f"({lib.maniac_error_string(err).decode()})")
