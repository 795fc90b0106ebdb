"""Build the CUDA sources under csrc/ into one shared library and load it.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one library
with a plain C interface (each kernel has an ``extern "C"`` launcher that
returns its ``cudaError_t``), loaded with ctypes. ``launch`` keeps one
``_Launcher`` per launcher, whose argument tables are allocated once and
refilled in place, and reads the current stream's raw handle after
checking that the tensors lie on the current device. The build
runs at first use, goes into ``kernels/_build/`` (git-ignored) and is keyed
by a hash of the sources and flags, so an unchanged tree reuses it. Within
``variant(defines)`` launches go to a library built with extra macros
beside it (tools/section_split.py's clock64-instrumented build).

No ``--use_fast_math``: expf, sincosf and erfcf must stay at full f32
accuracy.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LAUNCHERS = ("resync_launch", "blockg_launch", "stepg_launch", "onehot_launch",
             "vpu_chain_launch", "cpass_launch", "gpass_launch",
             "noop_launch", "prim_check_launch", "threefry_launch")

# last build's wall time in seconds (0.0 when the cached library was used)
# and the compiler's output (ptxas -v: registers, shared memory, spills)
build_seconds = 0.0
build_log = ""
# the macros of the library launch() calls (variant)
_defines: tuple = ()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _flags(defines) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _source_hash(defines=()) -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(defines: tuple = ()) -> Path:
    """Path of the built library, building it first if needed; ``defines``
    (macro names) build a variant beside it (see variant)."""
    global build_seconds, build_log
    so = BUILD_DIR / f"libmaniac_kernels_{_source_hash(defines)}.so"
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *_flags(defines), "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, log, proc in zip(cu, logs, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o",
                os.path.join(tmp, "lib.so"), *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        # atomic: a concurrent loader sees all or nothing
        os.replace(os.path.join(tmp, "lib.so"), so)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return so


@functools.cache
def library(defines: tuple = ()) -> ctypes.CDLL:
    """The loaded kernel library (built with ``defines``) with every
    launcher's signature declared. Each launcher takes (pointer table, int
    table, float table, counts, stream) and returns a cudaError_t; the
    tables and the stream are declared as addresses (c_void_p), which
    _Launcher passes as ints: ctypes then converts no array per call."""
    lib = ctypes.CDLL(str(library_path(defines)))
    for name in LAUNCHERS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.maniac_error_string.argtypes = [ctypes.c_int]
    lib.maniac_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of the current device; no
    torch.cuda.Stream object is made (the calls exist in CUDA builds of
    PyTorch only, and only CUDA launches reach them). Raises unless
    ``device``, the device of the launch's tensors, is the current device:
    the launchers run on the host thread's current device (csrc/blockg.cu's
    cudaFuncSetAttribute and every <<<>>> launch take no device), so a
    launch with another card's tensors would hand that card's pointers to
    the wrong card. There is no silent switch: the caller places itself
    with torch.cuda.set_device."""
    current = torch._C._cuda_getDevice()
    if device.type != "cuda" or device.index != current:
        raise RuntimeError(
            f"kernel launch: the tensors are on {device}, but the current "
            f"CUDA device is cuda:{current}; call torch.cuda.set_device"
            f"({device}) before loading (the kernels launch on the current "
            f"device)")
    return torch._C._cuda_getCurrentRawStream(current)


class _Launcher:
    """One launcher of the library with its three argument tables allocated
    once (kept here while the launcher may read them) and refilled in place
    on every call (struct.pack_into into the ctypes arrays, whose addresses
    are passed: no ctypes object is made per call)."""

    def __init__(self, name: str, lib):
        self.fn = getattr(lib, name)
        self.sizes = None

    def _alloc(self, sizes) -> None:
        n_p, n_i, n_f = self.sizes = sizes
        self.p = (ctypes.c_void_p * n_p)()
        self.i = (ctypes.c_int * n_i)()
        self.f = (ctypes.c_float * n_f)()
        self.addr = tuple(ctypes.addressof(t) for t in (self.p, self.i,
                                                         self.f))
        self.pack_p = struct.Struct(f"={n_p}Q").pack_into
        self.pack_i = struct.Struct(f"={n_i}i").pack_into
        self.pack_f = struct.Struct(f"={n_f}f").pack_into

    def __call__(self, ptrs, ints, floats, stream: int) -> int:
        sizes = (len(ptrs), len(ints), len(floats))
        if sizes != self.sizes:
            self._alloc(sizes)
        self.pack_p(self.p, 0, *ptrs)
        if ints:
            self.pack_i(self.i, 0, *ints)
        if floats:
            self.pack_f(self.f, 0, *floats)
        p, i, f = self.addr
        return self.fn(p, sizes[0], i, sizes[1], f, sizes[2], stream)


# {(launcher name, defines): _Launcher}
_launchers: dict = {}


@contextlib.contextmanager
def variant(defines: tuple):
    """Within the block, launch() calls the library built with ``defines``
    (macro names, such as tools/section_split.py's MANIAC_SECTION_CLOCKS)
    in place of the production build; yields that library."""
    global _defines
    saved, _defines = _defines, tuple(defines)
    try:
        yield library(_defines)
    finally:
        _defines = saved


def launch(name: str, ptrs, ints, floats, device) -> None:
    """Call launcher ``name`` on the current CUDA stream with its pointer,
    int and float tables; ``device`` is the device of the tensors behind
    ``ptrs``, which must be the current CUDA device (current_stream raises
    otherwise). Raise if the launcher reports an error (a refused launch
    never runs, and synchronize() would not report it)."""
    key = (name, _defines)
    fn = _launchers.get(key)
    if fn is None:
        fn = _launchers[key] = _Launcher(name, library(_defines))
    err = fn(ptrs, ints, floats, current_stream(device))
    if err != 0:
        msg = library(_defines).maniac_error_string(err).decode()
        raise RuntimeError(f"{name} failed: error {err} ({msg})")
