"""Build the hand-written CUDA kernels into shared libraries (ctypes).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``_build/lib<name>-<hash>.so``, with a plain C interface that
:mod:`repro_torch.kernels.ops` calls through :mod:`ctypes`.  The hash
covers the source and the flags, so an edited kernel rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them; :func:`library` builds on first use.

Nothing here runs when the package is imported: a machine without
``nvcc`` (or without a GPU) imports and tests the package on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("gemm", "spdmm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points (see the .cu files).
_ARGTYPES = {
    "gemm": ("gemm_f32", [_c_void_p] * 4 + [_c_int] * 3 + [_c_ll] * 4
             + [_c_void_p]),
    "spdmm": ("spdmm_f32", [_c_void_p] * 5 + [_c_int] * 3 + [_c_ll] * 3
              + [_c_void_p]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Per-source nvcc report of the last build in this process (ptxas -v).
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        build_log.setdefault(name, "cached")
        return
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)


def build_all(names: Optional[List[str]] = None) -> float:
    """Build every kernel library in parallel (one nvcc per source);
    returns the wall seconds spent."""
    t0 = time.perf_counter()
    names = list(names or SOURCES)
    with _lock:
        procs = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, procs[n])
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            fn_name, argtypes = _ARGTYPES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name``, with its argtypes set."""
    return getattr(library(name), _ARGTYPES[name][0])
