"""Build the hand-written CUDA kernels into shared libraries (ctypes).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``_build/lib<name>-<hash>.so``, with a plain C interface that
:mod:`repro_torch.kernels.ops` calls through :mod:`ctypes`.  The hash
covers the source and the flags, so an edited kernel rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them; :func:`library` builds on first use.
:func:`edited` and :func:`build_copies` build text-edited copies of a
source beside the real library (planted faults, tile-shape variants).

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("gemm", "spdmm", "sddmm", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_c_float = ctypes.c_float
# C signatures of the entry points (see the .cu files).
_ARGTYPES = {
    "gemm": ("gemm_f32", [_c_void_p] * 4 + [_c_int] * 3 + [_c_ll] * 4
             + [_c_void_p]),
    "gemm_mixed": ("gemm_mixed", [_c_void_p] * 4 + [_c_int] * 5
                   + [_c_ll] * 4 + [_c_void_p]),
    "spdmm": ("spdmm_f32", [_c_void_p] * 6 + [_c_int] * 3 + [_c_ll] * 3
              + [_c_void_p]),
    "spdmm_bf16": ("spdmm_bf16", [_c_void_p] * 6 + [_c_int] * 3
                   + [_c_ll] * 3 + [_c_void_p]),
    "sddmm": ("sddmm_f32", [_c_void_p] * 6 + [_c_int] * 4 + [_c_ll] * 2
              + [_c_void_p]),
    "flash_attention": ("flash_attention_fwd", [_c_void_p] * 4
                        + [_c_int] * 8 + [_c_float, _c_void_p]),
    "densify": ("ell_densify_f32", [_c_void_p] * 3 + [_c_int] * 3
                + [_c_ll, _c_void_p]),
}
# Entry points that live in another kernel's source (library).
_SOURCE_OF = {"densify": "gemm", "gemm_mixed": "gemm",
              "spdmm_bf16": "spdmm"}

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
    """The loaded library of source ``name`` (built on first use), with
    the argtypes of every entry point it holds set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            for ent in _ARGTYPES:
                if _SOURCE_OF.get(ent, ent) == name:
                    fn_name, argtypes = _ARGTYPES[ent]
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name``, with its argtypes set."""
    return getattr(library(_SOURCE_OF.get(name, name)), _ARGTYPES[name][0])


def edited(name: str, edits: Sequence[Tuple[str, str]]) -> str:
    """The text of ``csrc/<name>.cu`` with each (old, new) edit applied;
    each old text must appear in the source exactly once."""
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}.cu: edit text is not in the source "
                             f"exactly once: {old!r}")
        src = src.replace(old, new)
    return src


def build_copies(copies: Dict[str, Tuple[str, str]], out_dir: str
                 ) -> Dict[str, Tuple[Callable, str]]:
    """Build copies of kernel sources: ``copies`` maps a tag to (kernel
    name, .cu text).  Each is written to ``out_dir/<tag>.cu`` and built
    there, one ``nvcc`` per copy, all at once and together with the real
    libraries of the kernels named.  Returns tag -> (the copy's C entry
    point, argtypes set; its nvcc report)."""
    os.makedirs(out_dir, exist_ok=True)
    procs: Dict[str, subprocess.Popen] = {}
    try:
        for tag, (_, text) in copies.items():
            cu = os.path.join(out_dir, f"{tag}.cu")
            with open(cu, "w") as fh:
                fh.write(text)
            procs[tag] = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o",
                 os.path.join(out_dir, f"lib{tag}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_all(sorted({name for name, _ in copies.values()}))
        out = {}
        for tag, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {tag}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            fn_name, argtypes = _ARGTYPES[copies[tag][0]]
            fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"lib{tag}.so")),
                         fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            out[tag] = (fn, log)
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
