"""Wrappers around the hand-written CUDA kernels.

``gemm(x, w, acc)`` returns ``acc + x @ w`` and ``spdmm(cols, vals, h,
acc)`` returns ``acc + ELL(cols, vals) @ h``, both in fp32 (``acc`` may be
None).  Tensors on a CUDA device launch the kernel from ``csrc/`` on the
current stream, after checking device, dtype, shape and strides, and raise
on anything the kernel does not take; there is no fallback.  Tensors on
the CPU go to the plain versions in :mod:`repro_torch.kernels.ref`.

``LAUNCHES`` counts kernel launches per kernel (plain integers, bumped
only where a kernel is launched), so a run can show that it went through
the kernels; ``reset_launches`` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .build import entry

LAUNCHES: Dict[str, int] = {"gemm": 0, "spdmm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts: Optional[torch.Tensor]) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts if t is not None}) > 1:
        raise ValueError("kernel operands must all lie on one device, got "
                         f"{[str(t.device) for t in ts if t is not None]}")
    return False


def _check_matrix(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a matrix, got shape "
                         f"{tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: columns must be contiguous "
                         f"(stride {t.stride()})")
    if t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: row stride {t.stride(0)} is shorter "
                         f"than a row ({t.shape[1]})")


def _ld(t: torch.Tensor) -> int:
    return max(int(t.stride(0)), int(t.shape[1]), 1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gemm(x: torch.Tensor, w: torch.Tensor,
         acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + x @ w`` (fp32 in, fp32 out)."""
    if _on_cpu(x, w, acc):
        y = ref.gemm_ref(x, w)
        return y if acc is None else acc + y
    m, k = x.shape
    _check_matrix("gemm x", x, torch.float32)
    _check_matrix("gemm w", w, torch.float32, (k, w.shape[1]))
    n = w.shape[1]
    if acc is not None:
        _check_matrix("gemm acc", acc, torch.float32, (m, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = entry("gemm")(
        x.data_ptr(), w.data_ptr(),
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        m, n, k, _ld(x), _ld(w), _ld(acc) if acc is not None else 0,
        _ld(out), _stream(x))
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["gemm"] += 1
    return out


def spdmm(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
          acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + ELL(cols, vals) @ h`` for one [n1, w] ELL tile (fp32)."""
    if _on_cpu(cols, vals, h, acc):
        y = ref.spdmm_ref(cols, vals, h)
        return y if acc is None else acc + y
    n1, w = cols.shape
    _check_matrix("spdmm cols", cols, torch.int32)
    _check_matrix("spdmm vals", vals, torch.float32, (n1, w))
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError("spdmm: cols and vals must be contiguous")
    _check_matrix("spdmm h", h, torch.float32)
    f = h.shape[1]
    if acc is not None:
        _check_matrix("spdmm acc", acc, torch.float32, (n1, f))
    out = torch.empty((n1, f), dtype=torch.float32, device=h.device)
    rc = entry("spdmm")(
        cols.data_ptr(), vals.data_ptr(), h.data_ptr(),
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        n1, w, f, _ld(h), _ld(acc) if acc is not None else 0, _ld(out),
        _stream(h))
    if rc != 0:
        raise RuntimeError(f"spdmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["spdmm"] += 1
    return out
