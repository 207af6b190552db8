"""Adaptive Computation Kernel (paper §5.4) — the unified compute engine.

One module executes every GNN kernel by mode switching: GEMM mode,
SpDMM mode, SDDMM mode, vector-addition mode, plus the activation /
affine epilogues of the Activation Unit.  It mirrors
``repro/core/ack.py`` mode for mode.

Backends:
  * ``torch`` — plain torch tile ops (gathers, matmul), the counterpart
                of the JAX package's ``xla`` backend.  CPU tensors only.
  * ``cuda``  — GEMM and SUM/MEAN SpDMM run the hand-written kernels of
                :mod:`repro_torch.kernels` (on CPU tensors their wrappers
                use the plain versions).  MAX/MIN SpDMM, SDDMM and the
                vector / activation modes stay torch ops, as the JAX
                ``pallas`` backend leaves them to XLA.  It is the only
                backend on a CUDA device.

``compile_counter`` counts tile-kernel dispatches per *tile shape* (and
mode / backend).  The overlay property is that changing the GNN model or
the input graph changes only the instruction stream, never the set of
kernel variants, which the no-recompile test reads off this counter.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from .ir import Activation
from .reference import apply_activation

compile_counter: Dict[Tuple, int] = {}
_counter_lock = threading.Lock()

_BIG = 3.4e38


def _count(key: Tuple) -> None:
    with _counter_lock:
        compile_counter[key] = compile_counter.get(key, 0) + 1


def reset_counter() -> None:
    """Clear the kernel-dispatch counter (tests/benchmarks)."""
    with _counter_lock:
        compile_counter.clear()


def counter_snapshot() -> Dict[Tuple, int]:
    """Consistent copy of the counter, safe to iterate while serving."""
    with _counter_lock:
        return dict(compile_counter)


def _shape(t: torch.Tensor) -> Tuple[int, ...]:
    return tuple(int(d) for d in t.shape)


def _spdmm_torch(h_src, cols, vals, mask, acc, op: str):
    gathered = h_src[cols.long()]                  # [n1, w, n2]
    msg = gathered * vals[..., None]
    if op in ("sum", "mean"):
        s = torch.sum(msg, dim=1)
        return s if acc is None else acc + s
    if op == "max":
        msg = torch.where(mask[..., None], msg, -_BIG)
        return torch.maximum(acc, torch.amax(msg, dim=1))
    if op == "min":
        msg = torch.where(mask[..., None], msg, _BIG)
        return torch.minimum(acc, torch.amin(msg, dim=1))
    raise ValueError(op)


class ACK:
    """Mode-switched compute engine; see module docstring."""

    def __init__(self, backend: str = "torch") -> None:
        if backend not in ("torch", "cuda"):
            raise ValueError(f"ACK backend must be 'torch' or 'cuda', got "
                             f"{backend!r}")
        self.backend = backend
        if backend == "cuda":
            from repro_torch.kernels import ops as kops
            self._kops = kops

    def _torch_only(self, t: torch.Tensor) -> None:
        if t.device.type != "cpu":
            raise RuntimeError(
                "the 'torch' ACK backend runs on CPU tensors only; a CUDA "
                "device always runs the 'cuda' backend (hand kernels)")

    # -- GEMM ----------------------------------------------------------- #
    def gemm(self, h, w, acc=None):
        """``acc + h @ w``; ``acc=None`` means a zero accumulator."""
        _count(("gemm", _shape(h), _shape(w), self.backend))
        if self.backend == "cuda":
            return self._kops.gemm(h, w, acc)
        self._torch_only(h)
        y = torch.matmul(h, w)
        return y if acc is None else acc + y

    # -- SpDMM ---------------------------------------------------------- #
    def spdmm(self, h_src, cols, vals, mask, acc, flag, op: str = "sum"):
        """One ELL tile step.  ``acc=None`` (SUM/MEAN only) is a zero
        accumulator.  ``flag`` (rows that saw an edge) is updated when
        given; pass None where only MAX/MIN would read it."""
        _count(("spdmm", _shape(h_src), _shape(cols), op, self.backend))
        if self.backend == "cuda" and op in ("sum", "mean"):
            out = self._kops.spdmm(cols, vals, h_src, acc)
        else:
            if self.backend == "torch":
                self._torch_only(h_src)
            out = _spdmm_torch(h_src, cols, vals, mask, acc, op)
        if flag is not None:
            flag = flag | mask.any(dim=1)
        return out, flag

    # -- SDDMM ---------------------------------------------------------- #
    def sddmm(self, h_dst, h_src, cols, mask, acc, pair_sum: bool = False):
        _count(("sddmm", _shape(h_dst), _shape(cols), pair_sum,
                self.backend))
        if self.backend == "torch":
            self._torch_only(h_dst)
        idx = cols.long()
        if pair_sum:
            # GAT pair scores: score[r,k] = h_src[cols[r,k], 0] + h_dst[r, 1]
            part = h_src[:, 0][idx] + h_dst[:, 1][:, None]
        else:
            part = torch.einsum("rwf,rf->rw", h_src[idx], h_dst)
        return acc + torch.where(mask, part, torch.zeros_like(part))

    # -- Vector addition / epilogues ------------------------------------ #
    def vadd(self, a, b, alpha: float, beta: float):
        _count(("vadd", _shape(a), self.backend))
        return alpha * a + beta * b

    def act(self, x, act: Activation):
        _count(("act", _shape(x), int(act)))
        return apply_activation(x, Activation(act))

    def affine(self, x, scale, shift):
        _count(("affine", _shape(x)))
        return x * scale + shift

