"""Adaptive Computation Kernel (paper §5.4) — the unified compute engine.

One module executes every GNN kernel by mode switching: GEMM mode,
SpDMM mode, SDDMM mode, vector-addition mode, plus the activation /
affine epilogues of the Activation Unit.  It mirrors
``repro/core/ack.py`` mode for mode.

Backends:
  * ``torch`` — plain torch tile ops (gathers, matmul; dot-mode SDDMM is
                the kernel's plain version, ``kernels.ref``), the
                counterpart of the JAX package's ``xla`` backend.  CPU
                tensors only.
  * ``cuda``  — GEMM, SUM/MEAN SpDMM (a step or a run of steps) and
                dot-mode SDDMM run the
                hand-written kernels of :mod:`repro_torch.kernels` (on CPU
                tensors their wrappers use the plain versions).  MAX/MIN
                SpDMM, pair-sum SDDMM (GAT) and the vector / activation
                modes stay torch ops, as the JAX ``pallas`` backend leaves
                them to XLA.  It is the only backend on a CUDA device.

``compile_counter`` counts tile-kernel dispatches per *tile shape* (and
mode / backend).  The overlay property is that changing the GNN model or
the input graph changes only the instruction stream, never the set of
kernel variants, which the no-recompile test reads off this counter.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels.ref import sddmm_step_ref

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


# --------------------------------------------------------------------------- #
# Dense-aggregate GEMM: densified SpDMM for remapped high-density tiles
# (Dynasparse-style sparsity-adaptive mode switch).  The ELL tile is
# scattered into an (n1, n_src) dense adjacency block and dispatched as a
# matmul on the GEMM path.  Pad slots carry cols == 0 / vals == 0, so they
# deposit zeros harmlessly; duplicate cols sum, in slot order (the
# densify kernel and its plain version both fix that order, so a block
# has the same bits on every call).
# --------------------------------------------------------------------------- #
def densify_tile(cols, vals, n_src: int) -> torch.Tensor:
    """Scatter an ELL slice into its (n1, n_src) dense adjacency block:
    the hand densify kernel on a CUDA device, its plain version on the
    CPU.  Executors cache the result per (j, k, s) so one densification
    feeds every output fiber's GEMM dispatch."""
    from repro_torch.kernels import ops as kops
    return kops.densify(cols, vals, int(n_src))


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

    # -- Dense-aggregate GEMM (remapped SpDMM tiles) --------------------- #
    def gemm_agg(self, cols, vals, h_src, acc=None):
        """Aggregate a remapped ELL tile by densifying it and running the
        GEMM datapath (the hand GEMM kernel on the ``cuda`` backend):
        ``acc + dense(cols, vals) @ h_src``."""
        _count(("gemm_agg", _shape(h_src), _shape(cols), self.backend))
        if self.backend == "torch":
            self._torch_only(h_src)
        dense = densify_tile(cols, vals, h_src.shape[0])
        if self.backend == "cuda":
            return self._kops.gemm(dense, h_src, acc)
        y = torch.matmul(dense, h_src)
        return y if acc is None else acc + y

    # -- SpDMM ---------------------------------------------------------- #
    def spdmm(self, h_src, cols, vals, mask, acc, flag, op: str = "sum",
              row_len=None):
        """One ELL tile step.  ``acc=None`` (SUM/MEAN only) is a zero
        accumulator.  ``flag`` (rows that saw an edge) is updated when
        given; pass None where only MAX/MIN would read it.  ``row_len``
        (int32 [n1], 1 + each row's last live slot) lets the SUM/MEAN
        kernel stop each row's walk there; None walks every slot."""
        _count(("spdmm", _shape(h_src), _shape(cols), op, self.backend))
        if self.backend == "cuda" and op in ("sum", "mean"):
            out = self._kops.spdmm(cols, vals, h_src, acc, row_len)
        else:
            if self.backend == "torch":
                self._torch_only(h_src)
            out = _spdmm_torch(h_src, cols, vals, mask, acc, op)
        if flag is not None:
            flag = flag | mask.any(dim=1)
        return out, flag

    def spdmm_steps(self, steps, h, acc, op: str = "sum"):
        """A run of SUM/MEAN tile steps (:class:`kernels.ops.SpdmmSteps`,
        each reading rows [row_off, row_off + n_src) of the source matrix
        ``h``) added to ``acc`` (None: zero) in order: one launch of the
        SpDMM kernel on the ``cuda`` backend, the bits of :meth:`spdmm`
        over the steps one at a time; the ``torch`` backend runs them one
        at a time.  Each step counts as one dispatch of its tile shape."""
        if op not in ("sum", "mean"):
            raise ValueError(f"a step list sums (SUM/MEAN), not {op!r}")
        n = steps.n_src
        for cols, *_ in steps.steps:
            _count(("spdmm", (n, int(h.shape[1])), _shape(cols), op,
                    self.backend))
        if self.backend == "cuda":
            return self._kops.spdmm_steps(steps, h, acc)
        self._torch_only(h)
        for cols, vals, _, off in steps.steps:
            acc = _spdmm_torch(h[off:off + n], cols, vals, None, acc, op)
        return acc

    # -- SDDMM ---------------------------------------------------------- #
    def sddmm(self, h_dst, h_src, cols, mask, acc, pair_sum: bool = False):
        """One edge-scoring tile step, ``acc + where(mask, score, 0)``;
        ``acc=None`` is a zero accumulator."""
        _count(("sddmm", _shape(h_dst), _shape(cols), pair_sum,
                self.backend))
        if self.backend == "cuda" and not pair_sum:
            return self._kops.sddmm(h_dst, h_src, cols, mask, acc)
        if self.backend == "torch":
            self._torch_only(h_dst)
        if not pair_sum:
            return sddmm_step_ref(h_dst, h_src, cols, mask, acc)
        # GAT pair scores: score[r,k] = h_src[cols[r,k], 0] + h_dst[r, 1]
        part = h_src[:, 0][cols.long()] + h_dst[:, 1][:, None]
        part = torch.where(mask, part, torch.zeros_like(part))
        return part if acc is None else acc + part

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

