"""Wrappers around the hand-written CUDA kernels.

``gemm(x, w, acc, out_dtype)`` returns ``acc + x @ w``, ``spdmm(cols, vals,
h, acc, row_len, out_dtype)`` returns ``acc + ELL(cols, vals) @ h`` and
``sddmm(h_dst, h_src, cols, mask, acc, out_dtype)`` returns ``acc +
where(mask, <h_dst[r], h_src[cols[r, k]]>, 0)``, all summed in fp32
(``acc``, ``row_len`` and ``mask`` may be None) and rounded once to
``out_dtype`` (fp32, the default, or bf16; ``acc`` stays fp32); GEMM's
x / w, SpDMM's h and SDDMM's h_dst / h_src may also be bf16, as the
Pallas kernels take them;
``densify(cols, vals, n_src)`` returns the dense [n1, n_src] block of an
ELL tile (duplicate columns summed in slot order), the GEMM kernel's
operand for a sparsity-remapped aggregate step;
``flash_attention(q, k, v, causal, window, out_dtype)`` returns
``softmax(q k^T d^-1/2 [+ causal / sliding-window mask]) v`` per head of
[BH, T, d] tensors in fp32 or bf16, any head dim d, with k of [BH / G, T,
d] for grouped KV heads and v of [BH / G, T, dv], 1 <= dv <= d (its own
width: MLA's), as [BH, T, dv] in q's dtype or ``out_dtype``.
Tensors on a CUDA device
launch the kernel from ``csrc/`` on the current stream, after checking
device, dtype, shape and strides, and raise on anything the kernel does
not take; there is no fallback.  Tensors on the CPU go to the plain
versions in :mod:`repro_torch.kernels.ref`.  Tensors on the ``meta``
device (the dry-run's, ``launch/op_analysis.py``) run neither: the wrapper
returns an empty meta result of the kernel's shape and dtype and reports
the kernel's flops and bytes (the formulas of the bounds in ``PERF.md``
§6) to the thread's :func:`meta_costs` sink, if one is open.  Operands on
mixed devices, or on any other device type, raise.

ELL column indices are not checked on the card, where a check would cost
a device round trip per launch: the executor validates every tile's
columns once, when it stages them.  The SpDMM kernel trusts them; the
SDDMM kernel reads no row outside ``h_src`` and scores a live slot whose
column is out of range NaN.  On the CPU ``sddmm`` raises ValueError for
such a column.

``spdmm_steps(steps, h, acc, out_dtype)`` runs a list of SpDMM steps
(:class:`SpdmmSteps`: ELL tiles over row blocks of one source matrix)
added to ``acc`` in list order, in one launch of the same kernel; each
step gives the bits of one ``spdmm`` call chained through ``acc``.

``LAUNCHES`` counts kernel launches per kernel (plain integers, bumped
only where a kernel is launched, under a lock since overlays launch from
their own threads), so a run can show that it went through the kernels;
``LAUNCHES["spdmm"]`` counts the SpDMM tile steps the kernel ran, and
``KERNEL_LAUNCHES["spdmm"]`` its launches (a step list is one, two with
its hub pass).
A wrapper called while its thread captures a CUDA graph
(:func:`capturing`) launches nothing: the kernel is recorded into the
graph and counted in the capture's own dict, not in ``LAUNCHES``.
``REPLAYED`` counts the kernels CUDA-graph replays launch, never a
wrapper: each replay adds its graph's captured counts
(:func:`note_replay`).  ``LAUNCHES`` plus ``REPLAYED`` is every kernel
the card ran (:func:`launch_totals`; :func:`kernel_launch_totals` for
``KERNEL_LAUNCHES``); ``reset_launches`` zeroes them all.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

from . import ref
from .build import entry

LAUNCHES: Dict[str, int] = {"gemm": 0, "spdmm": 0, "sddmm": 0,
                            "flash_attention": 0, "densify": 0}
_launch_lock = threading.Lock()


REPLAYED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
KERNEL_LAUNCHES: Dict[str, int] = {"spdmm": 0}
KERNEL_REPLAYED: Dict[str, int] = dict.fromkeys(KERNEL_LAUNCHES, 0)
_KERNEL = "/kernel"             # a capture's key of KERNEL_LAUNCHES' counts
_tls = threading.local()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            REPLAYED[k] = 0
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0
            KERNEL_REPLAYED[k] = 0


def _launched(name: str, steps: int = 1, kernels: int = 1) -> None:
    """Count a call of kernel ``name`` that ran ``steps`` tile steps in
    ``kernels`` launches."""
    captured = getattr(_tls, "captured", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + steps
        if name in KERNEL_LAUNCHES:
            key = name + _KERNEL
            captured[key] = captured.get(key, 0) + kernels
        return
    with _launch_lock:
        LAUNCHES[name] += steps
        if name in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[name] += kernels


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Open while this thread captures a CUDA graph: yield a dict that
    counts, kernel by kernel, the kernels the wrappers record into it
    (whatever other threads launch meanwhile)."""
    prev = getattr(_tls, "captured", None)
    _tls.captured = counts = {}
    try:
        yield counts
    finally:
        _tls.captured = prev


def note_replay(launches: Dict[str, int]) -> None:
    """Count one replay of a graph that captured ``launches``."""
    with _launch_lock:
        for k, n in launches.items():
            if k.endswith(_KERNEL):
                KERNEL_REPLAYED[k[:-len(_KERNEL)]] += n
            else:
                REPLAYED[k] += n


def launch_totals() -> Dict[str, int]:
    """``LAUNCHES`` plus ``REPLAYED``: every launch the card ran."""
    with _launch_lock:
        return {k: LAUNCHES[k] + REPLAYED[k] for k in LAUNCHES}


def kernel_launch_totals() -> Dict[str, int]:
    """``KERNEL_LAUNCHES`` plus the replays': every launch of the SpDMM
    kernel the card ran (``launch_totals()["spdmm"]`` counts its steps)."""
    with _launch_lock:
        return {k: KERNEL_LAUNCHES[k] + KERNEL_REPLAYED[k]
                for k in KERNEL_LAUNCHES}


class CudaGraph:
    """The port's one CUDA-graph primitive (the executor's replays and
    the LM serve step).  :meth:`capture` records ``fn``'s launches
    (nothing runs) and returns its output, whose memory the graph keeps;
    :meth:`replay` launches them again on the current stream.  The
    capture runs on the current stream, or on a side stream when that is
    the device's default stream (which cannot capture), in thread-local
    mode, so other threads keep issuing work.  Whatever ``fn`` needs set
    up (kernel builds, staging) is done by an eager call before.

    ``pool`` (from :meth:`new_pool`) is a memory pool shared with other
    graphs: a later capture reuses the memory an earlier one freed while
    capturing, so graphs that share a pool must never replay at the same
    time, and an output stays the graph's until the graph is dropped."""

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def new_pool(device: torch.device):
        return torch.cuda.graph_pool_handle()

    def __init__(self, device: torch.device, pool=None) -> None:
        self.device, self.pool = device, pool
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        cur = torch.cuda.current_stream(self.device)
        side = cur == torch.cuda.default_stream(self.device)
        stream = torch.cuda.Stream(self.device) if side else cur
        if side:
            stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()    # the capture is invalid
                raise
            self.graph.capture_end()
        if side:
            cur.wait_stream(stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


def _route(*ts: Optional[torch.Tensor]) -> str:
    """Where the operands lie, which picks the wrapper's route: "cpu"
    (the plain version), "cuda" (the kernel, all on one card) or "meta"
    (shapes and costs only)."""
    devs = {t.device for t in ts if t is not None}
    kinds = {d.type for d in devs}
    if len(kinds) > 1 or (kinds == {"cuda"} and len(devs) > 1):
        raise ValueError(f"kernel operands lie on mixed devices: "
                         f"{[str(t.device) for t in ts if t is not None]}")
    (kind,) = kinds
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"kernel operands lie on {kind!r}, a device type "
                         f"no wrapper takes (cpu, cuda or meta)")
    return kind


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@contextlib.contextmanager
def meta_costs(sink) -> Iterator[None]:
    """While open, every wrapper called on meta operands in this thread
    calls ``sink(name, flops, nbytes)`` with its kernel's cost."""
    prev = getattr(_tls, "meta_sink", None)
    _tls.meta_sink = sink
    try:
        yield
    finally:
        _tls.meta_sink = prev


def _meta(name: str, out: torch.Tensor, flops: float,
          nbytes: float) -> torch.Tensor:
    """A meta call's result: ``out`` (empty, on meta), its cost reported."""
    sink = getattr(_tls, "meta_sink", None)
    if sink is not None:
        sink(name, float(flops), float(nbytes))
    return out


def flash_pairs(tq: int, tk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the flash kernel computes: all Tq Tk, or
    under ``causal`` those with qpos >= kpos (the kernel skips the key
    blocks past a query block's last row) and, with a window W,
    qpos - kpos < W (it skips the blocks before the first row's window),
    both counted from 0: the pair count of the bounds in ``PERF.md``
    §6."""
    if not causal:
        return tq * tk
    m = min(tq, tk)
    pairs = m * (m + 1) // 2 + (tq - m) * tk     # sum of min(tk, i + 1)
    if window > 0:
        w = max(0, tq - window)
        pairs -= w * (w + 1) // 2                # sum of max(0, i - W + 1)
    return pairs


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


_MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(name: str, dtype: torch.dtype) -> None:
    if dtype not in _MATMUL_DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {dtype}")


def _copy_width(ptr: int, ld: int, itemsize: int) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that every row of an operand
    at address ``ptr`` with row stride ``ld`` elements starts on a
    multiple of (``copy_width`` in ``csrc/gemm.cu``)."""
    x = ptr | (ld * itemsize) | 16
    return x & -x


def gemm_bf16_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """How the GEMM kernel's bf16 body loads bf16 operands x and w: "tma"
    where both start on 16-byte boundaries and their row strides (as the
    wrapper passes them) are multiples of 16 bytes, else "staged" (the
    producer warp copies them with cp.async, or 2-byte loads, into the same
    swizzled layout).  Both routes run the same products, so they give the
    same bits; the C side applies the same rule (``gemm_bf16_plan``)."""
    widths = [_copy_width(t.data_ptr(), _ld(t), t.element_size())
              for t in (x, w)]
    return "tma" if widths == [16, 16] else "staged"


def gemm(x: torch.Tensor, w: torch.Tensor,
         acc: Optional[torch.Tensor] = None,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``acc + x @ w`` summed in fp32 and returned in ``out_dtype`` (fp32,
    the Pallas kernel's default, or bf16); x and w both fp32 or both bf16,
    ``acc`` fp32.  fp32 operands run the tiled CUDA-core kernel (a bf16
    output is its fp32 result rounded once), bf16 ones the tensor-core body
    (``csrc/gemm.cu``; :func:`gemm_bf16_route` says how it loads them)."""
    _check_dtype("gemm out_dtype", out_dtype)
    route = _route(x, w, acc)
    if route == "cpu":
        y = ref.gemm_ref(x, w)
        return (y if acc is None else acc + y).to(out_dtype)
    m, k = x.shape
    if route == "meta":
        n = w.shape[1]
        out = torch.empty((m, n), dtype=out_dtype, device="meta")
        return _meta("gemm", out, 2.0 * m * n * k, _nbytes(x, w, acc, out))
    _check_dtype("gemm x", x.dtype)
    _check_matrix("gemm x", x, x.dtype)
    _check_matrix("gemm w", w, x.dtype, (k, w.shape[1]))
    n = w.shape[1]
    if acc is not None:
        _check_matrix("gemm acc", acc, torch.float32, (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    acc_p = acc.data_ptr() if acc is not None else None
    acc_ld = _ld(acc) if acc is not None else 0
    if x.dtype == out_dtype == torch.float32:
        rc = entry("gemm")(x.data_ptr(), w.data_ptr(), acc_p,
                           out.data_ptr(), m, n, k, _ld(x), _ld(w), acc_ld,
                           _ld(out), _stream(x))
    else:
        rc = entry("gemm_mixed")(
            x.data_ptr(), w.data_ptr(), acc_p, out.data_ptr(),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            m, n, k, _ld(x), _ld(w), acc_ld, _ld(out), _stream(x))
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {rc}")
    _launched("gemm")
    return out


def densify(cols: torch.Tensor, vals: torch.Tensor,
            n_src: int) -> torch.Tensor:
    """The [n1, n_src] fp32 block holding, at (r, c), the sum of
    ``vals[r, k]`` over the slots k with ``cols[r, k] == c``, added in slot
    order from 0 (so a duplicated column gives the same bits every call);
    columns outside [0, n_src) are dropped."""
    route = _route(cols, vals)
    if route == "cpu":
        return ref.densify_ref(cols, vals, n_src)
    n1, w = cols.shape
    if route == "meta":
        out = torch.empty((n1, n_src), dtype=torch.float32, device="meta")
        return _meta("densify", out, float(n1 * w),
                     _nbytes(cols, vals, out))
    _check_matrix("densify cols", cols, torch.int32)
    _check_matrix("densify vals", vals, torch.float32, (n1, w))
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError("densify: cols and vals must be contiguous")
    out = torch.empty((n1, n_src), dtype=torch.float32, device=cols.device)
    rc = entry("densify")(cols.data_ptr(), vals.data_ptr(), out.data_ptr(),
                          n1, w, n_src, _ld(out), _stream(cols))
    if rc != 0:
        raise RuntimeError(f"densify kernel launch failed: CUDA error {rc}")
    _launched("densify")
    return out


def spdmm(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
          acc: Optional[torch.Tensor] = None,
          row_len: Optional[torch.Tensor] = None,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``acc + ELL(cols, vals) @ h`` for one [n1, w] ELL tile (fp32 sums;
    h fp32 or bf16, widened as it is gathered; ``acc`` fp32), rounded
    once to ``out_dtype`` (fp32 or bf16) as it is stored: the SpDMM
    kernel on a list of this one step (the bits of that step in any
    :func:`spdmm_steps` list).
    ``row_len`` (int32 [n1], optional) is each row's live length, 1 + its
    last live slot (0 for a row with no edge): slots from row_len[r] on
    are not walked, which leaves the result unchanged when they are pads
    (vals == 0).  None walks all w slots."""
    _check_dtype("spdmm out_dtype", out_dtype)
    route = _route(cols, vals, h, acc, row_len)
    if route == "cpu":
        return ref.spdmm_step_ref(cols, vals, h, acc, row_len, out_dtype)
    n1, w = cols.shape
    if route == "meta":
        # Every slot counts: a meta tile has no live lengths to skip by.
        f = h.shape[1]
        out = torch.empty((n1, f), dtype=out_dtype, device="meta")
        return _meta("spdmm", out, 2.0 * n1 * w * f,
                     _nbytes(cols, vals, h, acc, row_len, out))
    _check_matrix("spdmm cols", cols, torch.int32)
    _check_matrix("spdmm vals", vals, torch.float32, (n1, w))
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError("spdmm: cols and vals must be contiguous")
    _check_dtype("spdmm h", h.dtype)
    _check_matrix("spdmm h", h, h.dtype)
    f = h.shape[1]
    if acc is not None:
        _check_matrix("spdmm acc", acc, torch.float32, (n1, f))
    if row_len is not None and (row_len.dtype != torch.int32
                                or tuple(row_len.shape) != (n1,)
                                or not row_len.is_contiguous()):
        raise ValueError(f"spdmm row_len: expected contiguous int32 "
                         f"[{n1}], got {row_len.dtype} "
                         f"{tuple(row_len.shape)}")
    out = torch.empty((n1, f), dtype=out_dtype, device=h.device)
    ptrs = (cols.data_ptr(), vals.data_ptr(), h.data_ptr(),
            acc.data_ptr() if acc is not None else None, out.data_ptr(),
            row_len.data_ptr() if row_len is not None else None)
    tail = (n1, w, f, _ld(h), _ld(acc) if acc is not None else 0, _ld(out),
            _stream(h))
    if out_dtype == torch.float32:
        rc = entry("spdmm" if h.dtype == torch.float32 else "spdmm_bf16")(
            *ptrs, *tail)
    else:
        rc = entry("spdmm_bf16_out")(*ptrs, int(h.dtype == torch.bfloat16),
                                     *tail)
    if rc != 0:
        raise RuntimeError(f"spdmm kernel launch failed: CUDA error {rc}")
    _launched("spdmm")
    return out


SPDMM_SPAN = 64     # slots a span of the SpDMM kernel (SPAN, csrc/spdmm.cu)
# A row that walks more slots than this over a whole step list is a hub
# row: its step sums come from the kernel's hub pass, spread over the card.
SPDMM_HUB_SLOTS = 128


class SpdmmSteps:
    """A list of SpDMM steps over row blocks of one source matrix, in the
    order :func:`spdmm_steps` adds them.  Step i is ``(cols, vals,
    row_len, row_off)``: an [n1, w_i] ELL tile (int32 cols, fp32 vals,
    both contiguous; ``row_len`` a contiguous int32 [n1] or None, as
    :func:`spdmm` takes it) whose column c names row ``row_off + c`` of h;
    its columns lie in [0, ``n_src``) (the executor checks them when it
    stages the tiles).  On a CUDA device the kernel's table of the steps
    (int64 [n, 5]: the three pointers, row_off and w) is uploaded here,
    once, and the tiles are held so that its pointers stay valid: build a
    list outside any CUDA-graph capture, and a capture uploads nothing.

    Hub rows, those that walk more than ``hub_slots`` slots over the whole
    list (``row_len`` summed, read back once here), are found here too:
    the kernel computes each of their (row, step) sums in a hub pass spread
    over the card, in the same order, so the bits do not depend on which
    rows are hubs (``hub_slots`` None: no hub pass)."""

    def __init__(self, steps, n_src: int,
                 hub_slots: Optional[int] = SPDMM_HUB_SLOTS) -> None:
        self.steps = [tuple(s) for s in steps]
        if not self.steps:
            raise ValueError("SpdmmSteps: no steps")
        self.n_src = int(n_src)
        self.n1 = int(self.steps[0][0].shape[0])
        self.device = self.steps[0][0].device
        for i, (cols, vals, row_len, off) in enumerate(self.steps):
            _check_matrix(f"spdmm_steps cols[{i}]", cols, torch.int32)
            _check_matrix(f"spdmm_steps vals[{i}]", vals, torch.float32,
                          (self.n1, cols.shape[1]))
            if cols.shape[0] != self.n1 or not (cols.is_contiguous()
                                                and vals.is_contiguous()):
                raise ValueError(f"spdmm_steps step {i}: cols and vals must "
                                 f"be contiguous [{self.n1}, w]")
            if row_len is not None and (row_len.dtype != torch.int32
                                        or tuple(row_len.shape) != (self.n1,)
                                        or not row_len.is_contiguous()):
                raise ValueError(f"spdmm_steps row_len[{i}]: expected "
                                 f"contiguous int32 [{self.n1}]")
            if int(off) < 0 or any(t is not None and t.device != self.device
                                   for t in (cols, vals, row_len)):
                raise ValueError(f"spdmm_steps step {i}: a negative row "
                                 "offset, or tiles on mixed devices")
        self.rows = max(int(s[3]) for s in self.steps) + self.n_src
        if self.rows >= 2 ** 31:
            raise ValueError(f"spdmm_steps: the steps read {self.rows} rows "
                             "of h; the kernel indexes fewer than 2^31")
        self.table = self.hubs = None
        self.n_hub = self.hub_walked = self.hub_longest = 0
        if self.device.type == "cuda":
            self.table = torch.tensor(
                [[c.data_ptr(), v.data_ptr(),
                  0 if r is None else r.data_ptr(), int(off), c.shape[1]]
                 for c, v, r, off in self.steps],
                dtype=torch.int64).to(self.device)
            if hub_slots is not None:
                self._find_hubs(int(hub_slots))

    def _find_hubs(self, hub_slots: int) -> None:
        """The hub rows' entries, row by row in step order (int64 [E, 4]:
        cols and vals at the row, row_off, len | step << 32), each row's
        hub index (int32 [n1], -1 elsewhere) and first entry (int32
        [H + 1]), on the device."""
        lens = torch.stack([
            torch.full((self.n1,), c.shape[1], dtype=torch.int64)
            if r is None else r.cpu().long().clamp(0, c.shape[1])
            for c, _, r, _ in self.steps])                      # [n, n1]
        heavy = torch.nonzero(lens.sum(0) > hub_slots).flatten()
        if not heavy.numel():
            return
        per = lens[:, heavy].t()                                # [H, n]
        h_idx, t_idx = torch.nonzero(per > 0, as_tuple=True)
        rows = heavy[h_idx]
        w = torch.tensor([c.shape[1] for c, *_ in self.steps])[t_idx]
        cols0 = torch.tensor([c.data_ptr() for c, *_ in self.steps])
        vals0 = torch.tensor([v.data_ptr() for _, v, *_ in self.steps])
        offs = torch.tensor([int(s[3]) for s in self.steps])
        entries = torch.stack([cols0[t_idx] + 4 * rows * w,
                               vals0[t_idx] + 4 * rows * w, offs[t_idx],
                               per[h_idx, t_idx] | (t_idx << 32)], 1)
        of_row = torch.full((self.n1,), -1, dtype=torch.int32)
        of_row[heavy] = torch.arange(heavy.numel(), dtype=torch.int32)
        first = torch.zeros(heavy.numel() + 1, dtype=torch.int32)
        first[1:] = torch.cumsum((per > 0).sum(1), 0)
        self.hubs = tuple(t.contiguous().to(self.device)
                          for t in (entries, of_row, first))
        self.n_hub = int(entries.shape[0])
        self.hub_walked, self.hub_longest = int(per.sum()), int(per.max())

    def __len__(self) -> int:
        return len(self.steps)


def spdmm_steps(steps: SpdmmSteps, h: torch.Tensor,
                acc: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(((acc + S_1) + S_2) + ...)`` over the steps of ``steps``, S_i the
    ELL tile of step i times rows [row_off_i, row_off_i + n_src) of h:
    fp32 sums (h fp32 or bf16, [>= ``steps.rows``, f], any row stride,
    widened as it is gathered; ``acc`` fp32 [n1, f] or None, a zero
    accumulator), rounded once to ``out_dtype`` as it is stored.  One
    launch of the kernel ``spdmm`` runs, with the bits of ``spdmm`` over
    the steps one at a time, chained through ``acc``."""
    _check_dtype("spdmm_steps out_dtype", out_dtype)
    route = _route(steps.steps[0][0], h, acc)
    if route == "cpu":
        return ref.spdmm_steps_ref(steps.steps, h, acc, steps.n_src,
                                   out_dtype)
    n1, f = steps.n1, h.shape[1]
    if route == "meta":
        out = torch.empty((n1, f), dtype=out_dtype, device="meta")
        slots = sum(c.numel() for c, *_ in steps.steps)
        return _meta("spdmm", out, 2.0 * slots * f,
                     _nbytes(*(t for s in steps.steps for t in s[:3]), h,
                             acc, out))
    _check_dtype("spdmm_steps h", h.dtype)
    _check_matrix("spdmm_steps h", h, h.dtype)
    if h.shape[0] < steps.rows:
        raise ValueError(f"spdmm_steps h: the steps read {steps.rows} rows, "
                         f"h has {h.shape[0]}")
    if acc is not None:
        _check_matrix("spdmm_steps acc", acc, torch.float32, (n1, f))
    out = torch.empty((n1, f), dtype=out_dtype, device=h.device)
    hubs = (None,) * 3
    scratch = None
    if steps.n_hub:
        hubs = tuple(t.data_ptr() for t in steps.hubs)
        scratch = torch.empty((steps.n_hub, f), dtype=torch.float32,
                              device=h.device)
    rc = entry("spdmm_steps")(
        steps.table.data_ptr(), len(steps), h.data_ptr(),
        int(h.dtype == torch.bfloat16),
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        int(out_dtype == torch.bfloat16), n1, f, _ld(h),
        _ld(acc) if acc is not None else 0, _ld(out), hubs[0], steps.n_hub,
        hubs[1], hubs[2], scratch.data_ptr() if scratch is not None else None,
        _stream(h))
    if rc != 0:
        raise RuntimeError(f"spdmm kernel launch failed: CUDA error {rc}")
    _launched("spdmm", len(steps), 1 + bool(steps.n_hub))
    return out


def sddmm(h_dst: torch.Tensor, h_src: torch.Tensor, cols: torch.Tensor,
          mask: Optional[torch.Tensor] = None,
          acc: Optional[torch.Tensor] = None,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``acc + where(mask, SDDMM(h_dst, h_src, cols), 0)`` for one [n1, w]
    ELL tile, summed in fp32 and rounded once to ``out_dtype`` (fp32 or
    bf16); h_dst and h_src both fp32 or both bf16 (widened as they are
    read), ``acc`` fp32.  ``mask`` None scores every slot (pad slots score
    row 0, as the Pallas kernel does), ``acc`` None is a zero accumulator.
    ``cols`` index rows of ``h_src``; see the module docstring for a column
    out of range."""
    _check_dtype("sddmm out_dtype", out_dtype)
    route = _route(h_dst, h_src, cols, mask, acc)
    if route == "meta":
        n1, w = cols.shape
        out = torch.empty((n1, w), dtype=out_dtype, device="meta")
        return _meta("sddmm", out, 2.0 * n1 * w * h_dst.shape[1],
                     _nbytes(h_dst, h_src, cols, mask, acc, out))
    if route == "cpu":
        if cols.numel() and (int(cols.min()) < 0
                             or int(cols.max()) >= h_src.shape[0]):
            raise ValueError(f"sddmm cols: indices outside [0, "
                             f"{h_src.shape[0]})")
        return ref.sddmm_step_ref(h_dst, h_src, cols, mask, acc, out_dtype)
    n1, w = cols.shape
    _check_matrix("sddmm cols", cols, torch.int32)
    _check_dtype("sddmm h_dst", h_dst.dtype)
    _check_matrix("sddmm h_dst", h_dst, h_dst.dtype)
    f = h_dst.shape[1]
    if h_dst.shape[0] != n1:
        raise ValueError(f"sddmm h_dst: expected {n1} rows, got "
                         f"{h_dst.shape[0]}")
    _check_matrix("sddmm h_src", h_src, h_dst.dtype)
    if h_src.shape[1] != f or h_src.shape[0] < 1:
        raise ValueError(f"sddmm h_src: expected [n_src >= 1, {f}], got "
                         f"{tuple(h_src.shape)}")
    if mask is not None:
        _check_matrix("sddmm mask", mask, torch.bool, (n1, w))
    if acc is not None:
        _check_matrix("sddmm acc", acc, torch.float32, (n1, w))
    if not all(t is None or t.is_contiguous() for t in (cols, mask, acc)):
        raise ValueError("sddmm: cols, mask and acc must be contiguous")
    out = torch.empty((n1, w), dtype=out_dtype, device=cols.device)
    ptrs = (h_dst.data_ptr(), h_src.data_ptr(), cols.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            acc.data_ptr() if acc is not None else None, out.data_ptr())
    tail = (n1, w, f, h_src.shape[0], _ld(h_dst), _ld(h_src), _stream(cols))
    in_bf16 = h_dst.dtype == torch.bfloat16
    if out_dtype == torch.float32:
        rc = entry("sddmm_bf16" if in_bf16 else "sddmm")(*ptrs, *tail)
    else:
        rc = entry("sddmm_bf16_out")(*ptrs, int(in_bf16), *tail)
    if rc != 0:
        raise RuntimeError(f"sddmm kernel launch failed: CUDA error {rc}")
    _launched("sddmm")
    return out


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The flash kernel's bodies, by the code of its C entry
# ``flash_attention_body`` (codes 2 and 6 were the d-sliced bodies, which
# the single-pass bodies in clusters replaced).
FLASH_BODIES = {1: "fp32", 3: "bf16", 4: "bf16 warp-specialised",
                5: "bf16 single-pass", 7: "fp32 single-pass"}


def flash_body(dtype: torch.dtype, d: int, dv: int) -> str:
    """The body ``flash_attention`` runs on the card for q / k of head dim
    ``d``, v of width ``dv`` and operands of ``dtype``
    (``csrc/flash_attention.cu``'s ``flash_body``, which the C entry
    ``flash_attention_body`` reports): fp32 on CUDA cores up to d = 256,
    the fp32 single-pass body past it; bf16 on the tensor cores, the
    warp-specialised body up to d = 256 ("bf16" up to d = 128, its DQK 64
    / 128 instantiations, "bf16 warp-specialised" past it, DQK 192 /
    256), the single-pass body past it.  Each single-pass body runs in one
    CTA a (head, query tile) up to d = 576 with dv <= 512, and beyond that
    in a thread-block cluster of CTAs that split d and dv between them
    (:func:`flash_cluster` says how many)."""
    if dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_body: expected float32 or bfloat16, got "
                        f"{dtype}")
    if not 1 <= dv <= d:
        raise ValueError(f"flash_body: need 1 <= dv <= d, got d={d}, "
                         f"dv={dv}")
    if dtype == torch.float32:
        code = 1 if d <= 256 else 7
    else:
        code = 3 if d <= 128 else 4 if d <= 256 else 5
    return FLASH_BODIES[code]


def flash_cluster(dtype: torch.dtype, d: int, dv: int) -> int:
    """The CTAs of one thread-block cluster the flash kernel launches for
    these operands (1: no cluster), as its C entry
    ``flash_attention_cluster`` reports; the rule lives in the C source
    only.  Needs the built library (a card)."""
    if dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_cluster: expected float32 or bfloat16, got "
                        f"{dtype}")
    n = entry("flash_cluster")(_FLASH_DTYPES[dtype], d, dv)
    if n < 1:
        raise ValueError(f"flash_cluster: need 1 <= dv <= d, got d={d}, "
                         f"dv={dv}")
    return n


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``softmax(q k^T d^-1/2 [+ mask]) v`` for q [BH, Tq, d], k [BH / G,
    Tk, d] and v [BH / G, Tk, dv] with 1 <= dv <= d (dv = d is the Pallas
    kernel's contract), all fp32 or all bf16, contiguous, any d >= 1;
    returns [BH, Tq, dv] in ``out_dtype`` (fp32 or bf16; None is q's
    dtype, as in the Pallas kernel), fp32 math inside and one rounding at
    the store (:func:`flash_body` names the kernel's body: past d = 256
    the single-pass bodies, in one CTA a query tile up to d = 576 with dv
    <= 512 and in a thread-block cluster beyond it, any d).  The causal
    mask is the Pallas
    kernel's ``qpos >= kpos``, both counted from 0; ``window`` W > 0
    (causal only, Tq <= Tk) also masks ``qpos - kpos >= W``, JAX's
    ``_mask_bias`` (0 is no window).  With G > 1 (G must divide BH) the
    query heads of a group are adjacent: query head ``bh`` reads KV head
    ``bh // G``; G = 1 is one KV head per query head."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention {name}: expected [BH, T, d], "
                             f"got shape {tuple(t.shape)}")
    bh, tq, d = q.shape
    bkv, tk, dv = k.shape[0], k.shape[1], v.shape[2]
    if (k.shape[2] != d or v.shape[:2] != k.shape[:2] or bkv < 1
            or bh % bkv != 0):
        raise ValueError(f"flash_attention: k / v must be [BH / G, Tk, {d}]"
                         f" / [BH / G, Tk, dv] with G dividing BH = {bh}, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} must be >= 1")
    if not 1 <= dv <= d:
        raise ValueError(f"flash_attention: v's head dim {dv} must be in "
                         f"[1, d = {d}]")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_attention out_dtype: expected float32 or "
                        f"bfloat16, got {out_dtype}")
    window = int(window)
    if window < 0 or (window and (not causal or tq > tk)):
        raise ValueError(f"flash_attention: a window ({window}) must be >= "
                         f"0 and, when set, needs causal and Tq <= Tk "
                         f"(causal={causal}, Tq={tq}, Tk={tk})")
    route = _route(q, k, v)
    if route == "cpu":
        return ref.flash_attention_plain(q, k, v, causal, window,
                                         out_dtype=out_dtype)
    if route == "meta":
        out = q.new_empty((bh, tq, dv), dtype=out_dtype)
        return _meta("flash_attention", out,
                     2.0 * (d + dv) * bh * flash_pairs(tq, tk, causal,
                                                       window),
                     q.element_size() * (d * (bh * tq + bkv * tk)
                                         + dv * bkv * tk)
                     + out.element_size() * dv * bh * tq)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _FLASH_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention {name}: expected float32 or "
                            f"bfloat16 like q ({q.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention {name}: must be contiguous "
                             f"(stride {t.stride()})")
    if tq < 1 or tk < 1:
        raise ValueError(f"flash_attention: empty sequence (Tq={tq}, "
                         f"Tk={tk})")
    out = q.new_empty((bh, tq, dv), dtype=out_dtype)
    rc = entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _FLASH_DTYPES[q.dtype], _FLASH_DTYPES[out_dtype], bh, tq, tk, d, dv,
        int(bool(causal)), window,
        bh // bkv, d ** -0.5, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _launched("flash_attention")
    return out
