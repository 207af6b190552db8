"""Wrappers around the hand-written CUDA kernels.

``gemm(x, w, acc, out_dtype)`` returns ``acc + x @ w``, ``spdmm(cols, vals,
h, acc, row_len)`` returns ``acc + ELL(cols, vals) @ h`` and ``sddmm(h_dst,
h_src, cols, mask, acc)`` returns ``acc + where(mask, <h_dst[r],
h_src[cols[r, k]]>, 0)``, all summed in fp32 (``acc``, ``row_len`` and
``mask`` may be None); GEMM's x / w and SpDMM's h may also be bf16, as the
Pallas kernels take them, and GEMM's output bf16 (its ``out_dtype``);
``densify(cols, vals, n_src)`` returns the dense [n1, n_src] block of an
ELL tile (duplicate columns summed in slot order), the GEMM kernel's
operand for a sparsity-remapped aggregate step;
``flash_attention(q, k, v, causal, window)`` returns ``softmax(q k^T
d^-1/2 [+ causal / sliding-window mask]) v`` per head of [BH, T, d]
tensors in fp32 or bf16, d <= 256, with k / v of [BH / G, T, d] for
grouped KV heads.  Tensors on a CUDA device
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

``LAUNCHES`` counts kernel launches per kernel (plain integers, bumped
only where a kernel is launched, under a lock since overlays launch from
their own threads), so a run can show that it went through the kernels.
A wrapper called while its thread captures a CUDA graph
(:func:`capturing`) launches nothing: the kernel is recorded into the
graph and counted in the capture's own dict, not in ``LAUNCHES``.
``REPLAYED`` counts the kernels CUDA-graph replays launch, never a
wrapper: each replay adds its graph's captured counts
(:func:`note_replay`).  ``LAUNCHES`` plus ``REPLAYED`` is every kernel
the card ran (:func:`launch_totals`); ``reset_launches`` zeroes both.
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
_tls = threading.local()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            REPLAYED[k] = 0


def _launched(name: str) -> None:
    captured = getattr(_tls, "captured", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


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
            REPLAYED[k] += n


def launch_totals() -> Dict[str, int]:
    """``LAUNCHES`` plus ``REPLAYED``: every launch the card ran."""
    with _launch_lock:
        return {k: LAUNCHES[k] + REPLAYED[k] for k in LAUNCHES}


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


def gemm(x: torch.Tensor, w: torch.Tensor,
         acc: Optional[torch.Tensor] = None,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``acc + x @ w`` summed in fp32 and returned in ``out_dtype`` (fp32,
    the Pallas kernel's default, or bf16); x and w both fp32 or both bf16,
    ``acc`` fp32.  fp32 in and out is the tiled kernel, any other pair
    its mixed-precision body (``csrc/gemm.cu``)."""
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
          row_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + ELL(cols, vals) @ h`` for one [n1, w] ELL tile (fp32 sums
    and output; h fp32 or bf16, widened as it is gathered).
    ``row_len`` (int32 [n1], optional) is each row's live length, 1 + its
    last live slot (0 for a row with no edge): slots from row_len[r] on
    are not walked, which leaves the result unchanged when they are pads
    (vals == 0).  None walks all w slots."""
    route = _route(cols, vals, h, acc, row_len)
    if route == "cpu":
        y = ref.spdmm_ref(cols, vals, h, row_len=row_len)
        return y if acc is None else acc + y
    n1, w = cols.shape
    if route == "meta":
        # Every slot counts: a meta tile has no live lengths to skip by.
        f = h.shape[1]
        out = torch.empty((n1, f), dtype=torch.float32, device="meta")
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
    out = torch.empty((n1, f), dtype=torch.float32, device=h.device)
    rc = entry("spdmm" if h.dtype == torch.float32 else "spdmm_bf16")(
        cols.data_ptr(), vals.data_ptr(), h.data_ptr(),
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        row_len.data_ptr() if row_len is not None else None,
        n1, w, f, _ld(h), _ld(acc) if acc is not None else 0, _ld(out),
        _stream(h))
    if rc != 0:
        raise RuntimeError(f"spdmm kernel launch failed: CUDA error {rc}")
    _launched("spdmm")
    return out


def sddmm(h_dst: torch.Tensor, h_src: torch.Tensor, cols: torch.Tensor,
          mask: Optional[torch.Tensor] = None,
          acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + where(mask, SDDMM(h_dst, h_src, cols), 0)`` for one [n1, w]
    ELL tile (fp32); ``mask`` None scores every slot (pad slots score row
    0, as the Pallas kernel does), ``acc`` None is a zero accumulator.
    ``cols`` index rows of ``h_src``; see the module docstring for a column
    out of range."""
    route = _route(h_dst, h_src, cols, mask, acc)
    if route == "meta":
        n1, w = cols.shape
        out = torch.empty((n1, w), dtype=torch.float32, device="meta")
        return _meta("sddmm", out, 2.0 * n1 * w * h_dst.shape[1],
                     _nbytes(h_dst, h_src, cols, mask, acc, out))
    if route == "cpu":
        if cols.numel() and (int(cols.min()) < 0
                             or int(cols.max()) >= h_src.shape[0]):
            raise ValueError(f"sddmm cols: indices outside [0, "
                             f"{h_src.shape[0]})")
        return ref.sddmm_step_ref(h_dst, h_src, cols, mask, acc)
    n1, w = cols.shape
    _check_matrix("sddmm cols", cols, torch.int32)
    _check_matrix("sddmm h_dst", h_dst, torch.float32)
    f = h_dst.shape[1]
    if h_dst.shape[0] != n1:
        raise ValueError(f"sddmm h_dst: expected {n1} rows, got "
                         f"{h_dst.shape[0]}")
    _check_matrix("sddmm h_src", h_src, torch.float32)
    if h_src.shape[1] != f or h_src.shape[0] < 1:
        raise ValueError(f"sddmm h_src: expected [n_src >= 1, {f}], got "
                         f"{tuple(h_src.shape)}")
    if mask is not None:
        _check_matrix("sddmm mask", mask, torch.bool, (n1, w))
    if acc is not None:
        _check_matrix("sddmm acc", acc, torch.float32, (n1, w))
    if not all(t is None or t.is_contiguous() for t in (cols, mask, acc)):
        raise ValueError("sddmm: cols, mask and acc must be contiguous")
    out = torch.empty((n1, w), dtype=torch.float32, device=cols.device)
    rc = entry("sddmm")(
        h_dst.data_ptr(), h_src.data_ptr(), cols.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        acc.data_ptr() if acc is not None else None, out.data_ptr(),
        n1, w, f, h_src.shape[0], _ld(h_dst), _ld(h_src), _stream(cols))
    if rc != 0:
        raise RuntimeError(f"sddmm kernel launch failed: CUDA error {rc}")
    _launched("sddmm")
    return out


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLASH_MAX_D = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``softmax(q k^T d^-1/2 [+ mask]) v`` for q [BH, Tq, d] and k / v
    [BH / G, Tk, d], all fp32 or all bf16, contiguous, d <= 256; returns
    [BH, Tq, d] in q's dtype (fp32 math inside).  The causal mask is the
    Pallas kernel's ``qpos >= kpos``, both counted from 0; ``window`` W > 0
    (causal only, Tq <= Tk) also masks ``qpos - kpos >= W``, JAX's
    ``_mask_bias`` (0 is no window).  With G > 1 (G must divide BH) the
    query heads of a group are adjacent: query head ``bh`` reads KV head
    ``bh // G``; G = 1 is one KV head per query head."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention {name}: expected [BH, T, d], "
                             f"got shape {tuple(t.shape)}")
    bh, tq, d = q.shape
    bkv, tk = k.shape[0], k.shape[1]
    if (k.shape[2] != d or v.shape != k.shape or bkv < 1
            or bh % bkv != 0):
        raise ValueError(f"flash_attention: k / v must be [BH / G, Tk, {d}]"
                         f" with G dividing BH = {bh}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if not 1 <= d <= FLASH_MAX_D:
        raise ValueError(f"flash_attention: head dim {d} outside [1, "
                         f"{FLASH_MAX_D}]")
    window = int(window)
    if window < 0 or (window and (not causal or tq > tk)):
        raise ValueError(f"flash_attention: a window ({window}) must be >= "
                         f"0 and, when set, needs causal and Tq <= Tk "
                         f"(causal={causal}, Tq={tq}, Tk={tk})")
    route = _route(q, k, v)
    if route == "cpu":
        return ref.flash_attention_plain(q, k, v, causal, window)
    if route == "meta":
        out = torch.empty_like(q)
        return _meta("flash_attention", out,
                     4.0 * d * bh * flash_pairs(tq, tk, causal, window),
                     q.element_size() * d * (2 * bh * tq + 2 * bkv * tk))
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
    out = torch.empty_like(q)
    rc = entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _FLASH_DTYPES[q.dtype], bh, tq, tk, d, int(bool(causal)), window,
        bh // bkv, d ** -0.5, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _launched("flash_attention")
    return out
