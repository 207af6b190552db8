"""Binary-driven overlay executor on torch (paper Alg. 9, ISA v3 runtime).

It consumes only the decoded 128-bit instruction stream, the program
manifest and the DDR payload (weights + fiber-shard ELL tiles), exactly as
``repro/engine/executor.py`` does, so a ``CompiledProgram`` loaded from a
``.gagi`` file (written by either package) executes identically to one
compiled in-process.

This port covers the **device-resident** path: every padded layer output
lives on the executor's device and tiles are issued in PE-interleaved
order straight off the resident tensors.  On a CUDA device the ACK runs
the hand-written GEMM, SpDMM and SDDMM kernels; on the CPU it runs plain
torch.  Host streaming (``residency="host"``, ROADMAP A7), multi-device
meshes (A13) and graph-as-data (A11) are not ported yet and raise
``NotImplementedError``.

Batches: :meth:`BinaryExecutor.run_batch` executes N feature sets over one
program in ONE traversal of the decoded binary.  Layer outputs carry a
leading lane axis (``[N, vp, w]``; edge vectors ``[N, E]``) and every tile
op is issued once per lane on that lane's views, so a lane computes
exactly what a single run computes (bit for bit) while the decode, the
plan walk and the per-tile index work are shared.  ``run`` is
``run_batch`` of one lane.  Per-run ``stats`` count one traversal (its
tile ops), kernel launches are lanes x tile ops.

Device-resident data:

* The baked ELL tiles are uploaded ONCE per partitioned graph and device
  (:class:`_Staged`, cached on ``prog.pgraph``, the object the engine's
  cached program and the handles it returns share): ``cols`` and ``vals``
  for every aggregation, ``mask`` and the live slots (``live_pos`` /
  ``live_epos``: each tile's flat positions of real edges and their edge
  ids) only for the layers that read them (MAX/MIN, dynamic edge weights,
  edge-valued layers).  The padded weights and the inverse in-degree are
  uploaded once as well.
* Edge vectors move between tiles and the [E] edge order through the
  live slots only: scattering a tile's scores, gathering a tile's edge
  weights and the edge softmax touch the real edges, not the pad slots
  (over 99% of the slots on a power-law graph), with the same result.
* Tiles are strided views of the padded layer tensors; the kernels take
  row strides, so no tile is copied on its way in.
* Every launch goes to the caller's current CUDA stream, and a run ends
  by synchronizing that stream only, so two engines on one card (each on
  its own stream) do not wait for each other.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ack import ACK
from repro_torch.core.ir import Activation, AggOp, LayerType
from repro_torch.core.isa import Opcode
from repro_torch.core.reference import apply_activation
from repro_torch.obs.tracer import get_tracer

from .decoder import LayerPlan, TilePlan
from .program import CompiledProgram

# Kernel mode a layer family's tiles execute in (paper §5: the overlay's
# GEMM / SpDMM / SDDMM / vector / activation compute modes).
_KERNEL_MODES = {
    LayerType.AGGREGATE: "spdmm",
    LayerType.LINEAR: "gemm",
    LayerType.VECTOR_INNER: "sddmm",
    LayerType.VECTOR_ADD: "vadd",
    LayerType.ACTIVATION: "act",
    LayerType.BATCHNORM: "act",
}

_BIG = 3.4e38


def _row_tiles(pg, j: int) -> List[Tuple[int, int]]:
    """The (k, slice) tiles of destination row block ``j``."""
    return [(k, s) for (jj, k), ts in sorted(pg.tiles.items())
            if jj == j for s in range(len(ts))]


class ResidentBudgetError(RuntimeError):
    """Raised when a device-resident run's liveness-aware peak exceeds
    ``resident_budget_bytes`` (named with the first layer step that does)."""


@dataclasses.dataclass
class ExecStats:
    tile_ops: int = 0
    layers: int = 0
    runs: int = 0
    tile_ops_by_mode: Optional[Dict[str, int]] = None
    # Liveness telemetry (peaks are high-water marks).
    peak_live_outputs: int = 0      # layer outputs alive at once
    peak_live_bytes: int = 0        # bytes of those outputs
    h2d_bytes: int = 0              # tile / weight bytes uploaded this run
    # Per-decoded-layer attribution: {"layer","kernel","step","instr_lo",
    # "instr_hi","wall_s","tile_ops"}.  On a CUDA device ``wall_s`` is the
    # device time between two CUDA events around the layer, read after the
    # run's one final synchronize; on the CPU it is host wall time.
    per_layer: Optional[List[dict]] = None

    # record keys that identify a layer rather than accumulate
    _LAYER_IDENTITY = ("layer", "kernel", "step", "type",
                      "instr_lo", "instr_hi")

    def note_layer(self, **rec) -> None:
        if self.per_layer is None:
            self.per_layer = []
        self.per_layer.append(rec)

    def note_mode(self, mode: str, n: int = 1) -> None:
        if self.tile_ops_by_mode is None:
            self.tile_ops_by_mode = {}
        self.tile_ops_by_mode[mode] = \
            self.tile_ops_by_mode.get(mode, 0) + n

    def add(self, other: "ExecStats") -> None:
        self.tile_ops += other.tile_ops
        self.layers += other.layers
        self.runs += other.runs
        self.h2d_bytes += other.h2d_bytes
        if other.tile_ops_by_mode is not None:
            for m, n in other.tile_ops_by_mode.items():
                self.note_mode(m, n)
        if other.per_layer is not None:
            # MERGE per-layer attribution (keyed by decoded layer id +
            # kernel mode) so lifetime totals accumulate per layer.
            if self.per_layer is None:
                self.per_layer = [dict(r) for r in other.per_layer]
            else:
                by_key = {(r.get("layer"), r.get("kernel")): r
                          for r in self.per_layer}
                for orr in other.per_layer:
                    mine = by_key.get((orr.get("layer"),
                                       orr.get("kernel")))
                    if mine is None:
                        self.per_layer.append(dict(orr))
                        continue
                    for k, v in orr.items():
                        if k in self._LAYER_IDENTITY:
                            mine[k] = v
                        else:
                            mine[k] = mine.get(k, 0) + v
                self.per_layer.sort(key=lambda r: r.get("step", 0))
        self.peak_live_outputs = max(self.peak_live_outputs,
                                     other.peak_live_outputs)
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)


def _nbytes(a) -> int:
    """Bytes of a numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.size) * a.dtype.itemsize


def _layer_out_bytes(lp: LayerPlan, pg) -> int:
    """Bytes of the padded output a layer keeps alive (liveness units)."""
    n1, n2 = pg.config.n1, pg.config.n2
    if lp.layer_type == LayerType.VECTOR_INNER or lp.on_edges:
        return (pg.n_edges + 1) * 4
    f = lp.f_out if lp.layer_type == LayerType.LINEAR else lp.f_in
    fp = ((max(f, 1) + n2 - 1) // n2) * n2
    return pg.n_blocks * n1 * fp * 4


def derive_residency(plan, lmeta: dict) -> dict:
    """Rebuild the residency schedule (liveness + shard order) from the
    decoded binary alone — the fallback for ``.gagi`` bundles written
    before manifests carried a ``residency`` section."""
    from repro_torch.core.passes.schedule import _order_shards
    last_use: Dict[int, int] = {}
    layers: Dict[str, dict] = {}
    for t, lp in enumerate(plan.layers):
        meta = lmeta[str(lp.layer_id)]
        ewl = meta.get("edge_weight_layer")
        feat_parents = [p for p in meta["parents"] if p != ewl]
        if lp.layer_type == LayerType.VECTOR_ADD:
            consumed = [int(o) for o in meta["operands"]]
        else:
            consumed = [int(feat_parents[0]) if feat_parents else -1]
        if ewl is not None:
            consumed.append(int(ewl))
        for c in consumed:
            last_use[c] = t
        sources: Dict[int, set] = {}
        for tp in lp.tiles:
            j = tp.out_j
            if j < 0:
                continue
            e = sources.setdefault(j, set())
            if lp.layer_type == LayerType.AGGREGATE:
                e.update(ins.args[1] for ins in tp.compute)
            elif lp.layer_type == LayerType.VECTOR_INNER:
                e.add(j)
                e.add(tp.tile_k)
            elif not lp.on_edges:
                e.add(j)
        layers[str(lp.layer_id)] = {
            "shard_order": [int(j) for j in _order_shards(sources)],
            "sources": {str(j): sorted(int(k) for k in ks)
                        for j, ks in sources.items()},
        }
    if plan.layers:
        last_use[plan.layers[-1].layer_id] = len(plan.layers)
    return {"last_use": {str(k): int(v)
                         for k, v in sorted(last_use.items())},
            "layers": layers}


def resolve_residency(prog: CompiledProgram) -> dict:
    """Manifest residency section, derived from the binary for
    pre-residency ``.gagi`` bundles (cached on the program)."""
    res = prog.manifest.get("residency")
    if res is None:
        res = prog.__dict__.get("_derived_residency")
        if res is None:
            res = derive_residency(prog.plan(), prog.manifest["layers"])
            prog.__dict__["_derived_residency"] = res
    return res


# --------------------------------------------------------------------------- #
# Device copies of a program's payload, made once per device.
# --------------------------------------------------------------------------- #
class _Staged:
    """The ELL tiles, inverse in-degree and padded weights of one
    partitioned graph on one device.  Tile kinds are uploaded on first
    use, all tiles of a kind at once; weights are keyed by manifest name
    and re-uploaded only when the caller passes a different array."""

    def __init__(self, pg, device: torch.device) -> None:
        self.pg, self.device = pg, device
        self.uploaded = 0               # bytes copied to the device so far
        self._tiles: Dict[str, Dict[Tuple[int, int, int], torch.Tensor]] = {}
        self._params: Dict[Tuple, Tuple[Any, torch.Tensor]] = {}
        # Overlays run in their own threads; two that share a program
        # must not upload (or replace) the same entry twice.
        self._lock = threading.RLock()
        self.inv_deg = self._put(np.asarray(pg.inv_in_degree, np.float32))

    def _put(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            t = a.to(self.device)
        else:
            t = torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
        self.uploaded += _nbytes(t)
        return t

    def tiles(self, kind: str) -> Dict[Tuple[int, int, int], torch.Tensor]:
        """``kind`` in cols (int32) / vals (f32) / mask (bool) / row_len
        (int32 [n1], 1 + each row's last live slot) / live_pos (int64
        flat positions of the edge slots) / live_epos (int64 edge ids of
        those slots), keyed (j, k, slice)."""
        got = self._tiles.get(kind)     # uploaded: no lock on the hot path
        if got is not None:
            return got
        with self._lock:
            got = self._tiles.get(kind)
            if got is None:
                got = self._tiles[kind] = self._upload(kind)
            return got

    def _upload(self, kind: str) -> Dict[Tuple[int, int, int], torch.Tensor]:
        got = {}
        n1 = self.pg.config.n1
        for (j, k), ts in self.pg.tiles.items():
            for s, t in enumerate(ts):
                arr = _tile_array(t, kind)
                # The SpDMM and SDDMM kernels gather h rows at these
                # indices unchecked; a malformed bundle must not reach them.
                if kind == "cols" and arr.size and (
                        arr.min() < 0 or arr.max() >= n1):
                    raise ValueError(
                        f"ELL tile ({j}, {k}, {s}) has column indices "
                        f"outside [0, {n1})")
                got[(j, k, s)] = self._put(arr)
        return got

    def param(self, key: Tuple, srcs: Tuple, build) -> torch.Tensor:
        """Device tensor ``build()`` memoized under ``key`` for as long as
        the source arrays ``srcs`` are the same objects."""
        with self._lock:
            hit = self._params.get(key)
            if hit is not None and len(hit[0]) == len(srcs) and all(
                    a is b for a, b in zip(hit[0], srcs)):
                return hit[1]
            t = self._put(build())
            self._params[key] = (srcs, t)
            return t


def _tile_array(t, kind: str) -> np.ndarray:
    if kind == "cols":
        return t.cols
    if kind == "vals":
        return t.vals
    if kind == "mask":
        return t.edge_pos >= 0
    if kind == "row_len":
        return _row_len(t.edge_pos)
    if kind == "live_pos":
        return np.flatnonzero(t.edge_pos >= 0).astype(np.int64)
    if kind == "live_epos":
        ep = t.edge_pos.reshape(-1)
        return ep[ep >= 0].astype(np.int64)
    raise ValueError(kind)


def _row_len(edge_pos: np.ndarray) -> np.ndarray:
    """int32 [n1]: 1 + the last live slot of each row (0 for a row with no
    edge).  A last-live index, not a count, so pads between live slots
    stay inside it (they carry vals == 0)."""
    live = np.asarray(edge_pos) >= 0
    last = live.shape[1] - 1 - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last + 1, 0).astype(np.int32)


_staged_lock = threading.Lock()


def _staged(pg, device: torch.device) -> _Staged:
    with _staged_lock:
        cache = pg.__dict__.setdefault("_staged", {})
        st = cache.get(str(device))
        if st is None:
            st = cache[str(device)] = _Staged(pg, device)
        return st


def _padded(a, rows: int, cols: Optional[int] = None) -> np.ndarray:
    """``a`` as f32, zero-padded to ``rows`` (x ``cols``)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    if cols is None:
        out = np.zeros((max(rows, a.shape[0]),), np.float32)
        out[: a.shape[0]] = a
    else:
        out = np.zeros((rows, cols), np.float32)
        out[: a.shape[0], : a.shape[1]] = a
    return out


# --------------------------------------------------------------------------- #
# Operand environment — where a tile's operands come from (device path).
# --------------------------------------------------------------------------- #
class _DeviceEnv:
    """Whole lane-stacked padded tensors ([N, vp, w]; edge vectors [N, E])
    live on the device; a tile is a view of one lane's tensor or of a
    staged ELL tile."""

    def __init__(self, pg, st: _Staged, lanes: int, h=None, a=None, b=None,
                 ew=None) -> None:
        self.pg, self.st, self.lanes = pg, st, lanes
        self.n1, self.n2 = pg.config.n1, pg.config.n2
        # Per-lane [vp, w] views, taken once: slicing a 2-D view per tile
        # costs the host less than indexing the 3-D tensor each time.
        self.h, self.a, self.b = (None if t is None else list(t.unbind(0))
                                  for t in (h, a, b))
        self.ew = ew
        # Tile views of h, made once per layer: an aggregate step reads
        # the same few source tiles hundreds of times, and a view costs
        # the host more than a dict lookup.
        self._h_tiles: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def h_tile(self, n: int, k: int, i: int) -> torch.Tensor:
        t = self._h_tiles.get((n, k, i))
        if t is None:
            n1, n2 = self.n1, self.n2
            t = self._h_tiles[(n, k, i)] = \
                self.h[n][k * n1:(k + 1) * n1, i * n2:(i + 1) * n2]
        return t

    def operand_tile(self, which: str, n: int, j: int,
                     i: int) -> torch.Tensor:
        arr = self.a if which == "a" else self.b
        n1, n2 = self.n1, self.n2
        return arr[n][j * n1:(j + 1) * n1, i * n2:(i + 1) * n2]

    def tile(self, kind: str, j: int, k: int, s: int) -> torch.Tensor:
        return self.st.tiles(kind)[(j, k, s)]

    def live(self, j: int, k: int, s: int):
        """(flat slot positions, edge ids) of a tile's real edges."""
        return (self.tile("live_pos", j, k, s),
                self.tile("live_epos", j, k, s))

    def edge_weight_tiles(self, j: int, k: int, s: int) -> List[torch.Tensor]:
        """Every lane's [n1, w] edge-weight tile (0 on pad slots)."""
        shape = self.tile("cols", j, k, s).shape
        return [_from_live(self.ew[n], *self.live(j, k, s), shape)
                for n in range(self.lanes)]

    def inv_deg_tile(self, j: int) -> torch.Tensor:
        return self.st.inv_deg[j * self.n1:(j + 1) * self.n1]


def _from_live(ew: torch.Tensor, pos: torch.Tensor, epos: torch.Tensor,
               shape) -> torch.Tensor:
    """A [n1, w] tile holding ``ew[epos]`` at its live slots ``pos`` and
    0 on the pad slots."""
    out = torch.zeros(shape[0] * shape[1], dtype=torch.float32,
                      device=ew.device)
    out[pos] = ew[epos]
    return out.view(shape)


def _ends_in_edge_softmax(epilogue) -> bool:
    return bool(epilogue) and epilogue[-1][0] == "act" and \
        Activation(epilogue[-1][1]) == Activation.EDGE_SOFTMAX


# --------------------------------------------------------------------------- #
# Shard kernels — one tile computation per layer family.  ``tile`` returns
# the tile of every lane; each compute instruction is one tile op, issued
# once per lane and counted once.
# --------------------------------------------------------------------------- #
class _ShardKernel:
    edge_valued = False

    def __init__(self, ex, lp: LayerPlan, meta: dict, pg, weights,
                 st: _Staged) -> None:
        self.ex, self.lp, self.meta, self.pg = ex, lp, meta, pg
        self.weights, self.st = weights, st
        self.n1, self.n2 = pg.config.n1, pg.config.n2

    def _fp(self, f: int) -> int:
        return ((max(f, 1) + self.n2 - 1) // self.n2) * self.n2

    def out_width(self, io: dict) -> int:
        return self._fp(self.lp.f_in)

    def _op(self, mode: str) -> None:
        self.ex.stats.tile_ops += 1
        self.ex.stats.note_mode(mode)

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32,
                           device=self.st.device)

    def _finish(self, tp: TilePlan, tiles: List[torch.Tensor],
                lo: int, hi: int, epilogue=None) -> List[torch.Tensor]:
        epi = tp.epilogue if epilogue is None else epilogue
        return [self.ex._epilogue(epi, self.meta, v, self.weights, self.st,
                                  lo, hi) for v in tiles]

    def tile(self, tp: TilePlan, env: _DeviceEnv) -> List[torch.Tensor]:
        raise NotImplementedError


class _AggregateKernel(_ShardKernel):
    """SpDMM-mode aggregation (paper Alg. 6): accumulate source
    sub-fibers through a destination shard's ELL tiles."""

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        self.op = {AggOp.SUM: "sum", AggOp.MEAN: "mean",
                   AggOp.MAX: "max", AggOp.MIN: "min"}[AggOp(lp.mode)]
        self.extreme = self.op in ("max", "min")

    def tile(self, tp, env):
        j, i, n1, n2 = tp.out_j, tp.out_i, self.n1, self.n2
        lanes = range(env.lanes)
        dev = self.st.device
        accs = [None] * env.lanes       # None: a zero SUM/MEAN accumulator
        flags = [None] * env.lanes
        if self.extreme:
            accs = [torch.full((n1, n2), -_BIG if self.op == "max" else _BIG,
                               dtype=torch.float32, device=dev)
                    for _ in lanes]
            flags = [torch.zeros((n1,), dtype=torch.bool, device=dev)
                     for _ in lanes]
        for ins in tp.compute:           # SPDMM steps, stream order
            if ins.op == Opcode.GEMM:
                raise NotImplementedError(
                    "this binary was sparsity-remapped (a GEMM step inside "
                    "an AGGREGATE layer); remap execution is not ported "
                    "yet (ROADMAP A8)")
            k, ii = ins.args[1], ins.args[2]
            s, dyn = ins.args[3] >> 1, ins.args[3] & 1
            cols = env.tile("cols", j, k, s)
            vals = (env.edge_weight_tiles(j, k, s) if dyn
                    else [env.tile("vals", j, k, s)] * env.lanes)
            mask = env.tile("mask", j, k, s) if self.extreme else None
            # Dynamic edge-weight tiles are 0 on pad slots too, so the
            # structural live length serves both.
            row_len = (None if self.extreme
                       else env.tile("row_len", j, k, s))
            for n in lanes:
                accs[n], flags[n] = self.ex.ack.spdmm(
                    env.h_tile(n, k, ii), cols, vals[n], mask, accs[n],
                    flags[n], self.op, row_len)
            self._op("spdmm")
        outs = []
        for acc, flag in zip(accs, flags):
            if acc is None:
                acc = self._zeros((n1, n2))
            if self.extreme:
                acc = torch.where(flag[:, None], acc, torch.zeros_like(acc))
            elif self.op == "mean":
                acc = acc * env.inv_deg_tile(j)[:, None]
            outs.append(acc)
        return self._finish(tp, outs, i * n2, (i + 1) * n2)


class _LinearKernel(_ShardKernel):
    """GEMM-mode dense layer: reduce over input fibers of the own row
    block against weight blocks."""

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        fi_pad, fo_pad = self._fp(lp.f_in), self._fp(lp.f_out)
        w0 = weights[meta["W"]]
        self.W = st.param(("W", meta["W"], fi_pad, fo_pad), (w0,),
                          lambda: _padded(w0, fi_pad, fo_pad))
        self.b = None
        if "b" in meta:
            b0 = weights[meta["b"]]
            self.b = st.param(("b", meta["b"], fo_pad), (b0,),
                              lambda: _padded(b0, fo_pad))

    def out_width(self, io):
        return self._fp(self.lp.f_out)

    def tile(self, tp, env):
        i, j, n1, n2 = tp.out_i, tp.out_j, self.n1, self.n2
        accs = [None] * env.lanes        # None: a zero accumulator
        for ins in tp.compute:           # GEMM steps: args=(j, k, i)
            k = ins.args[1]
            w_tile = self.W[k * n2:(k + 1) * n2, i * n2:(i + 1) * n2]
            for n in range(env.lanes):
                accs[n] = self.ex.ack.gemm(env.h_tile(n, j, k), w_tile,
                                           accs[n])
            self._op("gemm")
        outs = []
        for acc in accs:
            if acc is None:
                acc = self._zeros((n1, n2))
            if self.b is not None:
                acc = acc + self.b[i * n2:(i + 1) * n2]
            outs.append(acc)
        return self._finish(tp, outs, i * n2, (i + 1) * n2)


class _VAddKernel(_ShardKernel):
    """Vector-addition mode: elementwise alpha*a + beta*b per tile."""

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        self.alpha, self.beta = meta["alpha"], meta["beta"]

    def out_width(self, io):
        return max(io["a"].shape[2], io["b"].shape[2])

    def tile(self, tp, env):
        i, j, n2 = tp.out_i, tp.out_j, self.n2
        outs = [self.ex.ack.vadd(env.operand_tile("a", n, j, i),
                                 env.operand_tile("b", n, j, i),
                                 self.alpha, self.beta)
                for n in range(env.lanes)]
        self._op("vadd")
        return self._finish(tp, outs, i * n2, (i + 1) * n2)


class _VertexActKernel(_ShardKernel):
    """Standalone vertex activation / batch-norm (Activation Unit)."""

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        self.bn = lp.layer_type == LayerType.BATCHNORM
        if self.bn:
            srcs = tuple(weights[meta[k]]
                         for k in ("mu", "sigma", "gamma", "beta"))
            eps = float(meta.get("eps", 1e-5))
            fi_pad = self._fp(lp.f_in)

            def fold(which):
                mu, sig, gam, bet = (
                    np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                               else a, np.float32) for a in srcs)
                sc = gam / np.sqrt(sig ** 2 + eps)
                return _padded(sc if which == "sc" else bet - mu * sc,
                               fi_pad)
            key = tuple(meta[k] for k in ("mu", "sigma", "gamma", "beta"))
            self.sc = st.param(("bn_sc", key, eps), srcs,
                               lambda: fold("sc"))
            self.sh = st.param(("bn_sh", key, eps), srcs,
                               lambda: fold("sh"))

    def tile(self, tp, env):
        i, j, n2 = tp.out_i, tp.out_j, self.n2
        op = tp.compute[0]               # the ACT / AFFINE instr
        outs = []
        for n in range(env.lanes):
            v = env.h_tile(n, j, i)
            if self.bn:
                v = self.ex.ack.affine(v, self.sc[i * n2:(i + 1) * n2],
                                       self.sh[i * n2:(i + 1) * n2])
            else:
                v = self.ex.ack.act(v, Activation(op.act))
            outs.append(v)
        self._op("act")
        return outs


class _EdgeScoreKernel(_ShardKernel):
    """SDDMM-mode edge scoring (paper Alg. 7): per-edge inner products
    (or pair-sums) between destination and source sub-fibers.

    A trailing EDGE_SOFTMAX in the fused epilogue normalizes over all of a
    destination's tiles, so it cannot run per tile: the rest of the
    epilogue runs here and the executor applies the softmax to the
    scattered edge vector (``softmax``)."""

    edge_valued = True

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        self.pair = lp.mode == 1     # CSI mode bit — the binary decides
        self.softmax = bool(lp.tiles) and _ends_in_edge_softmax(
            lp.tiles[0].epilogue)

    def tile(self, tp, env):
        j, k, s = tp.out_j, tp.tile_k, tp.slice_id
        cols = env.tile("cols", j, k, s)
        mask = env.tile("mask", j, k, s)
        accs = [None] * env.lanes        # None: a zero accumulator
        for ins in tp.compute:           # SDDMM steps: args=(j, k, i, s)
            i = ins.args[2]
            for n in range(env.lanes):
                accs[n] = self.ex.ack.sddmm(env.h_tile(n, j, i),
                                            env.h_tile(n, k, i), cols, mask,
                                            accs[n], pair_sum=self.pair)
            self._op("sddmm")
        outs = [self._zeros(cols.shape) if a is None else a for a in accs]
        epi = tp.epilogue[:-1] if self.softmax else tp.epilogue
        return self._finish(tp, outs, 0, self.n2, epi)


class _LayerClock:
    """Per-layer timing: CUDA events on a CUDA device (read after the
    run's final synchronize, no sync per layer), host wall time else."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, t0):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return (t0, ev)
        return time.perf_counter() - t0

    @staticmethod
    def seconds(v) -> float:
        if isinstance(v, tuple):
            return v[0].elapsed_time(v[1]) / 1e3
        return v


class BinaryExecutor:
    """Executes a CompiledProgram by interpreting its decoded binary on
    one torch device.

    ``stats`` holds the counters of the most recent :meth:`run` /
    :meth:`run_batch` pass only (reset at entry); ``total`` accumulates
    across the executor's lifetime.
    """

    def __init__(self, device="cuda", backend: Optional[str] = None,
                 resident_budget_bytes: Optional[int] = None) -> None:
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        on_cuda = self.device.type == "cuda"
        backend = backend or ("cuda" if on_cuda else "torch")
        if on_cuda and backend != "cuda":
            raise ValueError(
                f"backend {backend!r} cannot run on {self.device}: a CUDA "
                "device always runs the hand kernels (backend 'cuda')")
        self.ack = ACK(backend=backend)
        self.resident_budget_bytes = resident_budget_bytes
        # Optional observer called as hook(event, layer_id, live_count)
        # with event in {"alloc", "free"} whenever a layer output is
        # materialized or released (tests count liveness through this).
        self.liveness_hook = None
        self.stats = ExecStats()        # per-run (last run)
        self.total = ExecStats()        # lifetime accumulation

    def _make_kernel(self, lp: LayerPlan, meta: dict, pg, weights,
                     st: _Staged) -> _ShardKernel:
        kind = {
            LayerType.AGGREGATE: _AggregateKernel,
            LayerType.LINEAR: _LinearKernel,
            LayerType.VECTOR_INNER: _EdgeScoreKernel,
            LayerType.VECTOR_ADD: _VAddKernel,
            LayerType.ACTIVATION: _VertexActKernel,
            LayerType.BATCHNORM: _VertexActKernel,
        }.get(lp.layer_type)
        if kind is None:
            raise ValueError(lp.layer_type)
        return kind(self, lp, meta, pg, weights, st)

    # ------------------------------------------------------------------ #
    def _live_profile(self, prog: CompiledProgram,
                      x_cols: Optional[int] = None):
        """(static bytes, input-feature bytes, per-step live-output
        bytes) of a device-resident pass — the liveness-aware memory
        profile both the peak estimate and the budget gate read."""
        plan = prog.plan()
        pg = prog.pgraph
        n1, n2 = pg.config.n1, pg.config.n2
        vp = pg.n_blocks * n1
        last_use = {int(k): v for k, v in
                    resolve_residency(prog)["last_use"].items()}
        static = (pg.tile_bytes()
                  + sum(_nbytes(np.asarray(w))
                        for w in prog.weights.values())
                  + _nbytes(np.asarray(pg.inv_in_degree)))
        if not plan.layers:
            return static, 0, []
        fin_pad0 = ((max(plan.layers[0].f_in, 1) + n2 - 1) // n2) * n2
        xw = fin_pad0 if x_cols is None else max(
            fin_pad0, ((x_cols + n2 - 1) // n2) * n2)
        x_bytes = vp * xw * 4   # kept for the whole pass in device mode
        sizes = {lp.layer_id: _layer_out_bytes(lp, pg)
                 for lp in plan.layers}
        births = {lp.layer_id: t for t, lp in enumerate(plan.layers)}
        n = len(plan.layers)
        live = [sum(sz for lid, sz in sizes.items()
                    if births[lid] <= t <= max(last_use.get(lid, n),
                                               births[lid]))
                for t in range(n)]
        return static, x_bytes, live

    def estimate_device_peak_bytes(self, prog: CompiledProgram,
                                   x_cols: Optional[int] = None,
                                   batch: int = 1) -> int:
        """Liveness-aware peak device bytes of a device-resident run:
        graph tiles + weights + the input feature matrix + the maximum
        over layer steps of the concurrently-live padded outputs.
        ``batch`` scales the per-lane parts (features + live outputs) for
        a ``run_batch`` pass; tiles and weights are shared by the lanes."""
        static, x_bytes, live = self._live_profile(prog, x_cols)
        return static + batch * (x_bytes + max(live)) if live else static

    def _gate_device_budget(self, prog: CompiledProgram,
                            x_cols: Optional[int], batch: int = 1) -> None:
        """Refuse a run whose liveness-aware peak exceeds
        ``resident_budget_bytes``, naming the first layer step whose live
        set pushes past it."""
        if self.resident_budget_bytes is None:
            return
        budget = self.resident_budget_bytes
        static, x_bytes, live = self._live_profile(prog, x_cols)
        est = (static + batch * (x_bytes + max(live))) if live else static
        if est <= budget:
            return
        detail = ""
        over = [t for t, lv in enumerate(live)
                if static + batch * (x_bytes + lv) > budget]
        if over:
            lp = prog.plan().layers[over[0]]
            detail = (f"; first exceeded at layer {lp.layer_id} "
                      f"({LayerType(lp.layer_type).name}, step "
                      f"{over[0] + 1}/{len(live)})")
        batch_note = f" for a batch of {batch}" if batch > 1 else ""
        raise ResidentBudgetError(
            f"device-resident execution needs ~{est} bytes "
            f"(liveness-aware peak{batch_note}) but "
            f"resident_budget_bytes={budget} ({est - budget} bytes over)"
            f"{detail}" + ("; shrink the batch" if batch > 1 else ""))

    # ------------------------------------------------------------------ #
    def _watermark(self, event: str, layer_id: int, vals: Dict,
                   edge_vals: Dict) -> None:
        live = len(vals) + len(edge_vals)
        if event == "alloc":
            self.stats.peak_live_outputs = max(
                self.stats.peak_live_outputs, live)
            self.stats.peak_live_bytes = max(
                self.stats.peak_live_bytes,
                sum(_nbytes(a) for d in (vals, edge_vals)
                    for a in d.values()))
        if self.liveness_hook is not None:
            self.liveness_hook(event, layer_id, live)

    def _free_dead(self, t: int, sink: int, last_use: Dict[int, int],
                   vals: Dict, edge_vals: Dict) -> None:
        """Release every value whose LAST consumer was step ``t`` —
        interval liveness from the manifest's residency table."""
        for d in (vals, edge_vals):
            for lid in [l for l in d
                        if l != sink and last_use.get(l, -1) == t]:
                del d[lid]
                self._watermark("free", lid, vals, edge_vals)

    # ------------------------------------------------------------------ #
    def run(self, prog: CompiledProgram, x,
            weights: Optional[Dict[str, Any]] = None,
            graph_data: Optional[dict] = None,
            residency: str = "device", mesh=None) -> torch.Tensor:
        """Execute ``prog`` on features ``x`` ([V, F], numpy or tensor);
        returns the sink layer's [V, f_out] output on the device.  It is
        :meth:`run_batch` of one lane."""
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() != 2:
            raise ValueError(f"run expects [V, F] features, got shape "
                             f"{tuple(x.shape)}")
        return self.run_batch(prog, x[None], weights=weights,
                              graph_data=graph_data, residency=residency,
                              mesh=mesh)[0]

    def run_batch(self, prog: CompiledProgram, xs,
                  weights: Optional[Dict[str, Any]] = None,
                  graph_data: Optional[dict] = None,
                  residency: str = "device", mesh=None) -> torch.Tensor:
        """Execute ONE binary pass for stacked ``[N, V, F]`` features;
        returns the sink's ``[N, V, f_out]`` output on the device.

        The binary is decoded and traversed once; each tile op is issued
        once per lane on that lane's views, so lane n is bit-identical to
        ``run(prog, xs[n])``.  Per-run ``stats`` count the one traversal.
        On a CUDA device the pass ends by synchronizing the current stream
        (which is when the per-layer CUDA-event times are read)."""
        if residency not in ("device", "host"):
            raise ValueError("residency must be 'device' or 'host', "
                             f"got {residency!r}")
        if residency == "host":
            raise NotImplementedError(
                "host-streaming residency is not ported yet (ROADMAP A7)")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device mesh execution is not ported yet "
                "(ROADMAP A13)")
        if graph_data is not None:
            raise NotImplementedError(
                "graph-as-data execution is not ported yet; it comes with "
                "the sampling layer (ROADMAP A11)")
        xs = torch.as_tensor(xs, dtype=torch.float32)
        if xs.dim() != 3:
            raise ValueError(
                "run_batch expects stacked [N, V, F] features, got shape "
                f"{tuple(xs.shape)}")
        lanes = int(xs.shape[0])
        self._gate_device_budget(prog, int(xs.shape[2]), batch=lanes)
        xs = xs.to(self.device)
        self.stats = ExecStats(runs=1)
        tracer = get_tracer()
        with tracer.span("decode", cat="exec", track="exec:device",
                         args={"cached": prog._plan is not None}):
            plan = prog.plan()
        man = prog.manifest
        pg = prog.pgraph
        st = _staged(pg, self.device)
        up0 = st.uploaded
        last_use = {int(k): v for k, v in
                    resolve_residency(prog)["last_use"].items()}
        weights = weights if weights is not None else prog.weights
        lmeta = man["layers"]
        n1, n2, nb = pg.config.n1, pg.config.n2, pg.n_blocks
        vp = nb * n1
        nv = pg.n_vertices
        clock = _LayerClock(self.device)

        fin_pad0 = ((max(plan.layers[0].f_in, 1) + n2 - 1) // n2) * n2
        xw = max(fin_pad0, ((xs.shape[2] + n2 - 1) // n2) * n2)
        x_pad = torch.zeros((lanes, vp, xw), dtype=torch.float32,
                            device=self.device)
        x_pad[:, : xs.shape[1], : xs.shape[2]] = xs
        vals: Dict[int, torch.Tensor] = {}       # layer -> [N, vp, w]
        edge_vals: Dict[int, torch.Tensor] = {}  # layer -> [N, E] scores

        sink = man["sink"]
        for t, lp in enumerate(plan.layers):
            meta = lmeta[str(lp.layer_id)]
            self.stats.layers += 1
            ewl = meta.get("edge_weight_layer")
            feat_parents = [p for p in meta["parents"] if p != ewl]
            h_in = (vals.get(feat_parents[0], x_pad) if feat_parents
                    else x_pad)
            lt = lp.layer_type
            t0 = clock.start()
            ops0 = self.stats.tile_ops
            lspan = tracer.span(
                f"layer{lp.layer_id}", cat="exec", track="exec:device",
                args={"type": LayerType(lt).name,
                      "kernel": _KERNEL_MODES[lt], "step": t,
                      "tiles": len(lp.tiles), "lanes": lanes,
                      "instr_lo": lp.instr_lo, "instr_hi": lp.instr_hi})

            if lt in (LayerType.ACTIVATION, LayerType.BATCHNORM) \
                    and lp.on_edges:
                edge_vals[lp.layer_id] = self._run_edge_act(
                    lp, pg, st, edge_vals[feat_parents[0]])
            else:
                io = {"h": h_in,
                      "ew": edge_vals.get(ewl) if ewl is not None
                      else None}
                if lt == LayerType.VECTOR_ADD:
                    a_id, b_id = meta["operands"]
                    io["a"] = x_pad if a_id == -1 else vals[a_id]
                    io["b"] = x_pad if b_id == -1 else vals[b_id]
                kern = self._make_kernel(lp, meta, pg, weights, st)
                env = _DeviceEnv(pg, st, lanes, h=io["h"], a=io.get("a"),
                                 b=io.get("b"), ew=io["ew"])
                if kern.edge_valued:
                    edge_vals[lp.layer_id] = self._scatter_edges(
                        kern, lp, pg, st, env)
                else:
                    # Preallocated padded output; every tile is written
                    # into its slice in place (no concatenation).
                    out = torch.empty((lanes, vp, kern.out_width(io)),
                                      dtype=torch.float32,
                                      device=self.device)
                    out_lanes = out.unbind(0)
                    for tp in self._block_order(lp):
                        rows = slice(tp.out_j * n1, (tp.out_j + 1) * n1)
                        cols = slice(tp.out_i * n2, (tp.out_i + 1) * n2)
                        for o, v in zip(out_lanes, kern.tile(tp, env)):
                            o[rows, cols] = v
                    vals[lp.layer_id] = out
            lspan.add(tile_ops=self.stats.tile_ops - ops0).done()
            self.stats.note_layer(
                layer=int(lp.layer_id), kernel=_KERNEL_MODES[lt],
                step=t, instr_lo=lp.instr_lo, instr_hi=lp.instr_hi,
                wall_s=clock.stop(t0),
                tile_ops=self.stats.tile_ops - ops0)
            self._watermark("alloc", lp.layer_id, vals, edge_vals)
            # Interval liveness: drop outputs whose last consumer just
            # ran, so peak memory follows the live-set, not model depth.
            self._free_dead(t, sink, last_use, vals, edge_vals)

        if clock.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        for rec in self.stats.per_layer or []:
            rec["wall_s"] = _LayerClock.seconds(rec["wall_s"])
        self.stats.h2d_bytes = st.uploaded - up0
        self.total.add(self.stats)
        return vals[sink][:, :nv, :man["sink_f_out"]]

    # ------------------------------------------------------------------ #
    def _scatter_edges(self, kern, lp, pg, st: _Staged,
                       env: _DeviceEnv) -> torch.Tensor:
        """Run an edge-valued layer's tiles and scatter each lane's
        [n1, w] scores of the live slots to their global edge ids (each
        edge lies in exactly one slot).  A fused edge softmax then
        normalizes the scattered scores (see _EdgeScoreKernel)."""
        ew = torch.zeros((env.lanes, pg.n_edges), dtype=torch.float32,
                         device=self.device)
        for tp in self._block_order(lp):
            outs = kern.tile(tp, env)
            pos, epos = env.live(tp.out_j, tp.tile_k, tp.slice_id)
            for n, acc in enumerate(outs):
                ew[n][epos] = acc.reshape(-1)[pos]
        if kern.softmax:
            ew = self._edge_softmax(pg, st, ew)
        return ew

    def _epilogue(self, epilogue, meta: dict, tile: torch.Tensor,
                  weights, st: _Staged, lo: int, hi: int) -> torch.Tensor:
        """Fused scale/shift + activation, in decoded instruction order."""
        for kind, act_id in epilogue:
            if kind == "affine":
                sc0 = weights[meta["fused_scale"]]
                sh0 = weights[meta["fused_shift"]]
                sc = st.param(("fused_scale", meta["fused_scale"], hi),
                              (sc0,), lambda: _padded(sc0, hi))
                sh = st.param(("fused_shift", meta["fused_shift"], hi),
                              (sh0,), lambda: _padded(sh0, hi))
                tile = self.ack.affine(tile, sc[lo:hi], sh[lo:hi])
            else:
                tile = self.ack.act(tile, Activation(act_id))
        return tile

    def _block_order(self, lp: LayerPlan) -> List[TilePlan]:
        """PE-interleaved issue order (round-robin across PE streams)."""
        streams: Dict[int, List[TilePlan]] = {}
        for tp in lp.tiles:
            streams.setdefault(tp.pe, []).append(tp)
        order: List[TilePlan] = []
        idx = 0
        keys = sorted(streams)
        while any(streams[k] for k in keys):
            k = keys[idx % len(keys)]
            if streams[k]:
                order.append(streams[k].pop(0))
            idx += 1
        return order

    # ------------------------------------------------------------------ #
    @staticmethod
    def _edge_softmax_rows(scored) -> List[torch.Tensor]:
        """Two-pass edge softmax over one destination row's tiles.
        ``scored`` is [(raw scores [n1, w], mask)] — masked max, then
        masked exp/sum, then per-tile normalized outputs (same order)."""
        n1 = scored[0][0].shape[0]
        dev = scored[0][0].device
        mx = torch.full((n1,), -_BIG, dtype=torch.float32, device=dev)
        for sc, mask in scored:
            m = torch.where(mask, sc, torch.full_like(sc, -_BIG))
            mx = torch.maximum(mx, torch.amax(m, dim=1))
        mx = torch.where(mx <= -_BIG, torch.zeros_like(mx), mx)
        den = torch.zeros((n1,), dtype=torch.float32, device=dev)
        exps = []
        for sc, mask in scored:
            e = torch.exp(sc - mx[:, None])
            e = torch.where(mask, e, torch.zeros_like(e))
            den = den + torch.sum(e, dim=1)
            exps.append(e)
        den = torch.clamp(den, min=1e-12)
        return [e / den[:, None] for e in exps]

    def _edge_softmax(self, pg, st: _Staged, ew_in) -> torch.Tensor:
        """EDGE_SOFTMAX of every lane's [E] scores in the two-pass tile
        scheme (max/sum accumulated per destination row across a shard's
        tiles, the Activation Unit's exp/divide applied per tile); one
        tile op per tile and traversal."""
        lanes = ew_in.shape[0]
        env = _DeviceEnv(pg, st, lanes)
        ew = torch.zeros((lanes, pg.n_edges), dtype=torch.float32,
                         device=self.device)
        for j in range(pg.n_blocks):
            row_tiles = _row_tiles(pg, j)
            if not row_tiles:
                continue
            masks = [env.tile("mask", j, k, s) for k, s in row_tiles]
            lives = [env.live(j, k, s) for k, s in row_tiles]
            self.stats.tile_ops += len(row_tiles)
            for n in range(lanes):
                scored = [(_from_live(ew_in[n], pos, epos, m.shape), m)
                          for m, (pos, epos) in zip(masks, lives)]
                for (pos, epos), out_t in zip(
                        lives, self._edge_softmax_rows(scored)):
                    ew[n][epos] = out_t.reshape(-1)[pos]
        return ew

    def _run_edge_act(self, lp, pg, st: _Staged, ew_in) -> torch.Tensor:
        """Standalone edge activation of every lane's [E] scores."""
        act = Activation(lp.mode)
        if act == Activation.EDGE_SOFTMAX:
            return self._edge_softmax(pg, st, ew_in)
        self.stats.tile_ops += len(lp.tiles)
        return torch.stack([apply_activation(ew_in[n], act)
                            for n in range(ew_in.shape[0])])
