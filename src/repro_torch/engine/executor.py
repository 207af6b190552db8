"""Binary-driven overlay executor on torch (paper Alg. 9, ISA v3 runtime).

It consumes only the decoded 128-bit instruction stream, the program
manifest and the DDR payload (weights + fiber-shard ELL tiles), exactly as
``repro/engine/executor.py`` does, so a ``CompiledProgram`` loaded from a
``.gagi`` file (written by either package) executes identically to one
compiled in-process.

Two execution paths share ONE shard-step abstraction (a per-layer
:class:`_ShardKernel` computing tiles through an operand environment), so
both run the same ACK kernels on the same values in the same per-tile
order, which is what makes their results bit-identical:

* **device** — every padded layer output lives on the executor's device
  and tiles are issued in PE-interleaved order straight off the resident
  tensors (:class:`_DeviceEnv`).
* **host** (``residency="host"``) — the partition-centric out-of-core
  scheme (paper §6.5, Algorithms 6-8): features and layer outputs stay in
  host memory, and one destination shard's working set (its ELL tiles
  plus the source sub-fibers they gather from) is staged on the device at
  a time (:class:`_HostEnv`), the next shard's already in flight on a side
  CUDA stream.  Lanes interleave per staged shard, so a batch ships each
  shard's tiles once.

On a CUDA device the ACK runs the hand-written GEMM, SpDMM, SDDMM and
densify kernels; on the CPU it runs plain torch.  A sparsity-remapped
binary (:mod:`repro_torch.core.passes.remap`) runs its GEMM steps inside
AGGREGATE layers on the GEMM kernel over densified tiles.  Multi-device
meshes (ROADMAP A13) and graph-as-data (A11) are not ported yet and raise
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

Host-streaming data: the ELL tile kinds are copied once per partitioned
graph into host buffers, one per destination shard and kind, pinned on a
CUDA device (:class:`_HostTiles`, cached on ``prog.pgraph`` beside
``_Staged``), so every host-to-device copy is asynchronous.  See
:meth:`BinaryExecutor._run_host` for the stream discipline.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ack import ACK, densify_tile
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
    # Sparsity-adaptive remapping telemetry (repro_torch.core.passes.remap).
    tiles_remapped: int = 0         # aggregate steps run on the GEMM path
    tiles_skipped: int = 0          # aggregate steps elided by skip-empty
    tile_ops_by_mode: Optional[Dict[str, int]] = None
    # Liveness / streaming telemetry (peaks are high-water marks).
    peak_live_outputs: int = 0      # layer outputs alive at once
    peak_live_bytes: int = 0        # bytes of those outputs
    shards_streamed: int = 0        # destination shards staged (host mode)
    # Bytes copied host -> device this run: tiles / weights uploaded on
    # first use (device mode), every staged working set (host mode).
    h2d_bytes: int = 0
    peak_stage_bytes: int = 0       # double-buffered working set peak
    # Per-decoded-layer attribution: {"layer","kernel","step","instr_lo",
    # "instr_hi","wall_s","tile_ops"} (+ "h2d_bytes" in host mode).  In
    # device mode on a CUDA device ``wall_s`` is the device time between
    # two CUDA events around the layer, read after the run's one final
    # synchronize.  In host mode every shard ends in a synchronize, so a
    # layer's work (its copies on the side stream included) is done when
    # its last shard returns: ``wall_s`` is host wall time around the
    # synchronized layer.  On the CPU it is host wall time.
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
        self.tiles_remapped += other.tiles_remapped
        self.tiles_skipped += other.tiles_skipped
        self.shards_streamed += other.shards_streamed
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
        self.peak_stage_bytes = max(self.peak_stage_bytes,
                                    other.peak_stage_bytes)


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
        return {(j, k, s): self._put(_checked_tile_array(self.pg, kind, j,
                                                         k, s))
                for (j, k), ts in self.pg.tiles.items()
                for s in range(len(ts))}

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


def _checked_tile_array(pg, kind: str, j: int, k: int, s: int
                        ) -> np.ndarray:
    """``kind`` of tile (j, k, s); its column indices are checked, since
    the SpDMM and SDDMM kernels gather h rows at them unchecked and a
    malformed bundle must not reach them."""
    arr = _tile_array(pg.tiles[(j, k)][s], kind)
    n1 = pg.config.n1
    if kind == "cols" and arr.size and (arr.min() < 0 or arr.max() >= n1):
        raise ValueError(f"ELL tile ({j}, {k}, {s}) has column indices "
                         f"outside [0, {n1})")
    return arr


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


# Per-slice element counts of each tile kind (host staging and its
# size estimate): (numel, dtype) of slice ``t``.
_KIND_DTYPES = {"cols": torch.int32, "vals": torch.float32,
                "mask": torch.bool, "row_len": torch.int32,
                "live_pos": torch.int64, "live_epos": torch.int64}


def _kind_numel(t, kind: str) -> int:
    if kind == "row_len":
        return int(t.cols.shape[0])
    if kind in ("live_pos", "live_epos"):
        return int(t.nnz)
    return int(t.cols.size)


class _HostTiles:
    """The ELL tile kinds of one partitioned graph in host memory, for the
    host-streaming path: per destination shard j and kind, ONE flat
    buffer holding every (k, slice) of the shard's row back to back, with
    each slice's (offset, shape).  The buffers are pinned when the
    executor's device is CUDA, so a shard's kind ships in one
    asynchronous copy; they are built on first use of a kind, all shards
    at once, and kept as long as the graph.  Slices start on 16-element
    boundaries (64 bytes for the 4-byte kinds)."""

    _ALIGN = 16

    def __init__(self, pg, pin: bool) -> None:
        self.pg, self.pin = pg, pin
        self.nbytes = 0                 # host bytes held
        self._rows: Dict[str, Dict[int, Tuple[torch.Tensor, dict]]] = {}
        self._inv_deg: Optional[torch.Tensor] = None
        self._lock = threading.Lock()

    def inv_deg(self) -> torch.Tensor:
        """The inverse in-degree [nb * n1] (f32, pinned like the tiles)."""
        if self._inv_deg is None:
            with self._lock:
                if self._inv_deg is None:
                    t = torch.from_numpy(np.ascontiguousarray(
                        self.pg.inv_in_degree, dtype=np.float32))
                    self._inv_deg = t.pin_memory() if self.pin else t
                    self.nbytes += _nbytes(t)
        return self._inv_deg

    def row(self, kind: str, j: int) -> Tuple[torch.Tensor, dict]:
        """(flat buffer, {(k, s): (offset, shape)}) of shard j's kind."""
        got = self._rows.get(kind)
        if got is None:
            with self._lock:
                got = self._rows.get(kind)
                if got is None:
                    got = self._rows[kind] = self._build(kind)
        return got[j]

    def _build(self, kind: str) -> Dict[int, Tuple[torch.Tensor, dict]]:
        pg, a = self.pg, self._ALIGN
        out = {}
        for j in range(pg.n_blocks):
            index, off = {}, 0
            for k, s in _row_tiles(pg, j):
                arr = _checked_tile_array(pg, kind, j, k, s)
                index[(k, s)] = (off, tuple(arr.shape), arr)
                off += (arr.size + a - 1) // a * a
            flat = torch.zeros((off,), dtype=_KIND_DTYPES[kind],
                               pin_memory=self.pin)
            for ks, (o, shape, arr) in index.items():
                flat[o:o + arr.size] = torch.from_numpy(
                    np.ascontiguousarray(arr).reshape(-1))
                index[ks] = (o, shape)
            self.nbytes += _nbytes(flat)
            out[j] = (flat, index)
        return out


def _host_tiles(pg, pin: bool) -> _HostTiles:
    with _staged_lock:
        cache = pg.__dict__.setdefault("_host_tiles", {})
        ht = cache.get(pin)
        if ht is None:
            ht = cache[pin] = _HostTiles(pg, pin)
        return ht


def _slice_of(flat: torch.Tensor, off: int, shape) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    return flat[off:off + n].view(shape)


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


class _HostEnv:
    """Host-streaming path: operands come from the staged working set of
    the CURRENT destination shard ``j`` (a dict of device tensors): the
    shard's ELL kinds under ``(kind,)`` (the whole row, one flat buffer)
    or ``(kind, k, s)`` (one slice), ``("deg",)``, and per lane ``n`` the
    source row blocks ``("h", n, k)`` / operand blocks ``("a" | "b", n,
    j)`` ([n1, w], the layer's full width, so a fiber is a view at the
    same column offset as on the device path) and the dynamic edge
    weights of the live slots ``("ew", n)`` / ``("ew", n, k, s)``.  Tiles
    and views come out exactly as :class:`_DeviceEnv` gives them.  Edge
    ids stay on the host: gathers and scatters by edge id happen there,
    so only the slot positions (``live_pos``) are staged."""

    def __init__(self, pg, ht: _HostTiles, staged: Dict[Tuple, Any],
                 lanes: int, j: int) -> None:
        self.pg, self.ht, self.staged = pg, ht, staged
        self.lanes, self.j = lanes, j
        self.n1, self.n2 = pg.config.n1, pg.config.n2
        self._views: Dict[Tuple, torch.Tensor] = {}

    def h_tile(self, n: int, k: int, i: int) -> torch.Tensor:
        key = ("h", n, k, i)
        t = self._views.get(key)
        if t is None:
            t = self._views[key] = \
                self.staged[("h", n, k)][:, i * self.n2:(i + 1) * self.n2]
        return t

    def operand_tile(self, which: str, n: int, j: int,
                     i: int) -> torch.Tensor:
        return self.staged[(which, n, j)][:, i * self.n2:(i + 1) * self.n2]

    def _slice(self, name: Tuple, kind: str, k: int, s: int) -> torch.Tensor:
        """Slice (k, s) of a staged buffer laid out like ``kind``'s row."""
        key = (*name, k, s)
        t = self._views.get(key)
        if t is None:
            t = self.staged.get(key)
            if t is None:
                off, shape = self.ht.row(kind, self.j)[1][(k, s)]
                t = _slice_of(self.staged[name], off, shape)
            self._views[key] = t
        return t

    def tile(self, kind: str, j: int, k: int, s: int) -> torch.Tensor:
        return self._slice((kind,), kind, k, s)

    def edge_weight_tiles(self, j: int, k: int, s: int) -> List[torch.Tensor]:
        """Every lane's [n1, w] edge-weight tile (0 on pad slots)."""
        shape = self.tile("cols", j, k, s).shape
        pos = self.tile("live_pos", j, k, s)
        return [_place(self._slice(("ew", n), "live_epos", k, s), pos, shape)
                for n in range(self.lanes)]

    def inv_deg_tile(self, j: int) -> torch.Tensor:
        return self.staged[("deg",)]


def _place(v: torch.Tensor, pos: torch.Tensor, shape) -> torch.Tensor:
    """A [n1, w] tile holding ``v`` at its live slots ``pos`` and 0 on the
    pad slots."""
    out = torch.zeros(shape[0] * shape[1], dtype=torch.float32,
                      device=v.device)
    out[pos] = v
    return out.view(shape)


def _from_live(ew: torch.Tensor, pos: torch.Tensor, epos: torch.Tensor,
               shape) -> torch.Tensor:
    """A [n1, w] tile holding ``ew[epos]`` at its live slots ``pos`` and
    0 on the pad slots."""
    return _place(ew[epos], pos, shape)


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

    def tile(self, tp: TilePlan, env) -> List[torch.Tensor]:
        raise NotImplementedError

    # -- host staging: what one destination shard ships, named as
    # _HostEnv reads it.  ``stage_shared`` is shipped once per shard,
    # ``stage_lane`` once per lane (host tensors; views of the pinned
    # buffers where possible). ------------------------------------------ #
    def shared_kinds(self) -> Tuple[str, ...]:
        """ELL tile kinds this layer's tiles read."""
        return ()

    def live_slices(self, tps: List[TilePlan]) -> set:
        """(k, s) tiles the shard's decoded steps compute."""
        return set()

    def lane_blocks(self, j: int, srcs: List[int]) -> List[Tuple[str, int]]:
        """(operand, row block) pairs a lane ships for shard j."""
        return [("h", int(k)) for k in srcs]

    def stage_shared(self, ht: _HostTiles, j: int,
                     tps: List[TilePlan]) -> Dict[Tuple, torch.Tensor]:
        arrs: Dict[Tuple, torch.Tensor] = {}
        live = self.live_slices(tps)
        for kind in self.shared_kinds():
            _stage_row(arrs, (kind,), *ht.row(kind, j), live)
        return arrs

    def stage_lane(self, ht: _HostTiles, j: int, tps: List[TilePlan],
                   io: dict, srcs: List[int],
                   n: int) -> Dict[Tuple, torch.Tensor]:
        n1 = self.n1
        return {(which, n, k): io[which][n, k * n1:(k + 1) * n1]
                for which, k in self.lane_blocks(j, srcs)}

    def shard(self, j: int, tps: List[TilePlan], env, width: int
              ) -> List[torch.Tensor]:
        """Compute shard j's tiles: every lane's [n1, width] output rows
        on the device, each tile written into its columns in place."""
        n2 = self.n2
        slabs = [torch.empty((self.n1, width), dtype=torch.float32,
                             device=self.st.device)
                 for _ in range(env.lanes)]
        for tp in tps:
            self.ex._profile_tile(self, tp)
            cols = slice(tp.out_i * n2, (tp.out_i + 1) * n2)
            for o, v in zip(slabs, self.tile(tp, env)):
                o[:, cols] = v
        return slabs

    def host_write(self, ht: _HostTiles, out: torch.Tensor, j: int,
                   tps: List[TilePlan], res: List[torch.Tensor]):
        """Queue the D2H copies of shard j's results into the host output
        ``out`` on the current stream; returns what the host must do once
        they have landed (None: nothing)."""
        rows = slice(j * self.n1, (j + 1) * self.n1)
        for n, slab in enumerate(res):
            out[n, rows].copy_(slab, non_blocking=True)
        return None


def _stage_row(arrs: Dict[Tuple, torch.Tensor], name: Tuple,
               flat: torch.Tensor, index: dict, live: set) -> None:
    """Name shard j's buffer ``flat`` (slices laid out by ``index``) for
    staging: whole when every slice is live, else only the live slices."""
    if all(ks in live for ks in index):
        arrs[name] = flat
        return
    for ks, (off, shape) in index.items():
        if ks in live:
            arrs[(*name, *ks)] = _slice_of(flat, off, shape)


class _AggregateKernel(_ShardKernel):
    """SpDMM-mode aggregation (paper Alg. 6): accumulate source
    sub-fibers through a destination shard's ELL tiles.

    A sparsity-remapped binary (:mod:`repro_torch.core.passes.remap`) may
    flip individual SPDMM steps to GEMM: the ELL slice is densified into
    an (n1, n1) adjacency block (cached per (j, k, s), so the fiber loop
    densifies once) and multiplied on the GEMM kernel.  Skip-empty
    elisions never reach here: the decoder drops NOPed steps, so
    ``tp.compute`` holds only live work (and staging follows it)."""

    _DENSE_CACHE_CAP = 4         # (n1, n1) f32 blocks: 64 MiB at n1 = 4096

    def __init__(self, ex, lp, meta, pg, weights, st):
        super().__init__(ex, lp, meta, pg, weights, st)
        self.op = {AggOp.SUM: "sum", AggOp.MEAN: "mean",
                   AggOp.MAX: "max", AggOp.MIN: "min"}[AggOp(lp.mode)]
        self.extreme = self.op in ("max", "min")
        self.dyn = meta.get("edge_weight_layer") is not None
        self._dense: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def live_slices(self, tps):
        """(k, s) tiles the decoded stream actually computes — after a
        skip-empty remap this is a subset of the shard row's tiles, so
        elided tiles are never staged either."""
        return {(ins.args[1], ins.args[3] >> 1)
                for tp in tps for ins in tp.compute}

    def shared_kinds(self):
        kinds = ("cols", "vals") + (("mask",) if self.extreme
                                    else ("row_len",))
        return kinds + (("live_pos",) if self.dyn else ())

    def stage_shared(self, ht, j, tps):
        arrs = super().stage_shared(ht, j, tps)
        if self.op == "mean":
            arrs[("deg",)] = ht.inv_deg()[j * self.n1:(j + 1) * self.n1]
        return arrs

    def stage_lane(self, ht, j, tps, io, srcs, n):
        arrs = super().stage_lane(ht, j, tps, io, srcs, n)
        if self.dyn:
            # The lane's weights of the row's live slots, gathered on the
            # host into the live_epos row's layout.
            epos, index = ht.row("live_epos", j)
            ew = torch.empty(epos.shape, dtype=torch.float32,
                             pin_memory=ht.pin)
            torch.index_select(io["ew"][n], 0, epos, out=ew)
            _stage_row(arrs, ("ew", n), ew, index, self.live_slices(tps))
        return arrs

    def _dense_block(self, j: int, k: int, s: int, cols, vals):
        dense = self._dense.get((j, k, s))
        if dense is None:
            if len(self._dense) >= self._DENSE_CACHE_CAP:
                self._dense.clear()
            dense = self._dense[(j, k, s)] = densify_tile(cols, vals,
                                                          self.n1)
        return dense

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
        for ins in tp.compute:           # SPDMM/GEMM steps, stream order
            k, ii = ins.args[1], ins.args[2]
            s, dyn = ins.args[3] >> 1, ins.args[3] & 1
            cols = env.tile("cols", j, k, s)
            vals = (env.edge_weight_tiles(j, k, s) if dyn
                    else [env.tile("vals", j, k, s)] * env.lanes)
            if ins.op == Opcode.GEMM:    # remapped dense-aggregate step
                # (SUM/MEAN layers only: remap keeps MAX/MIN on SpDMM.)
                if dyn:
                    # per-lane edge weights: densify inline, no cache
                    for n in lanes:
                        accs[n] = self.ex.ack.gemm_agg(
                            cols, vals[n], env.h_tile(n, k, ii), accs[n])
                else:
                    dense = self._dense_block(j, k, s, cols, vals[0])
                    for n in lanes:
                        accs[n] = self.ex.ack.gemm(
                            dense, env.h_tile(n, k, ii), accs[n])
                self.ex.stats.tiles_remapped += 1
                self._op("gemm")
                continue
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

    def lane_blocks(self, j, srcs):
        return [("a", j), ("b", j)]

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

    def shared_kinds(self):
        return ("cols", "mask", "live_pos")

    def live_slices(self, tps):
        return {(tp.tile_k, tp.slice_id) for tp in tps}

    def shard(self, j, tps, env, width):
        """Every lane's scores of shard j's live slots, tile after tile
        in ``tps`` order (one device vector per lane)."""
        parts: List[List[torch.Tensor]] = [[] for _ in range(env.lanes)]
        for tp in tps:
            self.ex._profile_tile(self, tp)
            pos = env.tile("live_pos", j, tp.tile_k, tp.slice_id)
            for n, acc in enumerate(self.tile(tp, env)):
                parts[n].append(acc.reshape(-1)[pos])
        return [torch.cat(p) if p else torch.zeros(
            (0,), dtype=torch.float32, device=self.st.device)
            for p in parts]

    def host_write(self, ht, out, j, tps, res):
        epos_row, index = ht.row("live_epos", j)
        epos = torch.cat([_slice_of(epos_row, *index[(tp.tile_k,
                                                      tp.slice_id)])
                          for tp in tps]) if tps else None
        bufs = []
        for v in res:
            b = torch.empty(v.shape, dtype=torch.float32, pin_memory=ht.pin)
            b.copy_(v, non_blocking=True)
            bufs.append(b)

        def scatter():
            for n, b in enumerate(bufs):
                if epos is not None:
                    out[n, epos] = b
        return scatter

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
        # Per-tile execution profiling (density + kernel mode, the
        # remapper's ``exec_profile`` input): collected whenever tracing
        # is enabled OR this flag is set, folded into the program
        # manifest at the end of each run.
        self.profile_tiles = False
        self._tile_records: Optional[dict] = None
        self._static_bytes = 0          # resident weights (host mode)
        self._host_lanes = 1
        self._copy_stream = None        # host mode's side stream (CUDA)
        self.stats = ExecStats()        # per-run (last run)
        self.total = ExecStats()        # lifetime accumulation

    def _note_skips(self, prog: CompiledProgram) -> None:
        """Credit the run's skip-empty elisions from the remap record —
        the decoder drops NOPed steps, so the executor can't observe
        them; the record is how many compute steps one pass elides."""
        rec = prog.manifest.get("remap")
        if rec:
            self.stats.tiles_skipped = int(rec.get("skipped_tile_ops", 0))

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
            f"{detail}; re-run with residency='host' to stream "
            "shard-by-shard" + (" or shrink the batch" if batch > 1
                                 else ""))

    def estimate_host_window_bytes(self, prog: CompiledProgram,
                                   x_cols: Optional[int] = None,
                                   batch: int = 1) -> int:
        """The largest double-buffered working set (two consecutive
        shards' staged bytes, edge-softmax rows alone) of a host-streaming
        pass, from the plan and the tiles' shapes alone, before any run:
        what ``peak_stage_bytes`` will read.  The budget check of that
        pass adds the weights (:attr:`_static_bytes`)."""
        plan = prog.plan()
        pg = prog.pgraph
        res = resolve_residency(prog)
        n1, n2 = pg.config.n1, pg.config.n2
        lmeta = prog.manifest["layers"]
        st = _staged(pg, self.device)

        def fp(f: int) -> int:
            return ((max(f, 1) + n2 - 1) // n2) * n2

        def slice_bytes(kind: str, j: int, live: set,
                        item: Optional[int] = None) -> int:
            """Bytes _stage_row ships of shard j's ``kind`` row (``item``
            bytes an element, the kind's own by default)."""
            item = item or torch.empty(
                (), dtype=_KIND_DTYPES[kind]).element_size()
            row = _row_tiles(pg, j)
            whole = all(ks in live for ks in row)
            a = _HostTiles._ALIGN
            n = 0
            for k, s in row:
                m = _kind_numel(pg.tiles[(j, k)][s], kind)
                if whole:
                    n += (m + a - 1) // a * a
                elif (k, s) in live:
                    n += m
            return n * item

        x_w = fp(plan.layers[0].f_in) if plan.layers else n2
        if x_cols is not None:
            x_w = max(x_w, fp(x_cols))
        widths = {-1: x_w}
        peak = 0
        for lp in plan.layers:
            meta = lmeta[str(lp.layer_id)]
            ewl = meta.get("edge_weight_layer")
            parents = [p for p in meta["parents"] if p != ewl]
            widths[lp.layer_id] = (fp(lp.f_out)
                                   if lp.layer_type == LayerType.LINEAR
                                   else fp(lp.f_in))
            if lp.on_edges and lp.layer_type in (LayerType.ACTIVATION,
                                                 LayerType.BATCHNORM):
                if Activation(lp.mode) == Activation.EDGE_SOFTMAX:
                    for j in range(pg.n_blocks):
                        live = set(_row_tiles(pg, j))
                        peak = max(peak, slice_bytes("mask", j, live)
                                   + slice_bytes("live_pos", j, live)
                                   + batch * slice_bytes("live_epos", j,
                                                         live, 4))
                continue
            kern = self._make_kernel(lp, meta, pg, prog.weights, st)
            by_j: Dict[int, List[TilePlan]] = {}
            for tp in lp.tiles:
                by_j.setdefault(tp.out_j, []).append(tp)
            rl = res["layers"][str(lp.layer_id)]
            order = [j for j in rl["shard_order"] if j in by_j]
            h_w = widths.get(parents[0], x_w) if parents else x_w
            if lp.layer_type == LayerType.VECTOR_ADD:
                w_of = {op: widths.get(int(i), x_w) for op, i in
                        zip("ab", meta["operands"])}
            else:
                w_of = {"h": h_w}
            sizes = []
            for j in order:
                live = kern.live_slices(by_j[j])
                b = sum(slice_bytes(kind, j, live)
                        for kind in kern.shared_kinds())
                if getattr(kern, "op", None) == "mean":
                    b += n1 * 4
                lane = sum(n1 * w_of[op] * 4 for op, _ in
                           kern.lane_blocks(j, rl["sources"].get(str(j),
                                                                 [])))
                if getattr(kern, "dyn", False):
                    lane += slice_bytes("live_epos", j, live, 4)
                sizes.append(b + batch * lane)
            for a, b in zip(sizes, sizes[1:] + [0]):
                peak = max(peak, a + b)
        return peak

    # ------------------------------------------------------------------ #
    # Per-tile execution profile (Dynasparse-style): which kernel mode ran
    # each graph tile, how often, against what density.  Lane 0 only.
    # ------------------------------------------------------------------ #
    def _begin_profile(self) -> None:
        if get_tracer().enabled or self.profile_tiles:
            self._tile_records = {"modes": {}, "tiles": {}}
        else:
            self._tile_records = None

    def _profile_tile(self, kern: _ShardKernel, tp: TilePlan) -> None:
        """Record one TilePlan dispatch.  Graph (ELL) tiles are keyed
        (j, k, s) so their nnz/density can be joined at flush time;
        dense GEMM / vector tiles only feed the kernel-mode histogram."""
        recs = self._tile_records
        if recs is None:
            return
        lt = kern.lp.layer_type
        mode = _KERNEL_MODES[lt]
        tiles = recs["tiles"]
        if lt == LayerType.AGGREGATE:
            # Per-instruction mode: a sparsity-remapped binary may carry
            # GEMM steps inside an aggregate layer.
            for ins in tp.compute:
                imode = "gemm" if ins.op == Opcode.GEMM else mode
                key = (tp.out_j, ins.args[1], ins.args[3] >> 1)
                r = tiles.get(key)
                if r is None:
                    tiles[key] = r = {"kernel": imode, "ops": 0}
                r["kernel"] = imode
                r["ops"] += 1
                recs["modes"][imode] = recs["modes"].get(imode, 0) + 1
            return
        elif lt == LayerType.VECTOR_INNER:
            ops = len(tp.compute)
            key = (tp.out_j, tp.tile_k, tp.slice_id)
            r = tiles.get(key)
            if r is None:
                tiles[key] = r = {"kernel": mode, "ops": 0}
            r["ops"] += ops
        elif lt == LayerType.LINEAR:
            ops = len(tp.compute)
        else:
            ops = 1
        recs["modes"][mode] = recs["modes"].get(mode, 0) + ops

    def _flush_profile(self, prog: CompiledProgram) -> None:
        """Fold the run's per-tile records into the program manifest's
        ``exec_profile`` section (round-trips ``.gagi``): kernel-mode
        op histogram + per-graph-tile nnz/density/ops/mode — exactly
        the observed-density input a bind-time kernel remapper needs."""
        recs, self._tile_records = self._tile_records, None
        if recs is None:
            return
        pg = prog.pgraph
        prof = prog.manifest.get("exec_profile")
        if prof is None:
            prof = {"runs": 0, "kernel_modes": {}, "tiles": {},
                    "density_histogram": [0] * 10}
            prog.manifest["exec_profile"] = prof
        prof["runs"] += 1
        for mode, n in recs["modes"].items():
            prof["kernel_modes"][mode] = \
                prof["kernel_modes"].get(mode, 0) + int(n)
        for (j, k, s), r in recs["tiles"].items():
            slices = pg.tiles.get((j, k))
            if slices is None or s >= len(slices):
                continue
            t = slices[s]
            slots = int(t.cols.size)
            density = (int(t.nnz) / slots) if slots else 0.0
            key = f"{j}:{k}:{s}"
            entry = prof["tiles"].get(key)
            if entry is None:
                entry = {"ops": 0}
                prof["tiles"][key] = entry
                prof["density_histogram"][min(int(density * 10), 9)] += 1
            entry.update(nnz=int(t.nnz), slots=slots,
                         density=round(density, 6), kernel=r["kernel"])
            entry["ops"] += int(r["ops"])

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
        if residency == "host":
            # Streaming trades latency for footprint: the lanes stream
            # TOGETHER, interleaved per staged shard, so each shard's
            # tile working set ships once for the whole batch.
            return self._run_host(prog, xs, weights)
        lanes = int(xs.shape[0])
        self._gate_device_budget(prog, int(xs.shape[2]), batch=lanes)
        xs = xs.to(self.device)
        self.stats = ExecStats(runs=1)
        self._note_skips(prog)
        tracer = get_tracer()
        self._begin_profile()
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
                        self._profile_tile(kern, tp)
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
        self._flush_profile(prog)
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
            self._profile_tile(kern, tp)
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

    # ------------------------------------------------------------------ #
    # Partition-centric out-of-core execution (paper §6.5, Alg. 6-8).
    #
    # Features and layer outputs stay in HOST memory ([N, vp, w] lane
    # stacks, edge vectors [N, E], pinned on a CUDA device); the device
    # holds one destination shard's working set at a time (its ELL tiles
    # plus the source row blocks they gather from) while the NEXT shard's
    # is already being copied on a side CUDA stream, the software
    # analogue of the paper's double-buffered DDR<->BRAM overlap.
    # Stream discipline on a CUDA device:
    #  * a working set is allocated and copied on the side stream; an
    #    event closes its copies, and the compute stream (the caller's
    #    current one) waits on that event before the shard's first kernel;
    #  * every staged tensor is record_stream'ed on the compute stream, so
    #    the caching allocator does not hand its memory to a later copy
    #    while a kernel of this shard may still read it;
    #  * a shard's results go back into the pinned host outputs by D2H
    #    copies on the compute stream, and the host synchronizes that
    #    stream once per shard before it touches them, after it has
    #    queued the next shard's copies (which overlap this compute).
    # On a CPU device staging is a plain copy.  Every tile op runs through
    # the same shard kernels on the same values in the same order as the
    # device-resident path, so the results are bit-identical.
    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _stage(self, arrs: Dict[Tuple, torch.Tensor], **span_args):
        """Ship one working set host -> device; returns (staged, bytes,
        the event closing its copies or None).  ``span_args`` (``shard``,
        ``layer``) land on the stage span."""
        with get_tracer().span("stage", cat="h2d", track="h2d",
                               args=span_args or None) as sp:
            nbytes = sum(_nbytes(a) for a in arrs.values())
            ready = None
            if self.device.type == "cuda":
                compute = torch.cuda.current_stream(self.device)
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._copy_stream):
                    staged = {k: a.to(self.device, non_blocking=True)
                              for k, a in arrs.items()}
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                for t in staged.values():
                    t.record_stream(compute)
            else:
                staged = {k: a.clone() for k, a in arrs.items()}
            sp.add(bytes=nbytes, arrays=len(arrs))
        self.stats.h2d_bytes += nbytes
        return staged, nbytes, ready

    def _wait(self, ready) -> None:
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)

    def _stream_shards(self, order: List[int], build, compute,
                       layer: int = -1) -> None:
        """Drive one layer's destination shards through the double
        buffer: stage shard ``order[0]``; then for each shard queue its
        tile ops, stage the NEXT shard's working set while they run, and
        only then synchronize and finish the shard's write-back on the
        host.  ``build(j)`` assembles shard j's working set (host
        tensors); ``compute(j, staged)`` queues the tile ops and the D2H
        copies and returns what the host does after the synchronize."""
        if not order:
            return
        tracer = get_tracer()
        nxt = self._stage(build(order[0]), shard=int(order[0]), layer=layer)
        for idx, j in enumerate(order):
            staged, cur_bytes, ready = nxt
            cspan = tracer.span("compute", cat="exec", track="exec:host",
                                args={"shard": int(j), "layer": layer,
                                      "staged_bytes": cur_bytes})
            self._wait(ready)
            after = compute(j, staged)
            nxt, next_bytes = None, 0
            if idx + 1 < len(order):
                arrs = build(order[idx + 1])
                next_bytes = sum(_nbytes(a) for a in arrs.values())
            window = cur_bytes + next_bytes
            self.stats.peak_stage_bytes = max(
                self.stats.peak_stage_bytes, window)
            if (self.resident_budget_bytes is not None
                    and window + self._static_bytes
                    > self.resident_budget_bytes):
                lanes = self._host_lanes
                raise ResidentBudgetError(
                    f"shard working set ({window} bytes double-buffered "
                    f"+ {self._static_bytes} resident weights) exceeds "
                    "resident_budget_bytes="
                    f"{self.resident_budget_bytes}; recompile with a "
                    "smaller n1 / width_cap"
                    + (" or shrink the batch (the staged window "
                       f"carries {lanes} interleaved lanes)"
                       if lanes > 1 else ""))
            if idx + 1 < len(order):
                nxt = self._stage(arrs, shard=int(order[idx + 1]),
                                  layer=layer)
            self._sync()                 # shard j's results have landed
            if after is not None:
                after()
            del staged
            cspan.done()
            self.stats.shards_streamed += 1

    def _run_host(self, prog: CompiledProgram, xs: torch.Tensor,
                  weights: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Stream the ``[N, V, F]`` feature lanes ``xs`` through the
        partition-centric path as ONE pass; returns the sink's
        ``[N, V, f_out]`` output on the device.  Lanes interleave per
        staged shard: the shard's tile working set (``stage_shared``)
        ships once for the whole batch, each lane adds only its source
        row blocks (``stage_lane``)."""
        lanes = int(xs.shape[0])
        self.stats = ExecStats(runs=1)
        self._note_skips(prog)
        tracer = get_tracer()
        self._begin_profile()
        with tracer.span("decode", cat="exec", track="exec:host",
                         args={"cached": prog._plan is not None,
                               "lanes": lanes}):
            plan = prog.plan()
        man = prog.manifest
        pg = prog.pgraph
        res = resolve_residency(prog)
        weights = weights if weights is not None else prog.weights
        self._static_bytes = sum(
            _nbytes(w if isinstance(w, torch.Tensor) else np.asarray(w))
            for w in weights.values())
        self._host_lanes = lanes        # budget refusals name the lanes
        lmeta = man["layers"]
        n1, n2, nb = pg.config.n1, pg.config.n2, pg.n_blocks
        vp = nb * n1
        nv = pg.n_vertices
        sink = man["sink"]
        last_use = {int(k): v for k, v in res["last_use"].items()}
        pin = self.device.type == "cuda"
        ht = _host_tiles(pg, pin)
        st = _staged(pg, self.device)

        def host_zeros(*shape) -> torch.Tensor:
            return torch.zeros(shape, dtype=torch.float32, pin_memory=pin)

        fin_pad0 = ((max(plan.layers[0].f_in, 1) + n2 - 1) // n2) * n2
        xw = max(fin_pad0, ((xs.shape[2] + n2 - 1) // n2) * n2)
        x_host = host_zeros(lanes, vp, xw)
        x_host[:, : xs.shape[1], : xs.shape[2]] = xs.cpu()
        vals: Dict[int, torch.Tensor] = {}       # layer -> [N, vp, w]
        edge_vals: Dict[int, torch.Tensor] = {}  # layer -> [N, E] scores

        for t, lp in enumerate(plan.layers):
            meta = lmeta[str(lp.layer_id)]
            rl = res["layers"][str(lp.layer_id)]
            self.stats.layers += 1
            ewl = meta.get("edge_weight_layer")
            feat_parents = [p for p in meta["parents"] if p != ewl]
            lt = lp.layer_type
            t0 = time.perf_counter()
            ops0 = self.stats.tile_ops
            h2d0 = self.stats.h2d_bytes
            lspan = tracer.span(
                f"layer{lp.layer_id}", cat="exec", track="exec:host",
                args={"type": LayerType(lt).name,
                      "kernel": _KERNEL_MODES[lt], "step": t,
                      "tiles": len(lp.tiles), "lanes": lanes,
                      "instr_lo": lp.instr_lo, "instr_hi": lp.instr_hi})

            if lt in (LayerType.ACTIVATION, LayerType.BATCHNORM) \
                    and lp.on_edges:
                edge_vals[lp.layer_id] = self._host_edge_act(
                    lp, pg, ht, edge_vals[feat_parents[0]])
            else:
                h_in = (vals.get(feat_parents[0], x_host) if feat_parents
                        else x_host)
                io = {"h": h_in,
                      "ew": edge_vals.get(ewl) if ewl is not None
                      else None}
                if lt == LayerType.VECTOR_ADD:
                    a_id, b_id = meta["operands"]
                    io["a"] = x_host if a_id == -1 else vals[a_id]
                    io["b"] = x_host if b_id == -1 else vals[b_id]
                kern = self._make_kernel(lp, meta, pg, weights, st)
                by_j: Dict[int, List[TilePlan]] = {}
                for tp in self._block_order(lp):
                    by_j.setdefault(tp.out_j, []).append(tp)
                order = [j for j in rl["shard_order"] if j in by_j]
                srcs = rl["sources"]
                width = 0 if kern.edge_valued else kern.out_width(io)
                out = (host_zeros(lanes, pg.n_edges) if kern.edge_valued
                       else host_zeros(lanes, vp, width))

                def build(j, kern=kern, by_j=by_j, io=io, srcs=srcs):
                    arrs = kern.stage_shared(ht, j, by_j[j])
                    for n in range(lanes):
                        arrs.update(kern.stage_lane(
                            ht, j, by_j[j], io, srcs.get(str(j), []), n))
                    return arrs

                def compute(j, staged, kern=kern, by_j=by_j, out=out,
                            width=width):
                    env = _HostEnv(pg, ht, staged, lanes, j)
                    res_j = kern.shard(j, by_j[j], env, width)
                    return kern.host_write(ht, out, j, by_j[j], res_j)

                self._stream_shards(order, build, compute,
                                    layer=int(lp.layer_id))
                if kern.edge_valued:
                    if kern.softmax:
                        out = self._host_edge_softmax(pg, ht, out)
                    edge_vals[lp.layer_id] = out
                else:
                    vals[lp.layer_id] = out
            lspan.add(tile_ops=self.stats.tile_ops - ops0,
                      h2d_bytes=self.stats.h2d_bytes - h2d0).done()
            self.stats.note_layer(
                layer=int(lp.layer_id), kernel=_KERNEL_MODES[lt],
                step=t, instr_lo=lp.instr_lo, instr_hi=lp.instr_hi,
                wall_s=time.perf_counter() - t0,
                tile_ops=self.stats.tile_ops - ops0,
                h2d_bytes=self.stats.h2d_bytes - h2d0)
            self._watermark("alloc", lp.layer_id, vals, edge_vals)
            self._free_dead(t, sink, last_use, vals, edge_vals)
            if last_use.get(-1, -1) == t:
                x_host = None          # the input's last consumer has run

        y = vals[sink][:, :nv, : man["sink_f_out"]].to(self.device)
        self._flush_profile(prog)
        self.total.add(self.stats)
        return y

    def _host_edge_act(self, lp, pg, ht: _HostTiles,
                       ew_in: torch.Tensor) -> torch.Tensor:
        """Edge activation of every lane's host-resident [E] scores: the
        vectors are staged, activated on the device as the device path
        does, and copied back; the softmax goes row by row
        (:meth:`_host_edge_softmax`)."""
        act = Activation(lp.mode)
        if act == Activation.EDGE_SOFTMAX:
            return self._host_edge_softmax(pg, ht, ew_in)
        staged, nbytes, ready = self._stage({("ew",): ew_in})
        self.stats.peak_stage_bytes = max(self.stats.peak_stage_bytes,
                                          nbytes)
        self._wait(ready)
        self.stats.tile_ops += len(lp.tiles)
        d = staged[("ew",)]
        got = torch.stack([apply_activation(d[n], act)
                           for n in range(d.shape[0])])
        out = torch.empty(ew_in.shape, dtype=torch.float32,
                          pin_memory=ht.pin)
        out.copy_(got, non_blocking=True)
        self._sync()
        return out

    def _host_edge_softmax(self, pg, ht: _HostTiles,
                           ew_in: torch.Tensor) -> torch.Tensor:
        """EDGE_SOFTMAX of every lane's host-resident [E] scores, one
        destination row at a time: the row's masks and live slots are
        staged once, each lane adds its scores of the live slots, and the
        SAME row math as the device path (``_edge_softmax_rows`` over
        tiles built like ``_from_live``) runs on the device."""
        lanes = ew_in.shape[0]
        out = torch.zeros(ew_in.shape, dtype=torch.float32,
                          pin_memory=ht.pin)
        for j in range(pg.n_blocks):
            row_tiles = _row_tiles(pg, j)
            if not row_tiles:
                continue
            every = set(row_tiles)
            arrs: Dict[Tuple, torch.Tensor] = {}
            for kind in ("mask", "live_pos"):
                _stage_row(arrs, (kind,), *ht.row(kind, j), every)
            epos, index = ht.row("live_epos", j)
            for n in range(lanes):
                sc = torch.empty(epos.shape, dtype=torch.float32,
                                 pin_memory=ht.pin)
                torch.index_select(ew_in[n], 0, epos, out=sc)
                _stage_row(arrs, ("ew", n), sc, index, every)
            staged, nbytes, ready = self._stage(arrs, shard=int(j))
            self.stats.peak_stage_bytes = max(
                self.stats.peak_stage_bytes, nbytes)
            if (self.resident_budget_bytes is not None
                    and nbytes + self._static_bytes
                    > self.resident_budget_bytes):
                raise ResidentBudgetError(
                    f"edge-softmax row working set ({nbytes} bytes + "
                    f"{self._static_bytes} resident weights) exceeds "
                    f"resident_budget_bytes={self.resident_budget_bytes}"
                    "; recompile with a smaller n1 / width_cap")
            self._wait(ready)
            env = _HostEnv(pg, ht, staged, lanes, j)
            masks = [env.tile("mask", j, k, s) for k, s in row_tiles]
            poss = [env.tile("live_pos", j, k, s) for k, s in row_tiles]
            self.stats.tile_ops += len(row_tiles)
            bufs = []
            for n in range(lanes):
                scored = [(_place(env._slice(("ew", n), "live_epos", k, s),
                                  pos, m.shape), m)
                          for (k, s), m, pos in zip(row_tiles, masks, poss)]
                live = torch.cat([o.reshape(-1)[pos] for o, pos in zip(
                    self._edge_softmax_rows(scored), poss)])
                b = torch.empty(live.shape, dtype=torch.float32,
                                pin_memory=ht.pin)
                b.copy_(live, non_blocking=True)
                bufs.append(b)
            self._sync()
            ids = torch.cat([_slice_of(epos, *index[ks])
                             for ks in row_tiles])
            for n, b in enumerate(bufs):
                out[n, ids] = b
            self.stats.shards_streamed += 1
        return out
