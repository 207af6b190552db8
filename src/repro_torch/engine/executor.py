"""Binary-driven overlay executor on torch (paper Alg. 9, ISA v3 runtime).

It consumes only the decoded 128-bit instruction stream, the program
manifest and the DDR payload (weights + fiber-shard ELL tiles), exactly as
``repro/engine/executor.py`` does, so a ``CompiledProgram`` loaded from a
``.gagi`` file (written by either package) executes identically to one
compiled in-process.

Three execution paths share ONE shard-step abstraction (a per-layer
:class:`_ShardKernel` computing tiles through an operand environment), so
all run the same ACK kernels on the same values in the same per-tile
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
* **mesh** (``mesh=``, a :class:`repro_torch.launch.mesh.DeviceMesh`) —
  the placement-scheduled multi-device path: destination row blocks are
  assigned to the mesh's devices (the manifest's ``placement`` section,
  or one derived from the binary), features live block-permuted as one
  ``[B*n1, f]`` slab per device, and before each AGGREGATE or
  VECTOR_INNER layer whose halo sets are non-empty every device gets the
  gathered ``[D, B*n1, f]`` view of all slabs (:meth:`_mesh_exchange`).
  Each device then runs its own shard order (:class:`_MeshEnv`).  One
  process drives every device, as in the JAX package; a device may
  appear more than once in a mesh (virtual shards), which is how the
  path runs on one card or on the CPU.

On a CUDA device the ACK runs the hand-written GEMM, SpDMM, SDDMM and
densify kernels; on the CPU it runs plain torch.  A sparsity-remapped
binary (:mod:`repro_torch.core.passes.remap`) runs its GEMM steps inside
AGGREGATE layers on the GEMM kernel over densified tiles.

Graph-as-data (the sampling layer's mode): ``run`` / ``run_batch`` take
``graph_data``, each lane's own topology in the program's canonical ELL
layout (:class:`_LaneTiles`), in place of the baked tiles.  The program
is compiled once per geometry bucket against the bucket's template graph
(:mod:`repro_torch.sampling.buckets`), so N different subgraphs of one
bucket run as ONE binary pass; every tile op is issued once per lane on
that lane's tiles.  It is device-resident only.  Every array a lane
ships has a shape fixed by the program's layout, whatever the request's
live edges: edge values move through each slot's edge id, pad slots
pointing one past the end of the edge vector (a trash entry), so a pass
over new lanes is a replay of the same launches.

Replays (the counterpart of the JAX package's memoized
``jit(vmap(run))``): on a CUDA device a device-resident ``run_batch``
without a ``weights`` override or a mesh is memoized on the program
object, keyed by batch shape, dtype, graph-as-data flag, backend, device,
the staging it reads (:class:`_Staged`'s generation) and the executor.
Calls run eagerly until one stages nothing (the first pass on a staging
uploads its tiles and weights and builds the kernels): that warm pass's
stats are kept, with their per-layer CUDA-event times.  The next call
captures the pass as a CUDA graph over static input buffers, and every
later one copies its features (and lanes) into those buffers and replays
the graph.  A replay's ``stats`` are the warm eager pass's (its per-layer
times included), with ``h2d_bytes`` the bytes it copied.
``BinaryExecutor(replay=False)`` runs every pass eagerly.  Releasing a
staging (:func:`release_staging`) drops the captures that read it, and an
executor that is collected drops its own.  An executor's captures share
one memory pool (it runs one pass at a time, each ending in a
synchronize), and the device-budget gate counts the bytes a program's
captures hold (:meth:`BinaryExecutor._held_bytes`) beside the pass.

Batches: :meth:`BinaryExecutor.run_batch` executes N feature sets over one
program in ONE traversal of the decoded binary.  Layer outputs carry a
leading lane axis (``[N, vp, w]``; edge vectors ``[N, E]``) and every tile
op is issued once per lane on that lane's views, so a lane computes
exactly what a single run computes (bit for bit) while the decode, the
plan walk and the per-tile index work are shared.  ``run`` is
``run_batch`` of one lane.  Per-run ``stats`` count one traversal (its
tile ops), kernel launches are lanes x tile ops (a replay's launches are
counted in ``kernels.ops.REPLAYED``, the wrappers' in ``LAUNCHES``).

Device-resident data:

* The baked ELL tiles are uploaded ONCE per partitioned graph and device
  (:class:`_Staged`, cached on ``prog.pgraph``, the object the engine's
  cached program and the handles it returns share): ``cols`` and ``vals``
  for every aggregation, ``mask`` and the live slots (``live_pos`` /
  ``live_epos``: each tile's flat positions of real edges and their edge
  ids) only for the layers that read them (MAX/MIN, dynamic edge weights,
  edge-valued layers).  The padded weights and the inverse in-degree are
  uploaded once as well.
* A tile's device copy is shared by every partitioned graph that holds
  the same :class:`ELLTile` object (:class:`_TileShare`): the versions of
  a live graph (:mod:`repro_torch.livegraph`) share every tile their
  deltas did not patch, so a version uploads only its patched tiles (and
  its inverse in-degree).  :func:`release_staging` drops a graph's
  copies; a shared tile's stay while another graph holds it.
* Edge vectors move between baked tiles and the [E] edge order through
  the live slots only: scattering a tile's scores, gathering a tile's
  edge weights and the edge softmax touch the real edges, not the pad
  slots (over 99% of the slots on a power-law graph), with the same
  result.  (Graph-as-data lanes move every slot, pads through the trash
  entry, so their shapes do not depend on the request.)
* Tiles are strided views of the padded layer tensors; the kernels take
  row strides, so no tile is copied on its way in.
* Every launch goes to the caller's current CUDA stream, and a run ends
  by synchronizing that stream only, so two engines on one card (each on
  its own stream) do not wait for each other.

Host-streaming data: the ELL tile kinds are copied once per partitioned
graph into host buffers, one per destination shard and kind, pinned on a
CUDA device (:class:`_HostTiles`, cached on ``prog.pgraph`` beside
``_Staged``), so every host-to-device copy is asynchronous.  A shard's
buffer is shared, like a device tile, by every graph whose row holds the
same tile objects, so a live version pins only the rows its delta
patched.  See :meth:`BinaryExecutor._run_host` for the stream
discipline.

Edge ids: a live version's ``n_edges`` is its edge-id capacity, and ids
its deltas freed stay holes in the edge vectors.  Edge values move
through the live slots only (``live_epos``), so no kernel, scatter or
softmax reads a hole.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ack import ACK, densify_tile
from repro_torch.core.ir import Activation, AggOp, LayerType
from repro_torch.core.isa import Opcode
from repro_torch.core.reference import apply_activation
from repro_torch.kernels import ops as kops
from repro_torch.obs.tracer import NullTracer, get_tracer

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
    # Multi-device placement telemetry (mesh mode).
    n_devices: int = 1              # mesh size of the last run
    halo_bytes: int = 0             # compile-time halo exchange volume
    # Gathered-view volume of the halo exchanges, D * B*n1 * f * 4 bytes
    # a layer (what JAX's all_gather moves; on one device no byte moves).
    halo_gather_bytes: int = 0
    peak_device_bytes: int = 0      # est. per-device resident peak
    per_device: Optional[List[dict]] = None  # {"device","tile_ops",...}
    # Per-decoded-layer attribution: {"layer","kernel","step","instr_lo",
    # "instr_hi","wall_s","tile_ops"} (+ "h2d_bytes" in host mode,
    # "halo_gather_bytes" in mesh mode).  In
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
        self.halo_bytes += other.halo_bytes
        self.halo_gather_bytes += other.halo_gather_bytes
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
        self.n_devices = max(self.n_devices, other.n_devices)
        self.peak_device_bytes = max(self.peak_device_bytes,
                                     other.peak_device_bytes)
        if other.per_device is not None:
            # MERGE per-device counters (keyed by device index) so the
            # lifetime total keeps per-device sums across mesh runs.
            if self.per_device is None:
                self.per_device = [dict(d) for d in other.per_device]
            else:
                by_dev = {d.get("device"): d for d in self.per_device}
                for od in other.per_device:
                    mine = by_dev.get(od.get("device"))
                    if mine is None:
                        self.per_device.append(dict(od))
                        continue
                    for k, v in od.items():
                        if k in ("device", "blocks"):
                            mine[k] = v          # identity / geometry
                        else:
                            mine[k] = mine.get(k, 0) + v
                self.per_device.sort(key=lambda d: d.get("device", 0))

    @property
    def device_imbalance(self) -> float:
        """max/mean per-device tile ops of the last mesh run (1.0 when
        single-device or perfectly balanced)."""
        if not self.per_device:
            return 1.0
        loads = [d["tile_ops"] for d in self.per_device]
        mean = sum(loads) / len(loads)
        return (max(loads) / mean) if mean > 0 else 1.0


def _nbytes(a) -> int:
    """Bytes of a numpy array or a torch tensor, or of a list of them
    (a mesh value: one slab per device)."""
    if isinstance(a, (list, tuple)):
        return sum(_nbytes(x) for x in a)
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


def derive_placement(plan, residency: dict, geometry: dict,
                     n_devices: int) -> dict:
    """Rebuild the placement schedule from the decoded binary — the
    fallback for ``.gagi`` bundles written before manifests carried a
    ``placement`` section (or compiled for another mesh size).  It uses
    the compiler pass's LPT costs (compute instructions per destination
    row block) and its :func:`build_placement`, so the derived schedule
    is the one ``placement_schedule`` emits."""
    from repro_torch.core.passes.schedule import (build_placement,
                                                  shard_block_costs)
    costs = shard_block_costs(
        ([(tp.out_j, len(tp.compute)) for tp in lp.tiles]
         for lp in plan.layers),
        int(geometry["n_blocks"]))
    f_in = {str(lp.layer_id): int(lp.f_in) for lp in plan.layers}
    return build_placement(residency, costs, n_devices,
                           int(geometry["n1"]), int(geometry["n2"]), f_in)


def ensure_placement(prog: CompiledProgram, n_devices: int) -> dict:
    """The manifest's placement section for ``n_devices``, derived from
    the decoded binary when the manifest lacks it (old bundles, or a
    program compiled for another mesh size).  The derived schedule is
    attached to the manifest, so a later ``save`` writes it."""
    pl = prog.manifest.get("placement")
    if pl is not None and int(pl.get("n_devices", 0)) == int(n_devices):
        return pl
    pl = derive_placement(prog.plan(), resolve_residency(prog),
                          prog.manifest["geometry"], int(n_devices))
    prog.manifest["placement"] = pl
    return pl


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
class _TileShare:
    """Buffers made from ELL tiles, shared by the partitioned graphs that
    hold the same tile objects (the versions of a live graph share every
    tile a delta did not patch).  An entry is keyed by a name and the ids
    of its source tiles and holds those tiles (strong references), so an
    id cannot be a freed tile's; it counts its holders, and goes when the
    last one releases it.  One share per device (device tensors) and per
    pinning mode (host buffers)."""

    def __init__(self) -> None:
        # Reentrant: a holder collected during a build (its finalizer
        # releases) may run in the thread that holds the lock.
        self._lock = threading.RLock()
        self._entries: Dict[Tuple, list] = {}   # key -> [srcs, value, refs]

    def acquire(self, held: List[Tuple], name: Tuple, srcs: List[Any],
                build=None) -> Any:
        """The buffer ``build()`` makes from ``srcs``, made only if no
        holder has it yet; its key is appended to the caller's ``held``.
        Without ``build``, only an existing buffer is taken (None when
        there is none)."""
        key = name + tuple(id(t) for t in srcs)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if build is None:
                    return None
                e = self._entries[key] = [tuple(srcs), build(), 0]
            e[2] += 1
            held.append(key)
            return e[1]

    def release(self, held: List[Tuple]) -> None:
        """Drop one holder's references (``held`` is emptied)."""
        with self._lock:
            while held:
                key = held.pop()
                e = self._entries[key]
                e[2] -= 1
                if e[2] == 0:
                    del self._entries[key]


_shares: Dict[Any, _TileShare] = {}
_shares_lock = threading.Lock()


def _dev_key(device) -> str:
    """A device's name with its index (``cuda`` is the current CUDA
    device), so that ``cuda`` and ``cuda:0`` key one staging and share."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _tile_share(where) -> _TileShare:
    """The share of a device (:func:`_dev_key`) or a pinning mode."""
    with _shares_lock:
        got = _shares.get(where)
        if got is None:
            got = _shares[where] = _TileShare()
        return got


class _Holder:
    """A holder of :class:`_TileShare` entries: releases them when
    :meth:`release` is called or when it is collected."""

    def __init__(self, share: _TileShare) -> None:
        self._share = share
        self._held: List[Tuple] = []
        fin = weakref.finalize(self, share.release, self._held)
        fin.atexit = False

    def _shared(self, name: Tuple, srcs: List[Any], build=None) -> Any:
        return self._share.acquire(self._held, name, srcs, build)

    def release(self) -> None:
        self._share.release(self._held)


class _Staged(_Holder):
    """The ELL tiles, inverse in-degree and padded weights of one
    partitioned graph on one device.  Tile kinds are uploaded on first
    use, all tiles of a kind at once; a tile another graph on the device
    already holds (the same :class:`ELLTile` object) is not uploaded
    again but shared (:class:`_TileShare`).  Weights are keyed by
    manifest name and re-uploaded only when the caller passes a different
    array.  Densified adjacency blocks of remapped GEMM steps are not
    kept here: each pass densifies from the staged ``cols`` / ``vals``.

    ``uploaded`` counts the bytes of ELL tiles and inverse in-degree this
    graph copied to the device (shared tiles excluded), ``params_uploaded``
    those of the padded weights.

    ``blocks`` (a mesh device's destination row blocks) restricts the
    tiles to those rows: a mesh device stages only the tiles of the
    blocks it owns.  The virtual shards of one device share its copies
    through the device's :class:`_TileShare`.

    ``generation`` is unique to this staging (a replay's key names the
    staging it reads), and ``replays`` holds the captures that read its
    buffers: :meth:`release` drops them."""

    _generations = itertools.count(1)

    def __init__(self, pg, device: torch.device,
                 blocks: Optional[Tuple[int, ...]] = None) -> None:
        super().__init__(_tile_share(_dev_key(device)))
        self.pg, self.device = pg, device
        self.blocks = None if blocks is None else tuple(blocks)
        self.generation = next(self._generations)
        self.replays: "weakref.WeakSet[_Replay]" = weakref.WeakSet()
        self.uploaded = 0
        self.params_uploaded = 0
        self._tiles: Dict[str, Dict[Tuple[int, int, int], torch.Tensor]] = {}
        self._reserved: set = set()     # kinds held by :meth:`reserve`
        self._params: Dict[Tuple, Tuple[Any, torch.Tensor]] = {}
        # Overlays run in their own threads; two that share a program
        # must not upload (or replace) the same entry twice.
        self._lock = threading.RLock()
        self.inv_deg = self._put(np.asarray(pg.inv_in_degree, np.float32))
        self.uploaded += _nbytes(self.inv_deg)

    def _put(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def release(self) -> None:
        for rp in list(self.replays):
            rp.drop()
        super().release()

    def buffers(self) -> list:
        """Every device buffer staged so far (tiles, inverse in-degree,
        weights): what a capture of a pass over this staging reads."""
        with self._lock:
            return [self.inv_deg, dict(self._tiles),
                    [t for _, t in self._params.values()]]

    def kinds(self) -> List[str]:
        """The tile kinds uploaded so far."""
        return sorted(self._tiles)

    def reserve(self, other: "_Staged") -> None:
        """Hold every copy ``other`` holds of a tile this graph also
        holds (same object), for each kind ``other`` uploaded or reserved,
        so that releasing ``other`` leaves them on the device."""
        kinds = set(other.kinds()) | other._reserved
        self._reserved |= kinds
        for kind in sorted(kinds):
            for (j, _), ts in self.pg.tiles.items():
                if self.blocks is None or j in self.blocks:
                    for t in ts:
                        self._shared((kind,), [t])

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
        out = {}
        for (j, k), ts in self.pg.tiles.items():
            if self.blocks is not None and j not in self.blocks:
                continue
            for s, t in enumerate(ts):
                out[(j, k, s)] = self._shared(
                    (kind,), [t], lambda j=j, k=k, s=s: self._upload_one(
                        kind, j, k, s))
        return out

    def _upload_one(self, kind: str, j: int, k: int, s: int) -> torch.Tensor:
        t = self._put(_checked_tile_array(self.pg, kind, j, k, s))
        self.uploaded += _nbytes(t)
        return t

    def param(self, key: Tuple, srcs: Tuple, build) -> torch.Tensor:
        """Device tensor ``build()`` memoized under ``key`` for as long as
        the source arrays ``srcs`` are the same objects."""
        with self._lock:
            hit = self._params.get(key)
            if hit is not None and len(hit[0]) == len(srcs) and all(
                    a is b for a, b in zip(hit[0], srcs)):
                return hit[1]
            t = self._put(build())
            self.params_uploaded += _nbytes(t)
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
    """``kind`` of an ELL tile ``t`` (``cols`` / ``vals`` / ``edge_pos``
    of shape [n1, w]), or of a stack of tiles ([..., n1, w]; graph-as-data
    lanes, which read no live-slot kind)."""
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
    """int32 [..., n1]: 1 + the last live slot of each row (0 for a row
    with no edge).  A last-live index, not a count, so pads between live
    slots stay inside it (they carry vals == 0)."""
    live = np.asarray(edge_pos) >= 0
    last = live.shape[-1] - 1 - np.argmax(live[..., ::-1], axis=-1)
    return np.where(live.any(axis=-1), last + 1, 0).astype(np.int32)


_GD_KINDS = ("cols", "vals", "mask", "epos")


def stack_graph_data(gds, pad_to: int) -> dict:
    """Stack N per-request ``graph_data`` structures (one geometry bucket,
    so one structure) into one with a leading lane axis on every array,
    zero-filling up to ``pad_to`` lanes (numpy).  Zero lanes are inert:
    their mask is False everywhere, so they compute on empty graphs."""
    extra = max(pad_to - len(gds), 0)

    def stack(arrs):
        a = np.stack([np.asarray(x) for x in arrs])
        if extra:
            a = np.concatenate([a, np.zeros((extra,) + a.shape[1:],
                                            a.dtype)])
        return a
    try:
        kinds = {key: set(t) for key, t in gds[0]["tiles"].items()}
        if any({key: set(t) for key, t in g["tiles"].items()} != kinds
               for g in gds[1:]):
            raise ValueError("tile keys or kinds differ between lanes")
        return {"tiles": {key: {kind: stack([g["tiles"][key][kind]
                                             for g in gds])
                                for kind in gds[0]["tiles"][key]}
                          for key in gds[0]["tiles"]},
                "inv_in_degree": stack([g["inv_in_degree"] for g in gds])}
    except (KeyError, TypeError, IndexError, ValueError) as e:
        raise ValueError("graph_data of the lanes must share one "
                         "structure: {'tiles': {'j:k:s': {cols, vals, mask,"
                         f" epos}}}}, 'inv_in_degree'}} ({e!r})") from None


@dataclasses.dataclass
class _TileStack:
    """One canonical tile of every lane: ``cols`` / ``vals`` /
    ``edge_pos`` [N, n1, w] (``edge_pos`` -1 off the mask), read by
    :func:`_tile_array` like a baked tile."""
    cols: np.ndarray
    vals: np.ndarray
    edge_pos: np.ndarray


class _LaneTiles:
    """Graph-as-data: every lane's own ELL tiles in the program's
    canonical layout, in place of the baked ones (one sampled subgraph a
    lane).  ``graph_data`` is the lane-stacked structure of
    :func:`stack_graph_data`::

        {"tiles": {"j:k:s": {"cols": int32 [N, n1, w], "vals": f32,
                             "mask": bool, "epos": int [N, n1, w]}},
         "inv_in_degree": f32 [N, nb * n1]}

    (``epos``: the subgraph's edge id of a slot, read where ``mask``).
    It is checked in full on the host before any launch, since the
    kernels gather h rows at ``cols`` and edge vectors are indexed by
    ``epos`` unchecked.  The kinds of :meth:`_Staged.tiles` the lanes
    read (``cols``, ``vals``, ``mask``, ``row_len``) come from the
    functions that derive the baked tiles' (:func:`_tile_array`); edge
    values move through ``slot_epos`` (int64 [n1, w]: a slot's edge id,
    ``n_edges`` on a pad slot, the trash entry of a lane's edge vector),
    so every kind has a shape the layout fixes.  Each kind is uploaded on
    first use, all lanes and tiles in ONE copy on the current stream, and
    read as per-lane views; :meth:`load` copies another request's lanes
    into those buffers in place (how a replay takes new lanes)."""

    def __init__(self, pg, graph_data: dict, lanes: int,
                 device: torch.device) -> None:
        n1, nb = pg.config.n1, pg.n_blocks
        self.device, self.lanes = device, lanes
        self.n_edges = pg.n_edges
        self.uploaded = 0               # bytes copied to the device
        self.keys = [(j, k, s) for (j, k), ts in sorted(pg.tiles.items())
                     for s in range(len(ts))]
        tiles = graph_data.get("tiles") if isinstance(graph_data, dict) \
            else None
        if not isinstance(tiles, dict):
            raise ValueError("graph_data must be a dict with 'tiles' and "
                             "'inv_in_degree'")
        want = {f"{j}:{k}:{s}" for j, k, s in self.keys}
        if set(tiles) != want:
            raise ValueError(
                "graph_data tiles do not match the program's layout: "
                f"missing {sorted(want - set(tiles))[:4]}, extra "
                f"{sorted(set(tiles) - want)[:4]}")
        self._stack: List[_TileStack] = []
        for j, k, s in self.keys:
            name = f"{j}:{k}:{s}"
            tile = tiles[name]
            if not isinstance(tile, dict) or set(tile) != set(_GD_KINDS):
                raise ValueError(f"graph_data tile {name} must hold "
                                 f"exactly {_GD_KINDS}")
            shape = (lanes,) + tuple(pg.tiles[(j, k)][s].cols.shape)
            got = {kind: np.asarray(tile[kind]) for kind in _GD_KINDS}
            for kind, a in got.items():
                if a.shape != shape:
                    raise ValueError(
                        f"graph_data tile {name} {kind} has shape "
                        f"{a.shape}, expected {shape} (lanes, n1, w)")
            cols = got["cols"].astype(np.int32)
            mask = got["mask"].astype(bool)
            epos = got["epos"].astype(np.int64)
            if cols.size and (cols.min() < 0 or cols.max() >= n1):
                raise ValueError(f"graph_data tile {name} has column "
                                 f"indices outside [0, {n1})")
            live = epos[mask]
            if live.size and (live.min() < 0 or live.max() >= pg.n_edges):
                raise ValueError(f"graph_data tile {name} has edge ids "
                                 f"outside [0, {pg.n_edges}) on live slots")
            self._stack.append(_TileStack(
                cols, got["vals"].astype(np.float32),
                np.where(mask, epos, -1)))
        inv = np.asarray(graph_data.get("inv_in_degree"), np.float32)
        if inv.shape != (lanes, nb * n1):
            raise ValueError(
                f"graph_data inv_in_degree has shape {inv.shape}, expected "
                f"{(lanes, nb * n1)} (lanes, nb * n1)")
        self._inv_host = np.ascontiguousarray(inv)
        self._inv: Optional[torch.Tensor] = None
        self._flat: Dict[str, torch.Tensor] = {}
        self._views: Dict[str, Dict[Tuple[int, int, int], list]] = {}

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.uploaded += _nbytes(t)
        return t

    @property
    def inv_deg(self) -> torch.Tensor:
        """Every lane's inverse in-degree [N, nb * n1]."""
        if self._inv is None:
            self._inv = self._put(self._inv_host)
        return self._inv

    def _kind(self, t: _TileStack, kind: str) -> np.ndarray:
        if kind == "slot_epos":
            return np.where(t.edge_pos >= 0, t.edge_pos, self.n_edges)
        if kind not in ("cols", "vals", "mask", "row_len"):
            raise ValueError(f"graph-as-data lanes have no {kind!r} tiles")
        return _tile_array(t, kind)

    def _host(self, kind: str) -> np.ndarray:
        """``kind`` of every tile and lane back to back (tile-major)."""
        return np.concatenate([self._kind(t, kind).reshape(-1)
                               for t in self._stack])

    def tiles(self, kind: str) -> Dict[Tuple[int, int, int], list]:
        """{(j, k, s): [lane 0's tile, lane 1's, ...]} of ``kind``."""
        got = self._views.get(kind)
        if got is None:
            got = self._views[kind] = self._upload(kind)
        return got

    def _upload(self, kind: str) -> Dict[Tuple[int, int, int], list]:
        flat = self._flat[kind] = self._put(self._host(kind))
        shapes = [self._kind(t, kind).shape[1:] for t in self._stack]
        runs = torch.split(flat, [int(np.prod(sh)) * self.lanes
                                  for sh in shapes])
        return {key: list(r.view((self.lanes,) + tuple(sh)).unbind(0))
                for key, r, sh in zip(self.keys, runs, shapes)}

    def kinds(self) -> List[str]:
        """The kinds uploaded so far (with ``"inv_deg"`` once it is)."""
        return sorted(self._flat) + (["inv_deg"] if self._inv is not None
                                     else [])

    def preload(self, kinds: List[str]) -> None:
        """Upload ``kinds`` (names of :meth:`kinds`) now."""
        for kind in kinds:
            if kind == "inv_deg":
                self.inv_deg
            else:
                self.tiles(kind)

    def load(self, other: "_LaneTiles") -> int:
        """Copy ``other``'s lanes (same program and lane count) into this
        one's uploaded buffers, in place on the current stream; returns
        the bytes copied."""
        n = 0
        for kind, flat in self._flat.items():
            flat.copy_(torch.from_numpy(other._host(kind)))
            n += _nbytes(flat)
        if self._inv is not None:
            self._inv.copy_(torch.from_numpy(other._inv_host))
            n += _nbytes(self._inv)
        return n


_staged_lock = threading.Lock()


def _staged(pg, device: torch.device,
            blocks: Optional[Tuple[int, ...]] = None) -> _Staged:
    """The staging of ``pg`` on ``device`` (restricted to the row
    ``blocks`` a mesh device owns, when given)."""
    key = (_dev_key(device) if blocks is None
           else (_dev_key(device), tuple(blocks)))
    with _staged_lock:
        cache = pg.__dict__.setdefault("_staged", {})
        st = cache.get(key)
        if st is None:
            st = cache[key] = _Staged(pg, device, blocks)
        return st


def inherit_staging(pg, parent) -> None:
    """Stage ``pg`` wherever ``parent`` is staged (each device, each host
    pinning mode), holding every copy of a tile the two graphs share, so
    releasing ``parent`` later frees only its own tiles.  Nothing is
    copied but ``pg``'s inverse in-degree; ``pg``'s own tiles are staged
    on first use.  (How a new live version keeps its parent's copies.)"""
    with _staged_lock:
        devs = list(parent.__dict__.get("_staged", {}).values())
        hosts = list(parent.__dict__.get("_host_tiles", {}).values())
    for st in devs:
        _staged(pg, st.device, st.blocks).reserve(st)
    for ht in hosts:
        _host_tiles(pg, ht.pin).reserve(ht)


def release_staging(pg) -> None:
    """Drop a partitioned graph's device copies (every device) and pinned
    host buffers: the tiles no other graph holds are freed, a shared
    tile's copy stays with the graphs that still hold it.  A later run of
    the graph stages it again.  (The reclaim path of a live version.)"""
    with _staged_lock:
        holders = [*pg.__dict__.pop("_staged", {}).values(),
                   *pg.__dict__.pop("_host_tiles", {}).values()]
    for h in holders:
        h.release()


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


class _HostTiles(_Holder):
    """The ELL tile kinds of one partitioned graph in host memory, for the
    host-streaming path: per destination shard j and kind, ONE flat
    buffer holding every (k, slice) of the shard's row back to back, with
    each slice's (offset, shape).  The buffers are pinned when the
    executor's device is CUDA, so a shard's kind ships in one
    asynchronous copy; they are built on first use of a kind, all shards
    at once, and kept as long as the graph.  Slices start on 16-element
    boundaries (64 bytes for the 4-byte kinds).  A shard's buffer is
    shared (:class:`_TileShare`) with every graph whose row j holds the
    same tile objects; ``nbytes`` counts the host bytes this graph built
    itself (shared rows excluded)."""

    _ALIGN = 16

    def __init__(self, pg, pin: bool) -> None:
        super().__init__(_tile_share(("host", pin)))
        self.pg, self.pin = pg, pin
        self.nbytes = 0                 # host bytes built for this graph
        self._rows: Dict[str, Dict[int, Tuple[torch.Tensor, dict]]] = {}
        self._reserved: set = set()     # kinds held by :meth:`reserve`
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

    def reserve(self, other: "_HostTiles") -> None:
        """Hold every shard buffer ``other`` holds whose row holds the
        same tiles in this graph, so that releasing ``other`` keeps it."""
        pg = self.pg
        kinds = set(other._rows) | other._reserved
        self._reserved |= kinds
        for kind in sorted(kinds):
            for j in range(pg.n_blocks):
                row = _row_tiles(pg, j)
                self._shared((kind, tuple(row)),
                             [pg.tiles[(j, k)][s] for k, s in row])

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
        pg = self.pg
        out = {}
        for j in range(pg.n_blocks):
            row = _row_tiles(pg, j)
            out[j] = self._shared(
                (kind, tuple(row)), [pg.tiles[(j, k)][s] for k, s in row],
                lambda j=j, row=row: self._build_row(kind, j, row))
        return out

    def _build_row(self, kind: str, j: int, row) -> Tuple[torch.Tensor, dict]:
        pg, a = self.pg, self._ALIGN
        index, off = {}, 0
        for k, s in row:
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
        return flat, index


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
    live on the device; a tile is a view of one lane's tensor or of an ELL
    tile.  ELL lookups return one tile per lane: the staged baked tile,
    shared by every lane, or with graph-as-data (``gd``) each lane's
    own."""

    def __init__(self, pg, st: _Staged, lanes: int, h=None, a=None, b=None,
                 ew=None, gd: Optional[_LaneTiles] = None) -> None:
        self.pg, self.st, self.lanes, self.gd = pg, st, lanes, gd
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

    def tiles(self, kind: str, j: int, k: int, s: int
              ) -> List[torch.Tensor]:
        """Every lane's ``kind`` of ELL tile (j, k, s)."""
        if self.gd is not None:
            return self.gd.tiles(kind)[(j, k, s)]
        return [self.st.tiles(kind)[(j, k, s)]] * self.lanes

    def edge_len(self) -> int:
        """Length of a lane's edge vector: ``n_edges``, plus the trash
        entry pad slots write to with graph-as-data lanes."""
        return self.pg.n_edges + (self.gd is not None)

    def gather_edges(self, ew: torch.Tensor, n: int, j: int, k: int,
                     s: int) -> torch.Tensor:
        """Lane n's [n1, w] tile of its edge vector ``ew`` (0 on pad
        slots)."""
        if self.gd is not None:
            key = (j, k, s)
            return torch.where(self.gd.tiles("mask")[key][n],
                               ew[self.gd.tiles("slot_epos")[key][n]], 0.0)
        pos = self.st.tiles("live_pos")[(j, k, s)]
        epos = self.st.tiles("live_epos")[(j, k, s)]
        return _from_live(ew, pos, epos, self.pg.tiles[(j, k)][s].cols.shape)

    def scatter_edges(self, ew: torch.Tensor, n: int, tile: torch.Tensor,
                      j: int, k: int, s: int) -> None:
        """Write lane n's [n1, w] tile of edge values into its edge vector
        ``ew`` at the tile's real edges (each edge lies in one slot)."""
        if self.gd is not None:
            ew[self.gd.tiles("slot_epos")[(j, k, s)][n]] = tile
            return
        pos = self.st.tiles("live_pos")[(j, k, s)]
        ew[self.st.tiles("live_epos")[(j, k, s)]] = tile.reshape(-1)[pos]

    def edge_weight_tiles(self, j: int, k: int, s: int) -> List[torch.Tensor]:
        """Every lane's [n1, w] edge-weight tile (0 on pad slots)."""
        return [self.gather_edges(self.ew[n], n, j, k, s)
                for n in range(self.lanes)]

    def inv_deg_tile(self, j: int) -> List[torch.Tensor]:
        """Every lane's inverse in-degree of row block j."""
        rows = slice(j * self.n1, (j + 1) * self.n1)
        if self.gd is not None:
            return [self.gd.inv_deg[n, rows] for n in range(self.lanes)]
        return [self.st.inv_deg[rows]] * self.lanes


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

    gd = None                           # no graph-as-data on this path

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

    def tiles(self, kind: str, j: int, k: int, s: int
              ) -> List[torch.Tensor]:
        """Every lane's ``kind`` of ELL tile (j, k, s): the staged one."""
        return [self.tile(kind, j, k, s)] * self.lanes

    def edge_weight_tiles(self, j: int, k: int, s: int) -> List[torch.Tensor]:
        """Every lane's [n1, w] edge-weight tile (0 on pad slots)."""
        shape = self.tile("cols", j, k, s).shape
        pos = self.tile("live_pos", j, k, s)
        return [_place(self._slice(("ew", n), "live_epos", k, s), pos, shape)
                for n in range(self.lanes)]

    def inv_deg_tile(self, j: int) -> List[torch.Tensor]:
        return [self.staged[("deg",)]] * self.lanes


class _MeshEnv:
    """Multi-device path, one mesh device ``d`` (one lane): operands are
    the device's placement slabs ``[B*n1, f]`` (B = row blocks a device),
    plus, for a layer with a non-empty halo, the gathered view (the D
    devices' slabs, all on device d).  Block k lives at ``place[k] =
    (device, slot)``: rows ``slot*n1 .. (slot+1)*n1`` of that device's
    slab, so a tile is a view of a slab with the same row stride as the
    device path's padded tensor.  ELL tiles come from the device's own
    staging (``st``, restricted to the blocks it owns)."""

    gd = None                           # no graph-as-data on this path
    lanes = 1

    def __init__(self, pg, st: _Staged, place: Dict[int, Tuple[int, int]],
                 h=None, gathered=None, a=None, b=None, ew=None) -> None:
        self.pg, self.st, self.place = pg, st, place
        self.n1, self.n2 = pg.config.n1, pg.config.n2
        self.h, self.gathered, self.a, self.b = h, gathered, a, b
        self.ew = ew                    # this device's [E] edge vector
        self._h_tiles: Dict[Tuple[int, int], torch.Tensor] = {}

    def _rows(self, k: int) -> slice:
        slot = self.place[k][1]
        return slice(slot * self.n1, (slot + 1) * self.n1)

    def h_tile(self, n: int, k: int, i: int) -> torch.Tensor:
        t = self._h_tiles.get((k, i))
        if t is None:
            src = (self.h if self.gathered is None
                   else self.gathered[self.place[k][0]])
            t = self._h_tiles[(k, i)] = \
                src[self._rows(k), i * self.n2:(i + 1) * self.n2]
        return t

    def operand_tile(self, which: str, n: int, j: int,
                     i: int) -> torch.Tensor:
        arr = self.a if which == "a" else self.b
        return arr[self._rows(j), i * self.n2:(i + 1) * self.n2]

    def tiles(self, kind: str, j: int, k: int, s: int
              ) -> List[torch.Tensor]:
        return [self.st.tiles(kind)[(j, k, s)]]

    def live(self, j: int, k: int, s: int):
        return [(self.st.tiles("live_pos")[(j, k, s)],
                 self.st.tiles("live_epos")[(j, k, s)])]

    def edge_weight_tiles(self, j: int, k: int, s: int) -> List[torch.Tensor]:
        shape = self.pg.tiles[(j, k)][s].cols.shape
        (pos, epos), = self.live(j, k, s)
        return [_from_live(self.ew, pos, epos, shape)]

    def inv_deg_tile(self, j: int) -> List[torch.Tensor]:
        return [self.st.inv_deg[j * self.n1:(j + 1) * self.n1]]


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
        per_lane = env.gd is not None
        nones = [None] * env.lanes
        for ins in tp.compute:           # SPDMM/GEMM steps, stream order
            k, ii = ins.args[1], ins.args[2]
            s, dyn = ins.args[3] >> 1, ins.args[3] & 1
            cols = env.tiles("cols", j, k, s)
            vals = (env.edge_weight_tiles(j, k, s) if dyn
                    else env.tiles("vals", j, k, s))
            if ins.op == Opcode.GEMM:    # remapped dense-aggregate step
                # (SUM/MEAN layers only: remap keeps MAX/MIN on SpDMM.)
                if dyn or per_lane:
                    # per-lane weights or tiles: densify inline, no cache
                    for n in lanes:
                        accs[n] = self.ex.ack.gemm_agg(
                            cols[n], vals[n], env.h_tile(n, k, ii), accs[n])
                else:
                    dense = self._dense_block(j, k, s, cols[0], vals[0])
                    for n in lanes:
                        accs[n] = self.ex.ack.gemm(
                            dense, env.h_tile(n, k, ii), accs[n])
                self.ex.stats.tiles_remapped += 1
                self._op("gemm")
                continue
            mask = env.tiles("mask", j, k, s) if self.extreme else nones
            # Dynamic edge-weight tiles are 0 on pad slots too, so the
            # structural live length serves both.
            row_len = (nones if self.extreme
                       else env.tiles("row_len", j, k, s))
            for n in lanes:
                accs[n], flags[n] = self.ex.ack.spdmm(
                    env.h_tile(n, k, ii), cols[n], vals[n], mask[n], accs[n],
                    flags[n], self.op, row_len[n])
            self._op("spdmm")
        outs = []
        inv_deg = env.inv_deg_tile(j) if self.op == "mean" else nones
        for acc, flag, deg in zip(accs, flags, inv_deg):
            if acc is None:
                acc = self._zeros((n1, n2))
            if self.extreme:
                acc = torch.where(flag[:, None], acc, torch.zeros_like(acc))
            elif self.op == "mean":
                acc = acc * deg[:, None]
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
        cols = env.tiles("cols", j, k, s)
        mask = env.tiles("mask", j, k, s)
        accs = [None] * env.lanes        # None: a zero accumulator
        for ins in tp.compute:           # SDDMM steps: args=(j, k, i, s)
            i = ins.args[2]
            for n in range(env.lanes):
                accs[n] = self.ex.ack.sddmm(env.h_tile(n, j, i),
                                            env.h_tile(n, k, i), cols[n],
                                            mask[n], accs[n],
                                            pair_sum=self.pair)
            self._op("sddmm")
        outs = [self._zeros(cols[0].shape) if a is None else a
                for a in accs]
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


def _on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device while open (a kernel is
    launched on the current device's context); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _mesh_devices(mesh) -> List[torch.device]:
    """The ordered devices of a ``DeviceMesh``."""
    return [torch.device(d) for d in mesh.devices]


def _check_paths(residency: str, graph_data, mesh,
                 device: torch.device) -> None:
    """Refuse an execution path the executor does not run."""
    if residency not in ("device", "host"):
        raise ValueError("residency must be 'device' or 'host', "
                         f"got {residency!r}")
    if mesh is not None:
        if graph_data is not None:
            raise ValueError(
                "graph-as-data execution is device-resident only "
                "(bucketed subgraphs are small by construction)")
        if residency == "host":
            raise ValueError(
                "mesh execution already places shards across devices; "
                "residency='host' does not compose with it")
        devs = _mesh_devices(mesh)
        if not devs or any(d.type != device.type for d in devs):
            raise ValueError(
                f"mesh devices {[str(d) for d in devs]} are not all of "
                f"this executor's device type {device.type!r}")
    if residency == "host" and graph_data is not None:
        raise ValueError(
            "graph-as-data execution is device-resident only "
            "(bucketed subgraphs are small by construction)")


class _Replay:
    """The memo of one replay key: the eager pass's stats and the lane
    kinds it uploaded; once captured, the graph, its static input
    buffers (features, graph-as-data lanes), its output and every staged
    buffer it reads (held, so a weight re-upload cannot free one), and
    ``held_bytes``, the pass's liveness-aware batch bytes (features and
    peak live outputs): an upper bound on the device memory the capture
    keeps.  It is dropped once its executor is gone."""

    def __init__(self, owner, stats: ExecStats,
                 lane_kinds: List[str]) -> None:
        self.owner = weakref.ref(owner)
        self.stats = copy.deepcopy(stats)
        self.lane_kinds = lane_kinds
        self.graph = None
        self.xs: Optional[torch.Tensor] = None
        self.gd: Optional[_LaneTiles] = None
        self.out: Optional[torch.Tensor] = None
        self.reads: Optional[list] = None
        self.launches: Dict[str, int] = {}
        self.held_bytes = 0
        self.dropped = False

    def drop(self) -> None:
        """Forget the capture (its staging is being released, or its
        executor is gone) and free what it holds on the device."""
        self.dropped = True
        self.graph = self.xs = self.gd = self.out = self.reads = None
        self.held_bytes = 0


def _drop_captures(replays: "weakref.WeakSet[_Replay]") -> None:
    """A collected executor's finalizer: free its captures (their memo
    entries are pruned on their program's next replayed run)."""
    for rp in list(replays):
        rp.drop()


_replay_lock = threading.Lock()
_executor_ids = itertools.count()


class BinaryExecutor:
    """Executes a CompiledProgram by interpreting its decoded binary on
    one torch device.

    ``stats`` holds the counters of the most recent :meth:`run` /
    :meth:`run_batch` pass only (reset at entry); ``total`` accumulates
    across the executor's lifetime.

    ``replay`` (on by default) replays device passes on a CUDA device as
    CUDA graphs (see the module docstring); ``False`` runs every pass
    eagerly, the route replays are compared against.  An executor is
    driven by one thread at a time.
    """

    _graph_type = kops.CudaGraph

    def __init__(self, device="cuda", backend: Optional[str] = None,
                 resident_budget_bytes: Optional[int] = None,
                 replay: bool = True) -> None:
        self.device = torch.device(device)
        self.replay = replay
        self._id = next(_executor_ids)
        # This executor's captures (one memory pool while any is alive),
        # dropped when it is collected.
        self._replays: "weakref.WeakSet[_Replay]" = weakref.WeakSet()
        self._pool = None
        weakref.finalize(self, _drop_captures, self._replays).atexit = False
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

    def _held_bytes(self, prog: CompiledProgram) -> int:
        """The device bytes this executor's live captures of ``prog``
        keep (each capture's ``held_bytes``: an upper bound, since
        captures that share the pool reuse each other's intermediates)."""
        with _replay_lock:
            return sum(rp.held_bytes for rp in
                       prog.__dict__.get("_replays", {}).values()
                       if rp.owner() is self)

    def _gate_device_budget(self, prog: CompiledProgram,
                            x_cols: Optional[int], batch: int = 1,
                            held: int = 0, captured: bool = False) -> None:
        """Refuse a run whose liveness-aware peak exceeds
        ``resident_budget_bytes``, naming the first layer step whose live
        set pushes past it.  ``held`` bytes of captures are counted
        beside the pass; a replay of a ``captured`` pass needs nothing
        beyond them."""
        if self.resident_budget_bytes is None:
            return
        budget = self.resident_budget_bytes
        static, x_bytes, live = self._live_profile(prog, x_cols)
        static += held
        if captured:
            live = []
        est = (static + batch * (x_bytes + max(live))) if live else static
        if est <= budget:
            return
        detail = f"; {held} bytes held by captured passes" if held else ""
        over = [t for t, lv in enumerate(live)
                if static + batch * (x_bytes + lv) > budget]
        if over:
            lp = prog.plan().layers[over[0]]
            detail += (f"; first exceeded at layer {lp.layer_id} "
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
                   vals: Dict, edge_vals: Dict, watch: bool = True) -> None:
        """Release every value whose LAST consumer was step ``t`` —
        interval liveness from the manifest's residency table (reported
        to the watermark unless ``watch`` is False)."""
        for d in (vals, edge_vals):
            for lid in [l for l in d
                        if l != sink and last_use.get(l, -1) == t]:
                del d[lid]
                if watch:
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
        _check_paths(residency, graph_data, mesh, self.device)
        if graph_data is not None:
            graph_data = stack_graph_data([graph_data], 1)
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
        ``graph_data`` (lane-stacked, :func:`stack_graph_data`) gives
        each lane its own tiles in the program's layout; it is checked
        before any launch and runs device-resident only.
        On a CUDA device the pass ends by synchronizing the current stream
        (which is when the per-layer CUDA-event times are read).

        ``mesh`` (a :class:`repro_torch.launch.mesh.DeviceMesh` of this
        executor's device type) runs the placement-scheduled multi-device
        path (:meth:`_run_mesh`); its lanes run one after another, each a
        pass of its own, and ``stats`` merge them into one logical pass."""
        _check_paths(residency, graph_data, mesh, self.device)
        xs = torch.as_tensor(xs, dtype=torch.float32)
        if xs.dim() != 3:
            raise ValueError(
                "run_batch expects stacked [N, V, F] features, got shape "
                f"{tuple(xs.shape)}")
        if mesh is not None:
            batch = ExecStats()
            ys = []
            for n in range(int(xs.shape[0])):
                ys.append(self._run_mesh(prog, xs[n], weights, mesh))
                batch.add(self.stats)
            batch.runs = 1              # one logical batched pass
            self.stats = batch
            return torch.stack(ys)
        if residency == "host":
            # Streaming trades latency for footprint: the lanes stream
            # TOGETHER, interleaved per staged shard, so each shard's
            # tile working set ships once for the whole batch.
            return self._run_host(prog, xs, weights)
        lanes = int(xs.shape[0])
        # Request topology is checked in full before any launch.
        gd = (None if graph_data is None else
              _LaneTiles(prog.pgraph, graph_data, lanes, self.device))
        if (self.replay and weights is None
                and self._graph_type.supports(self.device)):
            return self._run_replayed(prog, xs, gd)
        self._gate_device_budget(prog, int(xs.shape[2]), batch=lanes,
                                 held=self._held_bytes(prog))
        return self._run_device(prog, xs.to(self.device), weights, gd)

    def _run_replayed(self, prog: CompiledProgram, xs: torch.Tensor,
                      gd: Optional[_LaneTiles]) -> torch.Tensor:
        """The device pass memoized on ``prog`` (module docstring): run
        eagerly until a pass stages nothing (the first pass on a staging
        uploads its tiles and weights), captured the next time, replayed
        from then on.  A capture or replay that fails raises; nothing
        falls back to the eager route."""
        dev = _dev_key(self.device)
        with _staged_lock:      # looked up, not made: a refused run stages
            st = prog.pgraph.__dict__.get("_staged", {}).get(dev)
        base = (tuple(xs.shape), str(xs.dtype), gd is not None,
                self.ack.backend, dev)
        with _replay_lock:
            memo = prog.__dict__.setdefault("_replays", {})
            for k in [k for k, r in memo.items()
                      if r.dropped or r.owner() is None]:
                del memo[k]
            rp = (None if st is None else
                  memo.get(base + (st.generation, self._id)))
        # Gated on every call, replays included (a replay runs no Python
        # of the pass), at batch scale, beside what the captures hold.
        self._gate_device_budget(
            prog, int(xs.shape[2]), batch=int(xs.shape[0]),
            held=self._held_bytes(prog),
            captured=rp is not None and rp.graph is not None)
        if rp is None:
            st = _staged(prog.pgraph, self.device)
            key = base + (st.generation, self._id)
            up0 = st.uploaded + st.params_uploaded
            y = self._run_device(prog, xs.to(self.device), None, gd)
            if st.uploaded + st.params_uploaded == up0:
                # A pass that staged nothing: its stats (per-layer times
                # without uploads) are what its replays report.
                rp = _Replay(self, self.stats,
                             gd.kinds() if gd is not None else [])
                with _replay_lock:
                    memo[key] = rp
                    st.replays.add(rp)
                    self._replays.add(rp)
            return y
        if rp.graph is None:
            self._capture(rp, prog, xs, gd, st)
        return self._replay(rp, xs, gd)

    def _capture(self, rp: _Replay, prog: CompiledProgram,
                 xs: torch.Tensor, gd: Optional[_LaneTiles],
                 st: _Staged) -> None:
        """Capture the device pass over static copies of ``xs`` and of
        ``gd``'s buffers.  Everything the pass uploads was uploaded by
        the eager pass on this staging, or is uploaded here first."""
        rp.xs = torch.empty(xs.shape, dtype=torch.float32,
                            device=self.device)
        if gd is not None:
            gd.preload(rp.lane_kinds)
            rp.gd = gd
        rp.reads = st.buffers()
        # A pool lives while a graph captured into it does: hold one of
        # them through the capture (a release in another thread may drop
        # it), or start a new pool when none is left.
        anchor = next((r.graph for r in list(self._replays)
                       if r.graph is not None), None)
        if anchor is None:
            self._pool = self._graph_type.new_pool(self.device)
        graph = self._graph_type(self.device, self._pool)
        with kops.capturing() as launched:
            rp.out = graph.capture(lambda: self._run_device(
                prog, rp.xs, None, rp.gd, eager=False))
        del anchor
        rp.launches = dict(launched)
        rp.graph = graph
        _, x_bytes, live = self._live_profile(prog, int(xs.shape[2]))
        rp.held_bytes = (int(xs.shape[0]) * (x_bytes + max(live, default=0))
                         + (gd.uploaded if gd is not None else 0))

    def _replay(self, rp: _Replay, xs: torch.Tensor,
                gd: Optional[_LaneTiles]) -> torch.Tensor:
        """Copy the call's inputs into the capture's buffers, replay it,
        and hand back a copy of its output (the next replay overwrites
        the graph's own); ``stats`` are the eager pass's."""
        rp.xs.copy_(xs)
        if gd is None:
            copied = 0
        elif gd is rp.gd:              # the capturing call's own lanes
            copied = gd.uploaded
        else:
            copied = rp.gd.load(gd)
        with get_tracer().span("replay", cat="exec", track="exec:device",
                               args={"lanes": int(xs.shape[0])}):
            rp.graph.replay()
            kops.note_replay(rp.launches)
            y = rp.out.clone()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats = copy.deepcopy(rp.stats)
        self.stats.h2d_bytes = copied
        self.total.add(self.stats)
        return y

    def _run_device(self, prog: CompiledProgram, xs: torch.Tensor,
                    weights, gd: Optional[_LaneTiles],
                    eager: bool = True) -> torch.Tensor:
        """One device-resident pass over the device tensor ``xs``.
        ``eager=False`` is the pass a capture records: no host clock,
        profile, span or liveness hook, and no synchronize."""
        lanes = int(xs.shape[0])
        self.stats = ExecStats(runs=1)
        self._note_skips(prog)
        tracer = get_tracer() if eager else NullTracer()
        if eager:
            self._begin_profile()
        else:
            self._tile_records = None
        with tracer.span("decode", cat="exec", track="exec:device",
                         args={"cached": prog._plan is not None}):
            plan = prog.plan()
        man = prog.manifest
        pg = prog.pgraph
        st = _staged(pg, self.device)
        up0 = st.uploaded + st.params_uploaded
        last_use = {int(k): v for k, v in
                    resolve_residency(prog)["last_use"].items()}
        weights = weights if weights is not None else prog.weights
        lmeta = man["layers"]
        n1, n2, nb = pg.config.n1, pg.config.n2, pg.n_blocks
        vp = nb * n1
        nv = pg.n_vertices
        clock = _LayerClock(self.device if eager else torch.device("cpu"))

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
                    lp, pg, st, edge_vals[feat_parents[0]], gd)
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
                                 b=io.get("b"), ew=io["ew"], gd=gd)
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
            if eager:
                self._watermark("alloc", lp.layer_id, vals, edge_vals)
            # Interval liveness: drop outputs whose last consumer just
            # ran, so peak memory follows the live-set, not model depth.
            self._free_dead(t, sink, last_use, vals, edge_vals,
                            watch=eager)

        if not eager:
            return vals[sink][:, :nv, :man["sink_f_out"]]
        if clock.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        for rec in self.stats.per_layer or []:
            rec["wall_s"] = _LayerClock.seconds(rec["wall_s"])
        self.stats.h2d_bytes = (st.uploaded + st.params_uploaded - up0
                                + (gd.uploaded if gd else 0))
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
        ew = torch.zeros((env.lanes, env.edge_len()), dtype=torch.float32,
                         device=self.device)
        for tp in self._block_order(lp):
            self._profile_tile(kern, tp)
            for n, acc in enumerate(kern.tile(tp, env)):
                env.scatter_edges(ew[n], n, acc, tp.out_j, tp.tile_k,
                                  tp.slice_id)
        if kern.softmax:
            ew = self._edge_softmax(pg, st, ew, env.gd)
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

    def _edge_softmax(self, pg, st: _Staged, ew_in,
                      gd: Optional[_LaneTiles] = None,
                      blocks: Optional[List[int]] = None) -> torch.Tensor:
        """EDGE_SOFTMAX of every lane's [E] scores in the two-pass tile
        scheme (max/sum accumulated per destination row across a shard's
        tiles, the Activation Unit's exp/divide applied per tile); one
        tile op per tile and traversal.  ``blocks`` restricts it to those
        destination rows (a mesh device's own; the others stay 0)."""
        lanes = ew_in.shape[0]
        env = _DeviceEnv(pg, st, lanes, gd=gd)
        ew = torch.zeros((lanes, env.edge_len()), dtype=torch.float32,
                         device=st.device)
        for j in (range(pg.n_blocks) if blocks is None else blocks):
            row_tiles = _row_tiles(pg, j)
            if not row_tiles:
                continue
            masks = [env.tiles("mask", j, k, s) for k, s in row_tiles]
            self.stats.tile_ops += len(row_tiles)
            for n in range(lanes):
                scored = [(env.gather_edges(ew_in[n], n, j, k, s), m[n])
                          for (k, s), m in zip(row_tiles, masks)]
                for (k, s), out_t in zip(row_tiles,
                                         self._edge_softmax_rows(scored)):
                    env.scatter_edges(ew[n], n, out_t, j, k, s)
        return ew

    def _run_edge_act(self, lp, pg, st: _Staged, ew_in,
                      gd: Optional[_LaneTiles] = None) -> torch.Tensor:
        """Standalone edge activation of every lane's [E] scores."""
        act = Activation(lp.mode)
        if act == Activation.EDGE_SOFTMAX:
            return self._edge_softmax(pg, st, ew_in, gd)
        self.stats.tile_ops += len(lp.tiles)
        return torch.stack([apply_activation(ew_in[n], act)
                            for n in range(ew_in.shape[0])])

    # ------------------------------------------------------------------ #
    # Multi-device placement execution.
    #
    # The placement schedule assigns destination row blocks to the mesh's
    # devices; each layer's output lives block-permuted as one [B*n1, f]
    # slab per device (B = the most blocks a device owns; a device that
    # owns fewer has zero rows at its last slots, which no block maps
    # to).  Each layer: (1) if its halo sets are non-empty (AGGREGATE and
    # VECTOR_INNER layers read other devices' blocks), the parent slabs
    # are exchanged: every device gets the D slabs on itself
    # (:meth:`_mesh_exchange`); (2) every device runs ITS OWN shard order
    # through the same shard kernels and hand kernels as the device path,
    # on views with the same row stride.  Each output tile sees the same
    # kernel, the same operand values and the same within-tile order as on
    # the device path (only the order of whole blocks changes), so the
    # result is bit-identical to it.  One process issues every device's
    # work in turn, lane after lane.
    # ------------------------------------------------------------------ #
    def _mesh_exchange(self, slabs: List[torch.Tensor],
                       devs: List[torch.device], layer: int,
                       est_bytes: int):
        """Halo exchange: for each device, the D devices' slabs on that
        device (``Tensor.to``: a peer copy between distinct cards, none
        within one device), built once per distinct device.  Returns (the
        gathered view of every mesh device, its pending ``halo_exchange``
        span).  The span carries the gathered volume ``bytes`` (D * B*n1 *
        f * 4, JAX's all_gather), ``copied_bytes`` (what crossed between
        distinct devices) and the compile-time targeted-halo estimate
        ``est_bytes``; on CUDA, when tracing is on, the copies' device
        time is added as ``copy_us`` once the run has synchronized."""
        D = len(slabs)
        rows, width = int(slabs[0].shape[0]), int(slabs[0].shape[1])
        t0 = time.perf_counter_ns()
        timed = get_tracer().enabled and devs[0].type == "cuda"
        views: Dict[str, List[torch.Tensor]] = {}
        events, copied = [], 0
        for dev in devs:
            if str(dev) in views:
                continue
            with _on_device(dev):
                start = torch.cuda.Event(enable_timing=True) if timed \
                    else None
                if start is not None:
                    start.record()
                views[str(dev)] = [s.to(dev, non_blocking=True)
                                   for s in slabs]
                if start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    events.append((start, end))
            copied += sum(_nbytes(s) for s in slabs if s.device != dev)
        span = (t0, time.perf_counter_ns(),
                {"devices": D, "bytes": D * rows * width * 4,
                 "copied_bytes": copied, "layer": layer,
                 "est_bytes": est_bytes}, events)
        return [views[str(dev)] for dev in devs], span

    @staticmethod
    def _halo_done(span) -> None:
        """Emit a ``halo_exchange`` span from :meth:`_mesh_exchange`, with
        its copies' device time when they were timed (after the run's
        synchronize)."""
        t0, t1, args, events = span
        if events:
            args["copy_us"] = sum(a.elapsed_time(b) for a, b in events) * 1e3
        get_tracer().complete("halo_exchange", t0, t1, cat="comm",
                              args=args, track="halo")

    def _run_mesh(self, prog: CompiledProgram, x: torch.Tensor,
                  weights: Optional[Dict[str, Any]], mesh) -> torch.Tensor:
        """One lane ``x`` ([V, F]) through the placement-scheduled path on
        the mesh's devices; returns the sink's [V, f_out] output on the
        first mesh device."""
        devs = _mesh_devices(mesh)
        D = len(devs)
        tracer = get_tracer()
        self._begin_profile()
        pl = ensure_placement(prog, D)
        with tracer.span("decode", cat="exec", track="exec:dev0",
                         args={"cached": prog._plan is not None,
                               "devices": D}):
            plan = prog.plan()
        man = prog.manifest
        pg = prog.pgraph
        last_use = {int(k): v for k, v in
                    resolve_residency(prog)["last_use"].items()}
        wts = weights if weights is not None else prog.weights
        lmeta = man["layers"]
        n1, n2, nb = pg.config.n1, pg.config.n2, pg.n_blocks
        nv = pg.n_vertices
        sink = man["sink"]

        owned: List[List[int]] = [[] for _ in range(D)]
        for j, d in enumerate(pl["assignment"]):
            owned[int(d)].append(j)
        B = max(1, max(len(o) for o in owned))
        place = {j: (d, s) for d in range(D)
                 for s, j in enumerate(owned[d])}
        # Each device's staging holds the tiles of its own blocks; the
        # first staging on a device also holds the padded weights, which
        # the virtual shards of that device share.
        sts = [_staged(pg, dev, tuple(owned[d]))
               for d, dev in enumerate(devs)]
        param_st: Dict[str, _Staged] = {}
        for dev, st in zip(devs, sts):
            param_st.setdefault(str(dev), st)
        stagings = list({id(st): st for st in sts}.values())
        up0 = sum(st.uploaded + st.params_uploaded for st in stagings)
        one_device = len({str(dev) for dev in devs}) == 1
        # Per-layer times: CUDA events when every shard is on one card
        # (one stream holds all the work), host issue time otherwise.
        clock = _LayerClock(devs[0] if one_device else torch.device("cpu"))

        fin_pad0 = ((max(plan.layers[0].f_in, 1) + n2 - 1) // n2) * n2
        xw = max(fin_pad0, ((x.shape[1] + n2 - 1) // n2) * n2)
        x_slabs: Optional[List[torch.Tensor]] = []
        for d, dev in enumerate(devs):
            slab = torch.zeros((B * n1, xw), dtype=torch.float32,
                               device=dev)
            for s, j in enumerate(owned[d]):
                blk = x[j * n1:(j + 1) * n1]
                slab[s * n1:s * n1 + blk.shape[0], : blk.shape[1]] = \
                    blk.to(dev)
            x_slabs.append(slab)

        self.stats = ExecStats(runs=1, n_devices=D)
        self._note_skips(prog)
        per_dev = [{"device": d, "tile_ops": 0, "shards": 0,
                    "halo_bytes": 0, "blocks": len(owned[d])}
                   for d in range(D)]
        peak_dev = 0
        halo_spans = []
        vals: Dict[int, List[torch.Tensor]] = {}       # layer -> slabs
        edge_vals: Dict[int, List[torch.Tensor]] = {}  # layer -> [E] each

        for t, lp in enumerate(plan.layers):
            meta = lmeta[str(lp.layer_id)]
            self.stats.layers += 1
            ewl = meta.get("edge_weight_layer")
            feat_parents = [p for p in meta["parents"] if p != ewl]
            lt = lp.layer_type
            pll = pl["layers"][str(lp.layer_id)]
            gath_bytes = 0
            t0 = clock.start()
            ops0 = self.stats.tile_ops

            if lt in (LayerType.ACTIVATION, LayerType.BATCHNORM) \
                    and lp.on_edges:
                edge_vals[lp.layer_id] = self._mesh_edge_act(
                    lp, pg, sts, edge_vals[feat_parents[0]], owned,
                    per_dev, t)
            else:
                by_j: Dict[int, List[TilePlan]] = {}
                for tp in self._block_order(lp):
                    by_j.setdefault(tp.out_j, []).append(tp)
                parents = (vals.get(feat_parents[0], x_slabs)
                           if feat_parents else x_slabs)
                gathered = None
                if lt in (LayerType.AGGREGATE, LayerType.VECTOR_INNER) \
                        and any(pll["halo"][str(d)] for d in range(D)):
                    est = sum(pll["halo_bytes"].get(str(d), 0)
                              for d in range(D))
                    gathered, hspan = self._mesh_exchange(
                        parents, devs, int(lp.layer_id), est)
                    halo_spans.append(hspan)
                    gath_bytes = hspan[2]["bytes"]
                    self.stats.halo_gather_bytes += gath_bytes
                    for d in range(D):
                        per_dev[d]["halo_bytes"] += \
                            pll["halo_bytes"].get(str(d), 0)
                if lt == LayerType.VECTOR_ADD:
                    a_id, b_id = meta["operands"]
                    ops_a = x_slabs if a_id == -1 else vals[a_id]
                    ops_b = x_slabs if b_id == -1 else vals[b_id]
                else:
                    ops_a = ops_b = None
                kerns: Dict[str, _ShardKernel] = {}
                outs: List[torch.Tensor] = []
                for d, dev in enumerate(devs):
                    before = self.stats.tile_ops
                    dspan = tracer.span(
                        f"layer{lp.layer_id}", cat="exec",
                        track=f"exec:dev{d}",
                        args={"type": LayerType(lt).name,
                              "kernel": _KERNEL_MODES[lt], "step": t,
                              "instr_lo": lp.instr_lo,
                              "instr_hi": lp.instr_hi})
                    kern = kerns.get(str(dev))
                    if kern is None:
                        kern = kerns[str(dev)] = self._make_kernel(
                            lp, meta, pg, wts, param_st[str(dev)])
                    env = _MeshEnv(
                        pg, sts[d], place, h=parents[d],
                        gathered=gathered[d] if gathered else None,
                        a=ops_a[d] if ops_a is not None else None,
                        b=ops_b[d] if ops_b is not None else None,
                        ew=edge_vals[ewl][d] if ewl is not None else None)
                    order = [j for j in pll["order"][str(d)] if j in by_j]
                    seen = set(order)
                    order += [j for j in owned[d]
                              if j in by_j and j not in seen]
                    io = ({} if ops_a is None else
                          {"a": ops_a[d][None], "b": ops_b[d][None]})
                    with _on_device(dev):
                        outs.append(self._mesh_layer(
                            kern, env, by_j, order, owned[d], B, io))
                    per_dev[d]["shards"] += len(order)
                    per_dev[d]["tile_ops"] += self.stats.tile_ops - before
                    dspan.add(tile_ops=self.stats.tile_ops - before).done()
                if kern.edge_valued:
                    edge_vals[lp.layer_id] = outs
                else:
                    vals[lp.layer_id] = outs
            self.stats.note_layer(
                layer=int(lp.layer_id), kernel=_KERNEL_MODES[lt],
                step=t, instr_lo=lp.instr_lo, instr_hi=lp.instr_hi,
                wall_s=clock.stop(t0),
                tile_ops=self.stats.tile_ops - ops0,
                halo_gather_bytes=gath_bytes)
            live = sum(_nbytes(a) for dd in (vals, edge_vals)
                       for a in dd.values())
            peak_dev = max(peak_dev, live // D + gath_bytes)
            self._watermark("alloc", lp.layer_id, vals, edge_vals)
            self._free_dead(t, sink, last_use, vals, edge_vals)
            if last_use.get(-1, -1) == t:
                x_slabs = None          # the input's last consumer has run

        # The sink, gathered back in block order on the first device.
        first = devs[0]
        sink_slabs = vals[sink]
        out = torch.empty((nb * n1, int(sink_slabs[0].shape[1])),
                          dtype=torch.float32, device=first)
        for j in range(nb):
            d, s = place[j]
            out[j * n1:(j + 1) * n1] = \
                sink_slabs[d][s * n1:(s + 1) * n1].to(first)
        if first.type == "cuda":
            for dev in {str(dev): dev for dev in devs}.values():
                torch.cuda.current_stream(dev).synchronize()
        for rec in self.stats.per_layer or []:
            rec["wall_s"] = _LayerClock.seconds(rec["wall_s"])
        for hspan in halo_spans:
            self._halo_done(hspan)
        self.stats.per_device = per_dev
        self.stats.halo_bytes = sum(d["halo_bytes"] for d in per_dev)
        self.stats.peak_device_bytes = peak_dev
        self.stats.h2d_bytes = sum(st.uploaded + st.params_uploaded
                                   for st in stagings) - up0
        self._flush_profile(prog)
        self.total.add(self.stats)
        return out[:nv, : man["sink_f_out"]]

    def _mesh_layer(self, kern: _ShardKernel, env: _MeshEnv, by_j, order,
                    owned: List[int], B: int, io: dict) -> torch.Tensor:
        """One device's part of a layer: its shards in ``order``, into a
        fresh slab ``[B*n1, w]`` (a feature layer; ``io`` holds a vector
        add's operands, which size it) or [E] edge vector (an edge-valued
        layer, each tile's scores scattered to the edge ids of its live
        slots)."""
        pg, st, n1, n2 = env.pg, env.st, env.n1, env.n2
        if kern.edge_valued:
            ew = torch.zeros((pg.n_edges,), dtype=torch.float32,
                             device=st.device)
            for j in order:
                for tp in by_j[j]:
                    self._profile_tile(kern, tp)
                    acc, = kern.tile(tp, env)
                    (pos, epos), = env.live(tp.out_j, tp.tile_k,
                                            tp.slice_id)
                    ew[epos] = acc.reshape(-1)[pos]
            if kern.softmax:
                ew = self._edge_softmax(pg, st, ew[None], blocks=owned)[0]
            return ew
        out = torch.empty((B * n1, kern.out_width(io)), dtype=torch.float32,
                          device=st.device)
        for s in range(B):
            if s >= len(owned) or owned[s] not in by_j:
                out[s * n1:(s + 1) * n1].zero_()
        for j in order:
            rows = env._rows(j)
            for tp in by_j[j]:
                self._profile_tile(kern, tp)
                v, = kern.tile(tp, env)
                out[rows, tp.out_i * n2:(tp.out_i + 1) * n2] = v
        return out

    def _mesh_edge_act(self, lp, pg, sts: List[_Staged],
                       ew_slabs: List[torch.Tensor], owned, per_dev,
                       step: int) -> List[torch.Tensor]:
        """Edge activations on the devices' [E] score vectors.  Softmax
        rows are destination-local under the placement (a row's tiles
        live with the device that owns the row block), so each device
        normalizes its own rows with the device path's row math and no
        exchange is needed."""
        act = Activation(lp.mode)
        outs = []
        for d, ew_in in enumerate(ew_slabs):
            before = self.stats.tile_ops
            span = get_tracer().span(
                f"layer{lp.layer_id}", cat="exec", track=f"exec:dev{d}",
                args={"type": LayerType(lp.layer_type).name,
                      "kernel": _KERNEL_MODES[lp.layer_type],
                      "step": step, "instr_lo": lp.instr_lo,
                      "instr_hi": lp.instr_hi})
            with _on_device(sts[d].device):
                if act == Activation.EDGE_SOFTMAX:
                    rows = [j for j in owned[d] if _row_tiles(pg, j)]
                    outs.append(self._edge_softmax(
                        pg, sts[d], ew_in[None], blocks=rows)[0])
                    per_dev[d]["shards"] += len(rows)
                else:
                    # One op per tile, credited to the tile's owning
                    # device, so the per-device ops sum to the pass's.
                    mine = set(owned[d])
                    self.stats.tile_ops += sum(1 for tp in lp.tiles
                                               if tp.out_j in mine)
                    outs.append(apply_activation(ew_in, act))
            per_dev[d]["tile_ops"] += self.stats.tile_ops - before
            span.add(tile_ops=self.stats.tile_ops - before).done()
        return outs

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
        the event closing its copies or None, its pending stage span or
        None).  ``span_args`` (``shard``, ``layer``) land on the span.

        The span's host duration is how long the copies took to issue.
        On a CUDA device, when tracing is on, a timing event pair on the
        copy stream brackets the copies, and the span is emitted by
        :meth:`_stage_done` once the host has synchronized past them,
        with their device time as ``copy_us``: the link's time, which
        ``obs.conformance.fit_stage_bw`` fits."""
        tracer = get_tracer()
        t0 = time.perf_counter_ns()
        nbytes = sum(_nbytes(a) for a in arrs.values())
        ready = start = None
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            timed = tracer.enabled
            with torch.cuda.stream(self._copy_stream):
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(self._copy_stream)
                staged = {k: a.to(self.device, non_blocking=True)
                          for k, a in arrs.items()}
                ready = torch.cuda.Event(enable_timing=timed)
                ready.record(self._copy_stream)
            for t in staged.values():
                t.record_stream(compute)
        else:
            staged = {k: a.clone() for k, a in arrs.items()}
        self.stats.h2d_bytes += nbytes
        span = (tracer, t0, time.perf_counter_ns(),
                dict(span_args, bytes=nbytes, arrays=len(arrs)), start, ready)
        if start is None:
            self._stage_done(span)
            span = None
        return staged, nbytes, ready, span

    @staticmethod
    def _stage_done(span) -> None:
        """Emit a stage span from :meth:`_stage`, with its copies' device
        time when they were timed (the host has synchronized past them)."""
        if span is None:
            return
        tracer, t0, t1, args, start, ready = span
        if start is not None:
            args["copy_us"] = start.elapsed_time(ready) * 1e3
        tracer.complete("stage", t0, t1, cat="h2d", args=args, track="h2d")

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
            staged, cur_bytes, ready, stage_span = nxt
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
            self._stage_done(stage_span)  # ... after its copies
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
        staged, nbytes, ready, span = self._stage({("ew",): ew_in})
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
        self._stage_done(span)
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
            staged, nbytes, ready, span = self._stage(arrs, shard=int(j))
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
            self._stage_done(span)
            ids = torch.cat([_slice_of(epos, *index[ks])
                             for ks in row_tiles])
            for n, b in enumerate(bufs):
                out[n, ids] = b
            self.stats.shards_streamed += 1
        return out
