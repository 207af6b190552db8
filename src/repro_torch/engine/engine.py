"""The GraphAGILE engine on torch — the port's public entry point.

    from repro_torch.engine import Engine

    engine = Engine()                           # one overlay on "cuda"
    prog = engine.compile("b2", graph)          # -> CompiledProgram
    y = engine.run(prog, x)                     # executes the 128-bit binary
    prog.save("gcn_flickr.gagi")                # binary + manifest bundle
    y2 = engine.run(engine.load("gcn_flickr.gagi"), x)

One ``Engine`` is one overlay instance on one torch device: a fixed
tile-geometry contract plus the ACK kernels.  Compiling a new model or a
new graph changes the instruction binary only, never the kernels.
``engine.submit(request)`` / ``engine.serve(requests)`` run a streaming
loop with an LRU program cache keyed by (model schema hash, graph
partition signature, geometry): repeated (model, graph) pairs skip
compilation and report ``T_LoC == 0``.  ``engine.submit_batch(requests)``
serves N requests of one cache key with ONE binary pass (``run_batch``);
batched, multi-overlay serving is :mod:`repro_torch.runtime`.

On a CUDA device each Engine issues its work on a CUDA stream of its own,
and ``T_LoH`` is read after that stream has finished, so two engines on
one card (the runtime's overlays, each in its own thread) overlap and do
not time each other's work.  The engine's stream first waits for what the
caller's current stream has queued (it may still be writing the features
or weights), and every output handed back is recorded on the caller's
stream, so the caller may use and free it there.

On a CUDA device a repeated device-resident pass (same program, batch
shape and staging) is replayed as a CUDA graph, the counterpart of the
JAX engine's memoized ``jit(vmap(run))`` (see
:mod:`repro_torch.engine.executor`); ``submit_batch`` pads a batch to the
next power of two lanes, as JAX does, so ragged batches reuse captures.
``Engine(replay=False)`` runs every pass eagerly: the route replays are
held against.

The device defaults to ``"cuda"`` and there is no silent CPU fallback:
without a CUDA device the constructor raises, and CPU execution (what the
tests use) has to be asked for with ``device="cpu"``.  The cache key and
the compiled binary are the same as the JAX package's for the same inputs.

Live graphs (:mod:`repro_torch.livegraph`): a request's graph may be a
``LiveGraphServer`` handle or a version's materialized graph.  The cache
key is then the version's structural signature, so a content-only delta
reuses the compiled program, rebound to the version's patched tiles;
``submit`` / ``submit_batch`` pin the version active at admission until
the request completes.  ``Engine(verify=True)`` (or the ``REPRO_VERIFY``
environment variable) statically verifies every fresh compile and every
live rebind (:mod:`repro_torch.verify`), and ``GAGI_EXPORT_DIR`` saves
every fresh compile as a ``.gagi`` bundle there: the JAX package's
switches, under the same names.

Meshes: ``compile(..., mesh=D)`` records the placement schedule for D
devices in the manifest, and ``run`` / ``run_batch(..., mesh=...)`` run
the placement-scheduled multi-device path.  ``mesh`` is a device count
(the first D devices of the engine's device type,
:func:`repro_torch.launch.mesh.make_device_mesh`) or a
:class:`repro_torch.launch.mesh.DeviceMesh`, which may repeat a device
(virtual shards: ``DeviceMesh(["cuda:0"] * 4)`` on one card,
``DeviceMesh(["cpu"] * 4)`` on the CPU).  One process drives every mesh
device and the output comes back on the first one, bit for bit the
device path's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import re
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.compiler import CompileOptions, run_pipeline
from repro_torch.core.gnn_builders import build
from repro_torch.core.graph import Graph
from repro_torch.core.ir import ModelIR
from repro_torch.core.passes.partition import PartitionConfig
from repro_torch.obs.tracer import get_tracer

from .cache import LRUCache
from .executor import (BinaryExecutor, ExecStats, ensure_placement,
                       stack_graph_data)
from .program import CompiledProgram, from_program

ModelSpec = Union[str, ModelIR]


def _env_verify_default() -> bool:
    """Process default for ``Engine(verify=...)``: the ``REPRO_VERIFY``
    environment variable (the JAX package's switch)."""
    return os.environ.get("REPRO_VERIFY", "0").lower() in (
        "1", "true", "yes", "on")


def _export_gagi(prog: CompiledProgram) -> None:
    """``GAGI_EXPORT_DIR``: save every freshly compiled program there as a
    ``.gagi`` bundle (the corpus ``python -m repro_torch.verify`` reads)."""
    out = os.environ.get("GAGI_EXPORT_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                  f"{prog.model_name}-{prog.graph_name}")
    prog.save(os.path.join(
        out, f"{stem}-{prog.cache_key[:8] or 'nokey'}.gagi"))


def _mesh_count(mesh) -> Optional[int]:
    """Device count of the ``mesh`` knob (int, DeviceMesh, or None): what
    ``compile`` needs for a placement schedule; no device is touched."""
    if mesh is None:
        return None
    return int(mesh) if isinstance(mesh, int) else int(mesh.size)


# --------------------------------------------------------------------------- #
# Cache-key signatures (the same strings the JAX package computes).
# --------------------------------------------------------------------------- #
def _live_version_of(graph):
    """The :class:`repro_torch.livegraph.GraphVersion` a graph-ish object
    denotes, or ``None``.  Duck-typed (no livegraph import): a
    ``LiveGraphServer`` handle carries ``_live_server`` and resolves to
    its *active* version; a version's materialized graph carries
    ``_live_version``."""
    server = getattr(graph, "_live_server", None)
    if server is not None:
        return server.active
    return getattr(graph, "_live_version", None)


def graph_signature(g: Graph) -> str:
    """Partition signature of a graph: topology plus feat_dim/n_classes,
    which size the layers of builder-constructed models.  The O(|E|) hash
    over the edge arrays is memoized on the graph object, keyed by the
    array objects themselves plus the graph's ``mutation_token``.

    Live-versioned graphs return their *structural* signature instead
    (tile-grid geometry and the (j, k, n_slices) tile structure, all the
    binary depends on), so a content-only delta keeps the program-cache
    key."""
    lv = _live_version_of(g)
    if lv is not None:
        return lv.structural_signature
    token = getattr(g, "mutation_token", 0)
    cached = g.__dict__.get("_edge_digest")
    if (cached is None or cached[0] is not g.src
            or cached[1] is not g.dst or cached[2] is not g.weight
            or cached[3] != token):
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(g.src).tobytes())
        h.update(np.ascontiguousarray(g.dst).tobytes())
        h.update(np.ascontiguousarray(g.weight).tobytes())
        cached = (g.src, g.dst, g.weight, token, h.hexdigest())
        g.__dict__["_edge_digest"] = cached
    scalars = f"{g.n_vertices}:{g.n_edges}:{g.feat_dim}:{g.n_classes}"
    return hashlib.sha1(f"{scalars}|{cached[4]}".encode()).hexdigest()


def _weight_digest(model: ModelIR) -> str:
    """SHA-1 over weight contents, memoized on the model keyed by the
    array objects themselves (rebinding an entry invalidates the memo)."""
    names = tuple(sorted(model.weights))
    cached = model.__dict__.get("_weight_digest")
    if (cached is None or cached[0] != names
            or any(a is not model.weights[n]
                   for n, a in zip(names, cached[1]))):
        h = hashlib.sha1()
        for name in names:
            w = np.asarray(model.weights[name])
            h.update(name.encode())
            h.update(repr((w.shape, str(w.dtype))).encode())
            h.update(w.tobytes())
        cached = (names, tuple(model.weights[n] for n in names),
                  h.hexdigest())
        model.__dict__["_weight_digest"] = cached
    return cached[2]


def model_signature(model: ModelSpec, seed: int = 0) -> str:
    """Schema hash of a model: layer DAG + weight contents."""
    if isinstance(model, str):
        return f"bench:{model}:seed{seed}"
    h = hashlib.sha1()
    h.update(model.name.encode())
    for lid in sorted(model.layers):
        l = model.layers[lid]
        h.update(repr((
            lid, int(l.layer_type), l.f_in, l.f_out,
            int(l.agg_op) if l.agg_op is not None else -1,
            int(l.act), l.act_enabled, tuple(l.parent_ids),
            tuple(sorted((k, repr(v)) for k, v in l.attrs.items())),
        )).encode())
    h.update(_weight_digest(model).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------- #
# Streaming request interface.
# --------------------------------------------------------------------------- #
def stack_features(features: Sequence[Any], pad_to: int = 0
                   ) -> torch.Tensor:
    """Pad N ``[V, F]`` feature arrays to a common shape and stack them
    into the ``[N, V, F]`` float32 tensor ``run_batch`` consumes (on the
    device of the first input when they are tensors, else the CPU), with
    zero lanes up to ``pad_to`` lanes.

    Requests that share a cache key come from the same deployed graph,
    so shapes normally already agree; zero-padding is safe regardless
    because the executor zero-pads features *and* weight rows to the
    tile grid — extra zero columns contribute nothing.
    """
    ts = [torch.as_tensor(f, dtype=torch.float32) for f in features]
    v = max(t.shape[0] for t in ts)
    f = max(t.shape[1] for t in ts)
    out = torch.zeros((max(len(ts), pad_to), v, f), dtype=torch.float32,
                      device=ts[0].device)
    for i, t in enumerate(ts):
        out[i, : t.shape[0], : t.shape[1]] = t
    return out


@dataclasses.dataclass
class InferenceRequest:
    """One unit of serving traffic: (model, graph, features).

    ``graph_data`` switches the request to graph-as-data execution (the
    mini-batch sampling layer): ``graph`` is then a geometry-bucket
    *template* shared by every request in the bucket, which makes the
    program-cache key collide across users, and the request's actual
    topology travels in ``graph_data`` (canonical ELL layout, see
    ``repro_torch.sampling.buckets.layout_graph``)."""

    model: ModelSpec              # benchmark name ("b1".."b8") or a ModelIR
    graph: Graph                  # or a live-graph handle / version graph
    features: Any                 # [V, F] array (numpy or tensor)
    request_id: Optional[str] = None
    seed: int = 0                 # builder seed when model is a name
    graph_data: Optional[dict] = None   # per-request topology (sampling)


@dataclasses.dataclass
class InferenceResponse:
    request_id: str
    output: Any                   # [V, n_classes] tensor on the device
    t_loc: float                  # compile latency paid by THIS request (s)
    t_loh: float                  # execution latency (s)
    cache_hit: bool
    cache_key: str
    model_name: str
    graph_name: str
    batch_size: int = 1           # requests coalesced into this binary pass
    overlay: Optional[int] = None  # pool overlay (set by repro_torch.runtime)


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    compiles: int = 0
    total_t_loc: float = 0.0
    total_t_loh: float = 0.0


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Engine runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


# --------------------------------------------------------------------------- #
class Engine:
    """One overlay instance: fixed tile contract + ACK kernels, on one
    torch device (``"cuda"`` unless the caller asks for another)."""

    def __init__(self, geometry: Optional[PartitionConfig] = None,
                 n_pes: int = 8, device=None, backend: Optional[str] = None,
                 *, vmem_budget_bytes: int = 3 << 20,
                 cache_capacity: int = 32,
                 resident_budget_bytes: Optional[int] = None,
                 verify: Optional[bool] = None,
                 replay: bool = True) -> None:
        self.geometry = geometry
        self.n_pes = n_pes
        self.device = _resolve_device(device)
        # Static verification of every fresh compile and live rebind
        # (repro_torch.verify); None -> the REPRO_VERIFY env var.
        self.verify = _env_verify_default() if verify is None else verify
        self.vmem_budget_bytes = vmem_budget_bytes
        self._executor = BinaryExecutor(
            device=self.device, backend=backend,
            resident_budget_bytes=resident_budget_bytes, replay=replay)
        self.backend = self._executor.ack.backend
        # This engine's own CUDA stream (None on the CPU, where
        # torch.cuda.stream(None) is a no-op).
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.cache: LRUCache[CompiledProgram] = LRUCache(cache_capacity)
        self.stats = EngineStats()

    @property
    def exec_stats(self) -> ExecStats:
        """Counters of the most recent ``run`` only."""
        return self._executor.stats

    @property
    def exec_stats_total(self) -> ExecStats:
        """Lifetime counters accumulated across all runs."""
        return self._executor.total

    @property
    def executor(self) -> BinaryExecutor:
        return self._executor

    def _geometry_tag(self) -> str:
        if self.geometry is None:
            return f"auto:{self.vmem_budget_bytes}"
        return (f"n1={self.geometry.n1},n2={self.geometry.n2},"
                f"cap={self.geometry.width_cap}")

    def cache_key(self, model: ModelSpec, graph: Graph, *, seed: int = 0,
                  order_opt: bool = True, fusion: bool = True) -> str:
        parts = "|".join([
            model_signature(model, seed), graph_signature(graph),
            self._geometry_tag(), f"pes={self.n_pes}",
            f"oo={int(order_opt)}", f"fu={int(fusion)}",
        ])
        return hashlib.sha1(parts.encode()).hexdigest()

    # ------------------------------------------------------------------ #
    def compile(self, model: ModelSpec, graph: Graph, *, seed: int = 0,
                order_opt: bool = True, fusion: bool = True,
                use_cache: bool = True, residency: Optional[str] = None,
                mesh=None, verify: Optional[bool] = None,
                _key: Optional[str] = None) -> CompiledProgram:
        """Model + graph -> CompiledProgram (through the §6 pipeline).

        ``model`` is a benchmark name ("b1".."b8", built with ``seed``) or
        a :class:`ModelIR`.  Hits in the program cache skip compilation.
        ``_key`` lets callers that already computed the cache key (submit)
        skip rehashing the graph/weights.

        ``residency`` ("device" | "host") sets the program's default
        execution mode: "host" keeps features host-resident and streams
        one destination shard's working set to the device at a time
        (bit-identical results, bounded device footprint).  The returned
        handle carries the default; the shared cache entry does not.

        ``mesh`` (a device count or a
        :class:`repro_torch.launch.mesh.DeviceMesh`) records the placement
        schedule (per-device shard orders and halo sets for that many
        devices) in the manifest, so it round-trips ``.gagi``; a cache hit
        gets one too.  A program compiled without it still runs on a
        mesh: the executor derives the same schedule from the binary.

        Live-versioned graphs (a ``repro_torch.livegraph`` handle or a
        version's materialized graph): the cache key is the version's
        structural signature, so a content-only delta hits the cache, and
        the program returned is *rebound* to the version's patched tiles
        (``GraphVersion.bind``) — fresh tiles, no recompile.

        ``verify`` statically verifies the program
        (:mod:`repro_torch.verify`, nothing executed) on every fresh
        compile and every live rebind, raising
        :class:`repro_torch.verify.VerifyError` on a failing report; None
        defers to ``Engine(verify=...)``.  Plain cache hits are not
        verified again."""
        if residency not in (None, "device", "host"):
            raise ValueError("residency must be 'device' or 'host', "
                             f"got {residency!r}")
        do_verify = self.verify if verify is None else verify
        n_devices = _mesh_count(mesh)
        lv = _live_version_of(graph)
        if lv is not None:
            graph = lv.as_graph()
        key = _key or self.cache_key(model, graph, seed=seed,
                                     order_opt=order_opt, fusion=fusion)
        tracer = get_tracer()
        if use_cache:
            cached = self.cache.get(key)
            if cached is not None:
                tracer.instant("cache_hit", cat="compile",
                               track="compile", args={"key": key[:12]})
                if n_devices is not None:
                    ensure_placement(cached, n_devices)
                if lv is not None:
                    cached = lv.bind(cached)
                    if do_verify:
                        self._verify_program(cached)
                if residency is not None:
                    return dataclasses.replace(
                        cached, default_residency=residency)
                return cached
        with tracer.span("compile", cat="compile", track="compile",
                         args={"key": key[:12],
                               "graph": graph.name}) as sp:
            model_ir = build(model, graph, seed) \
                if isinstance(model, str) else model
            opts = CompileOptions(order_opt=order_opt, fusion=fusion,
                                  n_pes=self.n_pes,
                                  partition=self.geometry,
                                  vmem_budget_bytes=self.vmem_budget_bytes)
            cr = run_pipeline(model_ir, graph, opts)
            sp.add(t_loc_s=round(cr.t_loc, 6),
                   binary_bytes=len(cr.binary))
        prog = from_program(cr.program, binary=cr.binary, t_loc=cr.t_loc,
                            cache_key=key, graph_name=graph.name,
                            source=cr, n_devices=n_devices)
        if residency is not None:
            prog = dataclasses.replace(prog, default_residency=residency)
        self.stats.compiles += 1
        self.stats.total_t_loc += cr.t_loc
        if use_cache:
            # The cached copy drops `source` (the full IR/Program/report
            # graph): execution needs only binary+manifest+weights+tiles.
            # It shares `pgraph`, on which the device-staged tiles live.
            # It also drops the residency default: serving traffic runs
            # device-resident unless a caller asks otherwise.
            self.cache.put(key, dataclasses.replace(
                prog, source=None, default_residency=None))
        if lv is not None:
            # Rebind to the version's tile store (labels the manifest
            # with version + tile stats); keep this caller's reports.
            prog = dataclasses.replace(lv.bind(prog), source=prog.source,
                                       default_residency=residency)
        if do_verify:
            self._verify_program(prog)
        _export_gagi(prog)
        return prog

    def remap(self, prog: CompiledProgram, report: Any = None, *,
              source: str = "auto", force: Any = None, margin: float = 0.1,
              probe: bool = False,
              modes: Optional[Sequence[str]] = None) -> CompiledProgram:
        """Sparsity-adaptive kernel remapping of a compiled program
        (:mod:`repro_torch.core.passes.remap`): re-encode each AGGREGATE
        tile's kernel fields — SpDMM as-is, densified GEMM, or
        skip-empty — from the tile's measured/derived density and a cost
        oracle.  No recompile, no new partition; the cache key is kept.

        ``report`` supplies the oracle's machine constants (a constants
        dict or any object with ``calibrated_constants``), or ``None``
        for the default roofline, whose constants are the H100
        data-sheet figures (:mod:`repro_torch.core.perfmodel`).
        ``probe=True`` instead times the two ACK kernels at the program's
        tile geometry on this engine's device and backend.  ``force`` /
        ``modes`` pin or restrict decisions (oracle tests / ablations).

        If ``prog`` is the cached entry for its key, the cache is updated
        in place (slim copy, same key), so later cache hits (and live
        rebinds on top of them) stay remapped.  With ``Engine(verify=
        True)`` the remapped program is verified."""
        from repro_torch.core.passes.remap import remap_program
        with self._on_stream():
            new = remap_program(prog, source=source, constants=report,
                                margin=margin, force=force, modes=modes,
                                probe=probe, ack=self._executor.ack,
                                device=self.device)
        if prog.cache_key and self.cache.get(prog.cache_key) is not None:
            self.cache.put(prog.cache_key, dataclasses.replace(
                new, source=None, default_residency=None))
        if self.verify:
            self._verify_program(new)
        return new

    def _verify_program(self, prog: CompiledProgram) -> None:
        from repro_torch.verify import VerifyError, verify_program
        tracer = get_tracer()
        with tracer.span("verify", cat="compile", track="compile",
                         args={"key": prog.cache_key[:12]}) as sp:
            report = verify_program(prog)
            sp.add(ok=report.ok, violations=len(report.violations))
        if not report.ok:
            raise VerifyError(report)

    @contextlib.contextmanager
    def _on_stream(self):
        """Issue the enclosed work on this engine's stream, after all the
        caller's current stream has queued so far.  Yields the caller's
        stream (None on the CPU)."""
        if self.stream is None:
            yield None
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield caller

    @staticmethod
    def _hand_back(y: torch.Tensor, caller) -> torch.Tensor:
        """Record ``y`` (allocated on the engine's stream) on the caller's
        stream, so that its memory is not reused for the engine's next
        pass while work the caller queued on its own stream still reads
        it.  (A mesh output on another card than the engine's was made
        on that card's current stream and synchronized.)"""
        if caller is not None and y.device == caller.device:
            y.record_stream(caller)
        return y

    def _resolve_mesh(self, mesh):
        """The ``mesh`` knob as a DeviceMesh: a device count takes the
        first that many devices of this engine's device type."""
        if isinstance(mesh, int):
            from repro_torch.launch.mesh import make_device_mesh
            return make_device_mesh(mesh, device_type=self.device.type)
        return mesh

    def run(self, prog: CompiledProgram, x,
            weights: Optional[Dict[str, Any]] = None,
            graph_data: Optional[dict] = None,
            residency: Optional[str] = None, mesh=None,
            graph=None) -> torch.Tensor:
        """Execute a compiled program by decoding its ISA binary, on this
        engine's device and stream; returns the [V, f_out] output tensor
        there, computed (the stream has been synchronized).
        ``residency="host"`` streams the partition-centric out-of-core
        path (features host-resident, one shard's working set on the
        device at a time); ``"device"`` keeps every padded layer output
        on the device.  ``mesh`` (a device count or a ``DeviceMesh`` of
        this engine's device type) runs the placement-scheduled
        multi-device path, its output on the first mesh device.  The
        results are bit-identical; ``None`` uses the program's
        compile-time default.  ``graph`` (a live-versioned graph or
        ``repro_torch.livegraph`` handle) rebinds the program to that
        version's patched tiles before it runs."""
        prog = self._rebind_live(prog, graph)
        residency = residency or prog.default_residency or "device"
        mesh = self._resolve_mesh(mesh)
        with self._on_stream() as caller:
            y = self._executor.run(prog, x, weights=weights,
                                   graph_data=graph_data,
                                   residency=residency, mesh=mesh)
        return self._hand_back(y, caller)

    @staticmethod
    def _rebind_live(prog: CompiledProgram, graph) -> CompiledProgram:
        if graph is None:
            return prog
        lv = _live_version_of(graph)
        return lv.bind(prog) if lv is not None else prog

    def run_batch(self, prog: CompiledProgram, xs,
                  weights: Optional[Dict[str, Any]] = None,
                  graph_data: Optional[dict] = None,
                  residency: Optional[str] = None,
                  mesh=None, graph=None) -> torch.Tensor:
        """One binary pass for stacked ``[N, V, F]`` features ->
        ``[N, V, f_out]``; lane n equals ``run(prog, xs[n])`` bit for bit.
        ``residency`` as in :meth:`run` ("host" interleaves the lanes per
        staged shard, so each shard's tile working set ships once per
        batch; the staged window's sub-fiber half then scales with the
        batch).  ``graph_data`` is lane-stacked (:func:`stack_graph_data`)
        and device-resident only.  ``mesh`` as in :meth:`run`: the lanes
        run as passes of their own, one after another, and ``exec_stats``
        merge them into one logical pass.  ``graph`` rebinds to a live
        version's tiles, as in :meth:`run`."""
        prog = self._rebind_live(prog, graph)
        residency = residency or prog.default_residency or "device"
        mesh = self._resolve_mesh(mesh)
        with self._on_stream() as caller:
            ys = self._executor.run_batch(prog, xs, weights=weights,
                                          graph_data=graph_data,
                                          residency=residency, mesh=mesh)
        return self._hand_back(ys, caller)

    def load(self, path: str) -> CompiledProgram:
        """Load a ``.gagi`` bundle (saved by either package)."""
        prog = CompiledProgram.load(path)
        if self.geometry is not None:
            geo = prog.manifest["geometry"]
            mine = (self.geometry.n1, self.geometry.n2,
                    self.geometry.width_cap)
            theirs = (geo["n1"], geo["n2"], geo["width_cap"])
            if theirs != mine:
                warnings.warn(
                    f"{path} was compiled for tile geometry "
                    f"(n1, n2, width_cap)={theirs} but this engine is "
                    f"fixed at {mine}", stacklevel=2)
        return prog

    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        """Wait for this engine's stream (not the whole device)."""
        if self.stream is not None:
            self.stream.synchronize()

    @staticmethod
    def _admit_live(req: InferenceRequest):
        """Resolve a live-graph handle at admission: pin the active
        version (inflight refcount) and swap the request's graph for
        that version's materialized snapshot.  Returns ``(req, pin)``;
        callers release the pin when the request completes."""
        server = getattr(req.graph, "_live_server", None)
        if server is None:
            return req, None
        version = server.admit()
        return (dataclasses.replace(req, graph=version.as_graph()),
                (server, version.vid))

    def submit(self, req: InferenceRequest) -> InferenceResponse:
        """Serve one request: cached compile -> binary-driven execution.
        ``t_loh`` is read after this engine's stream has finished the
        pass.  ``req.graph`` may be a ``repro_torch.livegraph`` handle:
        the request is then pinned to the version active at admission and
        served on exactly that version's tiles, whatever cutovers happen
        meanwhile."""
        req, pin = self._admit_live(req)
        try:
            key = self.cache_key(req.model, req.graph, seed=req.seed)
            hit = key in self.cache
            prog = self.compile(req.model, req.graph, seed=req.seed,
                                _key=key)
            t0 = time.perf_counter()
            y = self.run(prog, req.features, graph_data=req.graph_data)
            self._sync()
            t_loh = time.perf_counter() - t0
            t_loc = 0.0 if hit else prog.t_loc

            self.stats.requests += 1
            self.stats.cache_hits += int(hit)
            self.stats.cache_misses += int(not hit)
            self.stats.total_t_loh += t_loh
            rid = req.request_id or f"req{self.stats.requests - 1}"
            return InferenceResponse(
                request_id=rid, output=y, t_loc=t_loc, t_loh=t_loh,
                cache_hit=hit, cache_key=key, model_name=prog.model_name,
                graph_name=req.graph.name)
        finally:
            if pin is not None:
                pin[0].release(pin[1])

    def submit_batch(self, reqs: Sequence[InferenceRequest]
                     ) -> List[InferenceResponse]:
        """Serve N coalesced requests with ONE binary pass.

        All requests must share this engine's cache key — same model
        schema + weights, same deployed graph, same compile options —
        which is exactly the grouping ``repro_torch.runtime.Batcher``
        produces.  Features are padded/stacked to ``[N, V, F]`` and
        executed by a single traversal of the instruction stream
        (``run_batch``).

        Latency accounting reflects what each request *experienced*:
        every response reports the batch's compile latency (they all
        waited for the one compile on a miss) and the batch's execution
        wall time.  Graph-as-data requests (``graph_data``, one bucket
        per cache key) run as lanes of one pass, each on its own tiles;
        they cannot share a batch with baked-topology requests.  Live
        handles are pinned at admission, and one batch serves one
        version.
        """
        if not reqs:
            return []
        admitted = [self._admit_live(r) for r in reqs]
        reqs = [r for r, _ in admitted]
        pins = [p for _, p in admitted if p is not None]
        try:
            return self._submit_batch_resolved(reqs)
        finally:
            for server, vid in pins:
                server.release(vid)

    def _submit_batch_resolved(self, reqs: Sequence[InferenceRequest]
                               ) -> List[InferenceResponse]:
        key = self.cache_key(reqs[0].model, reqs[0].graph,
                             seed=reqs[0].seed)
        for r in reqs[1:]:
            k = self.cache_key(r.model, r.graph, seed=r.seed)
            if k != key:
                raise ValueError(
                    "submit_batch requires one cache key per batch: "
                    f"request {r.request_id!r} has key {k[:12]}… but the "
                    f"batch was opened with {key[:12]}…")
        # Live versions share the structural cache key by design, but a
        # batch is ONE binary pass over ONE tile set: mixing versions
        # would silently serve some requests the wrong graph.
        lv = _live_version_of(reqs[0].graph)
        for r in reqs[1:]:
            if _live_version_of(r.graph) is not lv:
                raise ValueError(
                    "submit_batch cannot mix graph versions in one "
                    "batch: all requests must be admitted against the "
                    "same live version (the runtime batches per "
                    "version for exactly this reason)")
        with_gd = sum(r.graph_data is not None for r in reqs)
        if 0 < with_gd < len(reqs):
            raise ValueError(
                "submit_batch cannot mix graph-as-data requests with "
                "baked-topology requests in one batch")
        hit = key in self.cache
        prog = self.compile(reqs[0].model, reqs[0].graph,
                            seed=reqs[0].seed, _key=key)
        if not hit:
            # Execute the long-lived cached copy, whose pgraph carries the
            # staged tiles repeat batches will reuse (for a live version,
            # its stable bound copy).
            prog = self.cache.get(key) or prog
            if lv is not None:
                prog = lv.bind(prog)
        # Bucket the batch axis to the next power of two (zero lanes,
        # outputs sliced off), as the JAX engine does: deadline flushes
        # give ragged sizes 1..max_batch, and each distinct shape is a
        # replay key of its own (an eager pass, then a capture), so
        # buckets cap them at log2(max_batch) a program for at most 2x
        # lane waste.
        n = len(reqs)
        bucket = 1 << (n - 1).bit_length()
        gd = (stack_graph_data([r.graph_data for r in reqs], bucket)
              if with_gd else None)
        with self._on_stream() as caller:
            # Stacked on the stream that reads the stack.
            xs = stack_features([r.features for r in reqs], bucket)
            t0 = time.perf_counter()
            ys = self._executor.run_batch(prog, xs, graph_data=gd)[:n]
            self._sync()
            t_loh = time.perf_counter() - t0
        ys = self._hand_back(ys, caller)
        t_loc = 0.0 if hit else prog.t_loc

        base = self.stats.requests
        self.stats.requests += n
        self.stats.cache_hits += n * int(hit)
        self.stats.cache_misses += n * int(not hit)
        self.stats.total_t_loh += t_loh
        return [InferenceResponse(
            request_id=r.request_id or f"req{base + i}", output=ys[i],
            t_loc=t_loc, t_loh=t_loh, cache_hit=hit, cache_key=key,
            model_name=prog.model_name, graph_name=r.graph.name,
            batch_size=n) for i, r in enumerate(reqs)]

    def serve(self, requests: Iterable[InferenceRequest]
              ) -> List[InferenceResponse]:
        """Drain a request stream through :meth:`submit`.  For batched,
        multi-overlay serving use :class:`repro_torch.runtime.OverlayPool`
        / ``ServeLoop`` instead."""
        return [self.submit(r) for r in requests]
