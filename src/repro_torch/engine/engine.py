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

The device defaults to ``"cuda"`` and there is no silent CPU fallback:
without a CUDA device the constructor raises, and CPU execution (what the
tests use) has to be asked for with ``device="cpu"``.  The cache key and
the compiled binary are the same as the JAX package's for the same inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
from .executor import BinaryExecutor, ExecStats
from .program import CompiledProgram, from_program

ModelSpec = Union[str, ModelIR]


# --------------------------------------------------------------------------- #
# Cache-key signatures (the same strings the JAX package computes).
# --------------------------------------------------------------------------- #
def graph_signature(g: Graph) -> str:
    """Partition signature of a graph: topology plus feat_dim/n_classes,
    which size the layers of builder-constructed models.  The O(|E|) hash
    over the edge arrays is memoized on the graph object, keyed by the
    array objects themselves plus the graph's ``mutation_token``."""
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
def stack_features(features: Sequence[Any]) -> torch.Tensor:
    """Pad N ``[V, F]`` feature arrays to a common shape and stack them
    into the ``[N, V, F]`` float32 tensor ``run_batch`` consumes (on the
    device of the first input when they are tensors, else the CPU).

    Requests that share a cache key come from the same deployed graph,
    so shapes normally already agree; zero-padding is safe regardless
    because the executor zero-pads features *and* weight rows to the
    tile grid — extra zero columns contribute nothing.
    """
    ts = [torch.as_tensor(f, dtype=torch.float32) for f in features]
    v = max(t.shape[0] for t in ts)
    f = max(t.shape[1] for t in ts)
    out = torch.zeros((len(ts), v, f), dtype=torch.float32,
                      device=ts[0].device)
    for i, t in enumerate(ts):
        out[i, : t.shape[0], : t.shape[1]] = t
    return out


@dataclasses.dataclass
class InferenceRequest:
    """One unit of serving traffic: (model, graph, features)."""

    model: ModelSpec              # benchmark name ("b1".."b8") or a ModelIR
    graph: Graph
    features: Any                 # [V, F] array (numpy or tensor)
    request_id: Optional[str] = None
    seed: int = 0                 # builder seed when model is a name
    graph_data: Optional[dict] = None   # not ported (ROADMAP A11)


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
                 resident_budget_bytes: Optional[int] = None) -> None:
        self.geometry = geometry
        self.n_pes = n_pes
        self.device = _resolve_device(device)
        self.vmem_budget_bytes = vmem_budget_bytes
        self._executor = BinaryExecutor(
            device=self.device, backend=backend,
            resident_budget_bytes=resident_budget_bytes)
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
        handle carries the default; the shared cache entry does not."""
        if residency not in (None, "device", "host"):
            raise ValueError("residency must be 'device' or 'host', "
                             f"got {residency!r}")
        key = _key or self.cache_key(model, graph, seed=seed,
                                     order_opt=order_opt, fusion=fusion)
        tracer = get_tracer()
        if use_cache:
            cached = self.cache.get(key)
            if cached is not None:
                tracer.instant("cache_hit", cat="compile",
                               track="compile", args={"key": key[:12]})
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
                            source=cr)
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
        for the default roofline, whose constants are TPU v5e figures
        (:mod:`repro_torch.core.perfmodel`).  ``probe=True`` instead
        times the two ACK kernels at the program's tile geometry on this
        engine's device and backend.  ``force`` / ``modes`` pin or
        restrict decisions (oracle tests / ablations).

        If ``prog`` is the cached entry for its key, the cache is updated
        in place (slim copy, same key), so later cache hits stay
        remapped."""
        from repro_torch.core.passes.remap import remap_program
        with self._on_stream():
            new = remap_program(prog, source=source, constants=report,
                                margin=margin, force=force, modes=modes,
                                probe=probe, ack=self._executor.ack,
                                device=self.device)
        if prog.cache_key and self.cache.get(prog.cache_key) is not None:
            self.cache.put(prog.cache_key, dataclasses.replace(
                new, source=None, default_residency=None))
        return new

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
        it."""
        if caller is not None:
            y.record_stream(caller)
        return y

    def run(self, prog: CompiledProgram, x,
            weights: Optional[Dict[str, Any]] = None,
            graph_data: Optional[dict] = None,
            residency: Optional[str] = None, mesh=None) -> torch.Tensor:
        """Execute a compiled program by decoding its ISA binary, on this
        engine's device and stream; returns the [V, f_out] output tensor
        there, computed (the stream has been synchronized).
        ``residency="host"`` streams the partition-centric out-of-core
        path (features host-resident, one shard's working set on the
        device at a time); ``"device"`` keeps every padded layer output
        on the device.  The results are bit-identical; ``None`` uses the
        program's compile-time default."""
        residency = residency or prog.default_residency or "device"
        with self._on_stream() as caller:
            y = self._executor.run(prog, x, weights=weights,
                                   graph_data=graph_data,
                                   residency=residency, mesh=mesh)
        return self._hand_back(y, caller)

    def run_batch(self, prog: CompiledProgram, xs,
                  weights: Optional[Dict[str, Any]] = None,
                  graph_data: Optional[dict] = None,
                  residency: Optional[str] = None,
                  mesh=None) -> torch.Tensor:
        """One binary pass for stacked ``[N, V, F]`` features ->
        ``[N, V, f_out]``; lane n equals ``run(prog, xs[n])`` bit for bit.
        ``residency`` as in :meth:`run` ("host" interleaves the lanes per
        staged shard, so each shard's tile working set ships once per
        batch; the staged window's sub-fiber half then scales with the
        batch).  ``graph_data`` (ROADMAP A11) and ``mesh`` (A13) are not
        ported and raise NotImplementedError."""
        residency = residency or prog.default_residency or "device"
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

    def submit(self, req: InferenceRequest) -> InferenceResponse:
        """Serve one request: cached compile -> binary-driven execution.
        ``t_loh`` is read after this engine's stream has finished the
        pass."""
        key = self.cache_key(req.model, req.graph, seed=req.seed)
        hit = key in self.cache
        prog = self.compile(req.model, req.graph, seed=req.seed, _key=key)
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
        wall time.  (Live-graph admission comes with ROADMAP A12, as in
        :meth:`submit`.)
        """
        if not reqs:
            return []
        return self._submit_batch_resolved(reqs)

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
            # staged tiles repeat batches will reuse.
            prog = self.cache.get(key) or prog
        # No lane padding to a power of two: the JAX engine pads only so
        # that ragged batch sizes reuse its traced executables, and this
        # port has no traced executables yet (ROADMAP A6).
        n = len(reqs)
        gd = [r.graph_data for r in reqs] if with_gd else None
        with self._on_stream() as caller:
            # Stacked on the stream that reads the stack.
            xs = stack_features([r.features for r in reqs])
            t0 = time.perf_counter()
            ys = self._executor.run_batch(prog, xs, graph_data=gd)
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
