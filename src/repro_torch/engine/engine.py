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
compilation and report ``T_LoC == 0``.

The device defaults to ``"cuda"`` and there is no silent CPU fallback:
without a CUDA device the constructor raises, and CPU execution (what the
tests use) has to be asked for with ``device="cpu"``.  The cache key and
the compiled binary are the same as the JAX package's for the same inputs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Union

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
@dataclasses.dataclass
class InferenceRequest:
    """One unit of serving traffic: (model, graph, features)."""

    model: ModelSpec              # benchmark name ("b1".."b8") or a ModelIR
    graph: Graph
    features: Any                 # [V, F] array (numpy or tensor)
    request_id: Optional[str] = None
    seed: int = 0                 # builder seed when model is a name
    graph_data: Optional[dict] = None   # not ported: must stay None


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
                use_cache: bool = True,
                _key: Optional[str] = None) -> CompiledProgram:
        """Model + graph -> CompiledProgram (through the §6 pipeline).

        ``model`` is a benchmark name ("b1".."b8", built with ``seed``) or
        a :class:`ModelIR`.  Hits in the program cache skip compilation.
        ``_key`` lets callers that already computed the cache key (submit)
        skip rehashing the graph/weights."""
        key = _key or self.cache_key(model, graph, seed=seed,
                                     order_opt=order_opt, fusion=fusion)
        tracer = get_tracer()
        if use_cache:
            cached = self.cache.get(key)
            if cached is not None:
                tracer.instant("cache_hit", cat="compile",
                               track="compile", args={"key": key[:12]})
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
        self.stats.compiles += 1
        self.stats.total_t_loc += cr.t_loc
        if use_cache:
            # The cached copy drops `source` (the full IR/Program/report
            # graph): execution needs only binary+manifest+weights+tiles.
            # It shares `pgraph`, on which the device-staged tiles live.
            self.cache.put(key, dataclasses.replace(prog, source=None))
        return prog

    def run(self, prog: CompiledProgram, x,
            weights: Optional[Dict[str, Any]] = None,
            graph_data: Optional[dict] = None,
            residency: Optional[str] = None, mesh=None) -> torch.Tensor:
        """Execute a compiled program by decoding its ISA binary, on this
        engine's device; returns the [V, f_out] output tensor there."""
        return self._executor.run(prog, x, weights=weights,
                                  graph_data=graph_data,
                                  residency=residency or "device",
                                  mesh=mesh)

    def run_batch(self, prog: CompiledProgram, xs, **kw):
        raise NotImplementedError(
            "batched execution (run_batch / submit_batch) is not ported "
            "yet (ROADMAP A6)")

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: InferenceRequest) -> InferenceResponse:
        """Serve one request: cached compile -> binary-driven execution.
        ``t_loh`` is read after the device has finished the pass."""
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

    def submit_batch(self, reqs) -> List[InferenceResponse]:
        raise NotImplementedError(
            "batched execution (run_batch / submit_batch) is not ported "
            "yet (ROADMAP A6)")

    def serve(self, requests: Iterable[InferenceRequest]
              ) -> List[InferenceResponse]:
        """Drain a request stream through :meth:`submit`."""
        return [self.submit(r) for r in requests]
