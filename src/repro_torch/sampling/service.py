"""SamplingService — per-user mini-batch inference over an OverlayPool.

A copy of ``repro/sampling/service.py`` bound to the port's runtime
(:class:`~repro_torch.runtime.OverlayPool`, ``ServeLoop``, ``Batch``,
``request_cost``) and tracer.  Logits stay on the engine's device, as
``InferenceResponse.output`` does.  ``warm`` runs each program at every
power-of-two batch size, as JAX's traces an executable per size, and
twice: a batch shape's first pass runs eagerly (after the program's
first, which stages its weights) and its second captures the CUDA graph
later batches replay.

Request lifecycle (the dominant real-world serving scenario)::

    TargetRequest(vertex_ids, model, fanouts)
        │ sample   k-hop ego network (seeded, fanout-capped) ── sampler.py
        │ norm     gcn / mean / none edge normalization on the subgraph
        │ bucket   pad to the power-of-two geometry bucket ──── buckets.py
        │          (template graph shared per bucket => one cache key)
        ▼
    InferenceRequest(model, template, gathered features, graph_data)
        │ batch    runtime Batcher coalesces same-bucket users
        │ overlay  cache-affinity routing; ONE binary pass per batch
        ▼
    InferenceResponse ── un-pad ──> TargetResponse(logits[T, C])

Steady-state traffic touches a handful of buckets, so the engines'
program caches converge to hit rate ~1 and every request is pure T_LoH.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.engine import InferenceRequest, InferenceResponse
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime import Batch, OverlayPool, ServeLoop, request_cost

from .buckets import Bucket, bucket_for, layout_graph, template_graph
from .sampler import EgoNet, Fanout, sample_ego

_NORMS = ("gcn", "mean", "none")


@dataclasses.dataclass
class TargetRequest:
    """One user's question: label these vertices with this model."""

    targets: Sequence[int]                  # global vertex ids (unique)
    model: Any = "b1"                       # benchmark name or ModelIR
    fanouts: Sequence[Fanout] = (10, 5)     # per-hop caps; "full" = no cap
    request_id: Optional[str] = None
    seed: int = 0                           # sampling seed (deterministic)
    model_seed: int = 0                     # builder seed for named models


@dataclasses.dataclass
class TargetResponse:
    """Un-padded answer: one logit row per requested target."""

    request_id: str
    logits: Any                             # [T, n_classes] tensor
    targets: np.ndarray                     # the global ids, request order
    bucket: str                             # geometry bucket key
    n_vertices: int                         # sampled ego-network size
    n_edges: int
    cache_hit: bool
    t_loc: float
    t_loh: float
    batch_size: int = 1
    overlay: Optional[int] = None


class SamplingService:
    """Wrap an :class:`~repro_torch.runtime.OverlayPool` for per-user traffic.

    Holds the deployed graph (raw COO) + its feature matrix; turns every
    :class:`TargetRequest` into a bucketed graph-as-data
    :class:`~repro_torch.engine.InferenceRequest` and routes it through the
    pool's batching serve loop.
    """

    def __init__(self, graph: Graph, features: np.ndarray,
                 pool: Optional[OverlayPool] = None, *, norm: str = "gcn",
                 n_overlays: int = 2, geometry=None,
                 max_batch: int = 8, max_wait_us: float = 2000.0,
                 max_queue: int = 256, **engine_kw) -> None:
        if norm not in _NORMS:
            raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
        self.graph = graph
        self.features = np.asarray(features, np.float32)
        if self.features.shape[0] != graph.n_vertices:
            raise ValueError(
                f"features rows ({self.features.shape[0]}) != |V| "
                f"({graph.n_vertices})")
        self.norm = norm
        self.pool = pool if pool is not None else OverlayPool(
            n_overlays=n_overlays, geometry=geometry, **engine_kw)
        self.geometry = self.pool.engines[0].geometry
        if self.geometry is None:
            raise ValueError(
                "SamplingService needs a pool with an explicit tile "
                "geometry: the canonical bucket layout is defined by "
                "(n1, n2), so auto-chosen per-graph geometry would break "
                "the one-layout-per-bucket contract")
        self.loop = ServeLoop(self.pool, max_batch=max_batch,
                              max_wait_us=max_wait_us, max_queue=max_queue,
                              metrics=self.pool.metrics)
        self._templates: Dict[Bucket, Graph] = {}
        self.bucket_counts: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def _normalize(self, sub: Graph) -> Graph:
        if self.norm == "gcn":
            return sub.gcn_normalized()
        if self.norm == "mean":
            return sub.mean_normalized()
        return sub

    def template_for(self, bucket: Bucket) -> Graph:
        """One shared template Graph object per bucket — its identity is
        what makes every user's cache key collide."""
        tpl = self._templates.get(bucket)
        if tpl is None:
            tpl = template_graph(bucket, self.geometry)
            self._templates[bucket] = tpl
        return tpl

    def prepare(self, req: TargetRequest, count: bool = True
                ) -> Tuple[InferenceRequest, EgoNet, Bucket]:
        """sample -> normalize -> bucket -> lay out; no execution.
        ``count=False`` keeps warmup traffic out of the bucket census."""
        tracer = get_tracer()
        with tracer.span("sample", cat="sample", track="sampling",
                         args={"targets": len(req.targets)}) as sp:
            ego = sample_ego(self.graph, req.targets, req.fanouts,
                             seed=req.seed)
            sub = self._normalize(ego.graph)
            sp.add(n_vertices=sub.n_vertices, n_edges=sub.n_edges)
        with tracer.span("layout", cat="sample", track="sampling") as sp:
            bucket = bucket_for(sub, self.geometry)
            gd = layout_graph(sub, bucket, self.geometry)
            sp.add(bucket=bucket.key)
        feats = np.zeros((bucket.n_vertices, self.graph.feat_dim),
                         np.float32)
        feats[: ego.vertices.shape[0]] = self.features[ego.vertices]
        if count:
            self.bucket_counts[bucket.key] = \
                self.bucket_counts.get(bucket.key, 0) + 1
        inf = InferenceRequest(
            model=req.model, graph=self.template_for(bucket),
            features=feats, request_id=req.request_id,
            seed=req.model_seed, graph_data=gd)
        return inf, ego, bucket

    def _unpad(self, resp: InferenceResponse, req: TargetRequest,
               ego: EgoNet, bucket: Bucket) -> TargetResponse:
        return TargetResponse(
            request_id=resp.request_id,
            # targets are locals 0..T-1: their rows, on the device
            logits=resp.output[: ego.n_targets],
            targets=ego.vertices[ego.targets],
            bucket=bucket.key,
            n_vertices=ego.graph.n_vertices,
            n_edges=ego.graph.n_edges,
            cache_hit=resp.cache_hit,
            t_loc=resp.t_loc, t_loh=resp.t_loh,
            batch_size=resp.batch_size, overlay=resp.overlay)

    def warm(self, requests: Sequence[TargetRequest]) -> int:
        """Pre-compile and pre-capture for the programs ``requests``
        touch.

        One representative request per program is executed at every
        power-of-two batch size up to ``max_batch``, twice (an eager pass,
        then the capture of its CUDA graph on a card), on the overlay the
        pool routes it to, so steady-state traffic of those buckets
        replays whatever ragged batch sizes deadline flushes produce.
        Returns the number of programs warmed.
        """
        reps: Dict[str, InferenceRequest] = {}
        for r in requests:
            inf, _, _ = self.prepare(r, count=False)
            # one representative per PROGRAM (model x bucket x seed),
            # not per bucket: two models sharing a bucket both warm
            reps.setdefault(self.pool.cache_key(inf), inf)
        sizes = []
        s = 1
        while s < self.loop.max_batch:
            sizes.append(s)
            s <<= 1
        sizes.append(self.loop.max_batch)
        for key, inf in reps.items():
            for n in sorted(set(sizes)) * 2:
                self.pool.submit_batch(Batch(
                    key=key, requests=[inf] * n, indices=list(range(n)),
                    created_at=0.0, cost=n * request_cost(inf)))
        return len(reps)

    # ------------------------------------------------------------------ #
    def serve(self, requests: Sequence[TargetRequest]
              ) -> List[TargetResponse]:
        """Batched drain of a per-user request stream (request order)."""
        prepared = [self.prepare(r) for r in requests]
        for i, (inf, _, _) in enumerate(prepared):
            if inf.request_id is None:
                inf.request_id = f"target{i}"
        # ServeLoop.serve returns responses in request (admission) order,
        # so the join is positional — duplicate request_ids stay safe.
        resps = self.loop.serve([p[0] for p in prepared])
        return [self._unpad(resp, req, ego, bucket)
                for resp, req, (inf, ego, bucket)
                in zip(resps, requests, prepared)]

    def submit(self, req: TargetRequest) -> TargetResponse:
        """Serve one request synchronously (no batching delay)."""
        return self.serve([req])[0]

    def shutdown(self) -> None:
        self.loop.shutdown()

    # ------------------------------------------------------------------ #
    @property
    def cache_hit_rate(self) -> float:
        return self.pool.cache_hit_rate

    def stats_snapshot(self) -> dict:
        snap = self.pool.stats_snapshot()
        snap["buckets"] = dict(self.bucket_counts)
        snap["distinct_buckets"] = len(self.bucket_counts)
        return snap
