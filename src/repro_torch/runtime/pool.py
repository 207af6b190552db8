"""OverlayPool — K virtual overlays with cache-affinity routing.

(The port's copy of ``repro/runtime/pool.py``, over the port's engine;
``OverlayPool(**engine_kw)`` passes ``device=`` on, so overlays default to
CUDA and tests pass ``device="cpu"``.)

One :class:`~repro_torch.engine.Engine` is one overlay: a fixed tile-geometry
contract, its own ACK kernel cache and its own LRU *program* cache.  A
pool is the host-scale analogue of the paper's PE array, and routing is
Algorithm 9's dynamic load balance lifted to request granularity:

  * **cache affinity** — a cache key (deployed (model, graph) pair) is
    routed to the overlay that already holds its compiled program, so
    repeated traffic never pays T_LoC twice and never duplicates the
    program across overlays;
  * **least-loaded fallback** — a new key goes to the overlay with the
    least assigned work, via the very same :func:`lpt_assign` greedy
    the compiler uses to pack tiling blocks onto PEs
    (``repro_torch.core.passes.schedule``): the idle PE pulls the next block.

Load is tracked as cumulative assigned cost (graph work x batch size),
updated at placement time — deterministic whatever the thread timing of
the serving loop above.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.passes.partition import PartitionConfig
from repro_torch.core.passes.schedule import lpt_assign
from repro_torch.engine import Engine, InferenceRequest, InferenceResponse

from .batcher import Batch, request_cost
from .metrics import Metrics


class OverlayPool:
    """K engines + cache-affinity routing; see module docstring."""

    def __init__(self, n_overlays: int = 2,
                 geometry: Optional[PartitionConfig] = None, *,
                 engines: Optional[Sequence[Engine]] = None,
                 metrics: Optional[Metrics] = None,
                 **engine_kw) -> None:
        if engines is not None:
            self.engines: List[Engine] = list(engines)
        else:
            self.engines = [Engine(geometry=geometry, **engine_kw)
                            for _ in range(n_overlays)]
        if not self.engines:
            raise ValueError("OverlayPool needs at least one overlay")
        tags = {e._geometry_tag() for e in self.engines}
        if len(tags) != 1:
            # Affinity routing compares cache keys across overlays, so
            # every overlay must produce the same key for a request.
            raise ValueError(
                f"all overlays must share one tile geometry, got {tags}")
        self.metrics = metrics if metrics is not None else Metrics()
        self._affinity: Dict[str, int] = {}
        self._load: List[float] = [0.0] * len(self.engines)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.engines)

    @property
    def loads(self) -> List[float]:
        return list(self._load)

    def cache_key(self, req: InferenceRequest) -> str:
        """Pool-wide batching/routing key (identical on every overlay).

        Live-versioned graphs (``repro_torch.livegraph``) get a ``@v<N>``
        suffix: versions deliberately SHARE the engine's structural
        cache key (that is the no-recompile guarantee), but a batch is
        one binary pass over one tile set, so the batcher must never
        coalesce requests admitted against different versions.
        :func:`engine_key` strips the suffix wherever the program cache
        is consulted, so affinity still routes every version of a graph
        to the overlay that compiled it."""
        key = self.engines[0].cache_key(req.model, req.graph,
                                        seed=req.seed)
        lv = getattr(req.graph, "_live_version", None)
        return key if lv is None else f"{key}@v{lv.vid}"

    @staticmethod
    def engine_key(key: str) -> str:
        """Batch key -> program-cache key (drop the live-version tag)."""
        return key.split("@v", 1)[0]

    def overlay_for(self, key: str) -> Optional[int]:
        """Which overlay already holds this key's compiled program?

        Checks the live program caches first (covers engines warmed
        out-of-band and keys re-compiled after eviction), then the
        sticky affinity map (keeps a key's home overlay even while its
        program is momentarily evicted, preserving kernel locality)."""
        ekey = self.engine_key(key)
        for i, e in enumerate(self.engines):
            if ekey in e.cache:
                return i
        return self._affinity.get(key, self._affinity.get(ekey))

    def place(self, batches: Sequence[Batch]) -> List[int]:
        """Assign each batch to an overlay; deterministic.

        Affinity-bound keys go home; the rest are LPT-packed onto the
        least-loaded overlays (``lpt_assign`` seeded with current
        loads).  Loads are charged at placement time.
        """
        idxs: List[Optional[int]] = [None] * len(batches)
        new: List[int] = []
        for i, b in enumerate(batches):
            home = self.overlay_for(b.key)
            if home is not None:
                idxs[i] = home
                self._affinity[b.key] = home
                self._affinity[self.engine_key(b.key)] = home
                self._load[home] += b.cost
            else:
                new.append(i)
        if new:
            assignment, self._load = lpt_assign(
                [batches[i].cost for i in new], len(self.engines),
                initial_loads=self._load)
            for i, home in zip(new, assignment):
                idxs[i] = home
                self._affinity[batches[i].key] = home
                self._affinity[self.engine_key(batches[i].key)] = home
        return [int(i) for i in idxs]  # every slot is assigned above

    def route(self, key: str, cost: float = 1.0) -> int:
        """Route a single key (thin wrapper over :meth:`place`)."""
        return self.place([Batch(key=key, requests=[], indices=[],
                                 created_at=0.0, cost=cost)])[0]

    # ------------------------------------------------------------------ #
    def submit_batch(self, batch: Batch) -> List[InferenceResponse]:
        """Route one batch and execute it as a single binary pass."""
        idx = self.place([batch])[0]
        return self.execute_on(idx, batch)

    def execute_on(self, idx: int, batch: Batch
                   ) -> List[InferenceResponse]:
        """Execute an already-placed batch on overlay ``idx``."""
        resps = self.engines[idx].submit_batch(batch.requests)
        for r in resps:
            r.overlay = idx
        return resps

    def serve(self, requests: Sequence[InferenceRequest], **loop_kw
              ) -> List[InferenceResponse]:
        """Batched, multi-overlay drain of a request stream.

        Convenience wrapper: builds a :class:`~repro_torch.runtime.ServeLoop`
        over this pool (sharing its metrics) and serves the stream.
        Keyword arguments are forwarded to the loop (``max_batch``,
        ``max_wait_us``, ``max_queue``, ``overlap_overlays``, ...).
        """
        from .serve_loop import ServeLoop
        loop = ServeLoop(self, **loop_kw)
        try:
            return loop.serve(requests)
        finally:
            loop.shutdown()     # don't leak per-overlay worker threads

    # ------------------------------------------------------------------ #
    @property
    def cache_hit_rate(self) -> float:
        """Program-cache hit rate aggregated across overlays."""
        hits = sum(e.stats.cache_hits for e in self.engines)
        total = sum(e.stats.requests for e in self.engines)
        return hits / total if total else 0.0

    def stats_snapshot(self) -> dict:
        """JSON-serializable per-overlay + aggregate engine stats."""
        per = [{
            "requests": e.stats.requests,
            "cache_hits": e.stats.cache_hits,
            "cache_misses": e.stats.cache_misses,
            "compiles": e.stats.compiles,
            "programs_cached": len(e.cache),
            "total_t_loc_s": round(e.stats.total_t_loc, 6),
            "total_t_loh_s": round(e.stats.total_t_loh, 6),
            "assigned_load": round(load, 3),
        } for e, load in zip(self.engines, self._load)]
        return {
            "n_overlays": len(self.engines),
            "cache_hit_rate": round(self.cache_hit_rate, 6),
            "overlays": per,
        }


def warm_pool(pool: OverlayPool,
              requests: Sequence[InferenceRequest],
              clock=time.monotonic) -> None:
    """Pre-compile one program per distinct cache key (batch size 1),
    so steady-state traffic measures pure T_LoH.  Routing happens
    through the pool, so affinity is established exactly as live
    traffic would."""
    seen = set()
    for req in requests:
        key = pool.cache_key(req)
        if key in seen:
            continue
        seen.add(key)
        pool.submit_batch(Batch(key=key, requests=[req], indices=[0],
                                created_at=clock(),
                                cost=request_cost(req)))
