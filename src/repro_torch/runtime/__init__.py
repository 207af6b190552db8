"""repro_torch.runtime — the traffic layer above :mod:`repro_torch.engine`.

The port's copy of ``repro.runtime``: the same batching, routing and
serving loop, over the port's :class:`~repro_torch.engine.Engine`.

  * :class:`Batcher` — dynamic batching: coalesce concurrent requests
    that share a (model schema, graph signature) cache key into one
    padded/stacked feature tensor, flushed on ``max_batch`` or
    ``max_wait_us``; one batch = ONE binary pass
    (``Engine.submit_batch`` -> ``BinaryExecutor.run_batch``).
  * :class:`OverlayPool` — K overlays (one fixed tile geometry each, one
    CUDA stream each) with cache-affinity routing: a key goes to the
    overlay that already compiled its program, else to the least-loaded
    overlay via the compiler's own LPT greedy (the idle-PE rule).
  * :class:`ServeLoop` — the bounded work queue: admission control /
    backpressure (:class:`QueueFullError`), deterministic drain order,
    and compile/execute overlap across overlays (one worker thread per
    overlay).
  * :class:`Metrics` — per-key and global telemetry (p50/p99 latency,
    throughput, queue depth, batch occupancy, program-cache hit rate)
    exported as a JSON-serializable snapshot.

Quickstart::

    from repro_torch.runtime import OverlayPool

    pool = OverlayPool(n_overlays=2, geometry=geom)   # device="cuda"
    responses = pool.serve(requests, max_batch=8, max_wait_us=2000)
    print(pool.metrics.snapshot(max_batch=8))
"""
from .batcher import Batch, Batcher, request_cost
from .metrics import Metrics, percentile
from .pool import OverlayPool, warm_pool
from .serve_loop import QueueFullError, ServeLoop

__all__ = [
    "Batch", "Batcher", "Metrics", "OverlayPool", "QueueFullError",
    "ServeLoop", "percentile", "request_cost", "warm_pool",
]
