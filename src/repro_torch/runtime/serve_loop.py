"""The host serving loop promised by ``repro_torch.core.passes.schedule``.

(The port's copy of ``repro/runtime/serve_loop.py``, over the port's
engine.  On a CUDA device each overlay's Engine runs on its own stream,
so the per-overlay worker threads overlap on one card.)

The compiler freezes Algorithm 9's dynamic load balance into a static
LPT schedule (SPMD needs determinism); the *dynamic* half lives here: a
bounded work queue feeds whichever overlay drains first, batches form
while overlays are busy, and compile (T_LoC) on one overlay overlaps
execute (T_LoH) on another — the paper's computation/communication
overlap, host edition.

Flow::

    submit(req) --admission--> Batcher --size/deadline flush--> place()
       (QueueFullError on a         (one batch = one cache key)
        full queue = backpressure)        |
                                          v
                              per-overlay FIFO worker
                              (Engine.submit_batch: ONE binary pass)

Determinism: batch composition, flush order, and overlay placement are
all computed in the caller's thread from arrival order alone — thread
timing never changes *what* runs *where*, only when.  With
``overlap_overlays=False`` execution itself is also serialized in
dispatch order (the mode the equivalence tests use).  ``drain()``
returns responses in admission order.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.engine import InferenceRequest, InferenceResponse
from repro_torch.obs.tracer import get_tracer

from .batcher import Batch, Batcher
from .metrics import Metrics
from .pool import OverlayPool


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is full.

    Online callers should shed load or retry after a drain; the offline
    ``serve()`` helper responds by flushing the queue (backpressure)."""


class ServeLoop:
    """Bounded-queue, batching, multi-overlay serving loop."""

    def __init__(self, pool: OverlayPool, *, max_batch: int = 8,
                 max_wait_us: float = 2000.0, max_queue: int = 256,
                 overlap_overlays: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[Metrics] = None) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.pool = pool
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.clock = clock
        self.metrics = metrics if metrics is not None else pool.metrics
        self.batcher = Batcher(max_batch=max_batch,
                               max_wait_us=max_wait_us, clock=clock)
        self._seq = 0
        self._admitted_at: Dict[int, float] = {}
        # Wall-clock admission stamps for tracing only: the loop clock
        # is injectable (tests drive fake clocks), so trace timestamps
        # come from the tracer's perf_counter_ns clock instead.
        self._admitted_ns: Dict[int, int] = {}
        self._results: Dict[int, InferenceResponse] = {}
        self._pins: Dict[int, tuple] = {}    # idx -> (live server, vid)
        self._lock = threading.Lock()
        self._futures: List[Future] = []
        # One single-thread worker per overlay: an overlay's batches run
        # FIFO (it is one device), while different overlays overlap —
        # T_LoC on overlay A under T_LoH on overlay B.
        self._workers: Optional[List[ThreadPoolExecutor]] = None
        if overlap_overlays and len(pool) > 1:
            self._workers = [
                ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix=f"overlay{i}")
                for i in range(len(pool))]

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        return self.batcher.depth

    def submit(self, req: InferenceRequest) -> None:
        """Admit one request (raises :class:`QueueFullError` when the
        queue is at capacity), then dispatch any size- or deadline-due
        batches.

        Live-graph requests (``req.graph`` is a
        ``repro_torch.livegraph.LiveGraphServer`` handle) are resolved HERE,
        at admission: the request pins the version active right now and
        is served on exactly that version's tiles, however many
        cutovers happen before it executes.  The batch key carries the
        version (``OverlayPool.cache_key``), so one batch never mixes
        versions; the pin is released when the response is recorded,
        which is what lets a drained retired version be reclaimed."""
        if self.batcher.depth >= self.max_queue:
            self.metrics.record_rejection()
            raise QueueFullError(
                f"serving queue at capacity ({self.max_queue}); "
                "drain or retry later")
        req, pin = self._resolve_live(req)
        now = self.clock()
        idx = self._seq
        self._seq += 1
        self._admitted_at[idx] = now
        tracer = get_tracer()
        if tracer.enabled:
            self._admitted_ns[idx] = tracer.now_ns()
            tracer.instant("admit", cat="serve", track="queue",
                           args={"request": req.request_id or f"#{idx}",
                                 "depth": self.batcher.depth})
        if pin is not None:
            with self._lock:
                self._pins[idx] = pin
        full = self.batcher.add(self.pool.cache_key(req), req, idx, now)
        self.metrics.record_queue_depth(self.batcher.depth)
        due = ([full] if full is not None else []) + self.batcher.due(now)
        self._dispatch(due)

    @staticmethod
    def _resolve_live(req: InferenceRequest):
        """Swap a live-graph handle for the active version's snapshot,
        pinning the version (see :meth:`submit`)."""
        server = getattr(req.graph, "_live_server", None)
        if server is None:
            return req, None
        version = server.admit()
        return (dataclasses.replace(req, graph=version.as_graph()),
                (server, version.vid))

    def poll(self) -> None:
        """Flush deadline-due batches (call from an idle loop)."""
        self._dispatch(self.batcher.due(self.clock()))

    def flush(self) -> None:
        """Dispatch everything still queued, regardless of deadlines."""
        self._dispatch(self.batcher.flush_all())

    # ------------------------------------------------------------------ #
    def _dispatch(self, batches: Sequence[Batch]) -> None:
        if not batches:
            return
        placements = self.pool.place(batches)
        # prune cleanly-settled futures so online submit()/poll()
        # callers that drain() only periodically don't grow the list
        # without bound; failed ones stay so drain() still raises
        self._futures = [f for f in self._futures
                         if not f.done() or f.exception() is not None]
        for batch, overlay in zip(batches, placements):
            self.metrics.record_batch(batch.key, len(batch))
            if self._workers is not None:
                self._futures.append(self._workers[overlay].submit(
                    self._execute, batch, overlay))
            else:
                self._execute(batch, overlay)

    def _execute(self, batch: Batch, overlay: int) -> None:
        # Clocked at execution start, in the worker: the wait term then
        # covers batching delay AND time spent queued behind earlier
        # batches in this overlay's FIFO — the full experienced latency.
        started = self.clock()
        tracer = get_tracer()
        start_ns = tracer.now_ns() if tracer.enabled else 0
        bspan = tracer.span(
            "batch", cat="serve", track=f"overlay{overlay}",
            args={"key": batch.key[:12], "size": len(batch)})
        resps = self.pool.execute_on(overlay, batch)
        bspan.add(cache_hit=bool(resps and resps[0].cache_hit)).done()
        released = []
        with self._lock:
            for idx, r in zip(batch.indices, resps):
                # experienced latency = queue wait + compile + execute
                wait = started - self._admitted_at.pop(idx)
                self.metrics.record_response(
                    r, wait + r.t_loc + r.t_loh,
                    queue_wait_s=wait, execute_s=r.t_loh,
                    compile_s=r.t_loc)
                adm_ns = self._admitted_ns.pop(idx, None)
                if adm_ns is not None:
                    # Retroactive: admission stamped in the caller's
                    # thread, closed here in the worker at batch start.
                    tracer.complete(
                        "queue_wait", adm_ns, start_ns, cat="serve",
                        track="queue",
                        args={"request": r.request_id,
                              "overlay": overlay})
                self._results[idx] = r
                pin = self._pins.pop(idx, None)
                if pin is not None:
                    released.append(pin)
        # Release version pins outside the loop lock (reclamation takes
        # the live server's own lock; served requests count per version).
        for server, vid in released:
            server.release(vid)

    # ------------------------------------------------------------------ #
    def drain(self) -> List[InferenceResponse]:
        """Flush the queue, wait for all in-flight batches, and return
        every completed response in admission order (resetting the
        completion store).  Online callers must drain periodically:
        completed responses are retained here until collected."""
        self.flush()
        # detach before raising: a failed batch propagates its exception
        # ONCE, instead of poisoning every later drain with a stale error
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()              # propagate worker exceptions
        with self._lock:
            out = [self._results[i] for i in sorted(self._results)]
            self._results.clear()
        return out

    def serve(self, requests: Sequence[InferenceRequest]
              ) -> List[InferenceResponse]:
        """Offline drain of a request stream, responses in request
        order.  A full queue exerts backpressure: the producer blocks on
        a flush instead of raising — nothing is rejected (and nothing
        is counted as rejected in the metrics)."""
        t0 = self.clock()
        for req in requests:
            if self.batcher.depth >= self.max_queue:
                self.flush()
            self.submit(req)
        out = self.drain()
        self.metrics.record_serve_wall(len(out), self.clock() - t0)
        return out

    def shutdown(self) -> None:
        """Stop the per-overlay workers (idempotent)."""
        if self._workers is not None:
            for w in self._workers:
                w.shutdown(wait=True)
            self._workers = None
