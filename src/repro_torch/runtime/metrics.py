"""Serving telemetry for the multi-overlay runtime.

(The port's copy of ``repro/runtime/metrics.py``; standard library only.)

One :class:`Metrics` instance aggregates everything the serving loop
observes — per-request latency, batch occupancy, queue depth, admission
rejections, program-cache behaviour — both globally and per cache key
(i.e. per deployed (model, graph) pair).  ``snapshot()`` exports a plain
JSON-serializable dict so dashboards / benchmark files can consume it
without importing anything from this package.

Latency percentiles use the nearest-rank method over the recorded
samples; sample lists are capped (oldest dropped) so a long-lived
serving process cannot grow without bound.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of unsorted samples."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


class _Series:
    """Latency/occupancy accumulators shared by global and per-key views."""

    def __init__(self, max_samples: int) -> None:
        self.requests = 0
        self.cache_hits = 0
        self.batches = 0
        self.batched_requests = 0       # sum of batch sizes
        self.total_t_loc = 0.0
        self.total_t_loh = 0.0
        self.latencies: Deque[float] = deque(maxlen=max_samples)
        # Phase split (populated when the loop reports it): where a
        # request's experienced latency went — queued vs executing.
        self.waits: Deque[float] = deque(maxlen=max_samples)
        self.executes: Deque[float] = deque(maxlen=max_samples)

    def record(self, resp, latency_s: float,
               queue_wait_s: Optional[float] = None,
               execute_s: Optional[float] = None) -> None:
        self.requests += 1
        self.cache_hits += int(resp.cache_hit)
        self.total_t_loc += resp.t_loc
        self.total_t_loh += resp.t_loh
        self.latencies.append(latency_s)
        if queue_wait_s is not None:
            self.waits.append(queue_wait_s)
        if execute_s is not None:
            self.executes.append(execute_s)

    def record_batch(self, size: int) -> None:
        self.batches += 1
        self.batched_requests += size

    def snapshot(self, max_batch: Optional[int] = None) -> dict:
        lat = list(self.latencies)
        hit_rate = (self.cache_hits / self.requests) if self.requests else 0.0
        mean_batch = (self.batched_requests / self.batches) \
            if self.batches else 0.0
        out = {
            "requests": self.requests,
            "cache_hit_rate": round(hit_rate, 6),
            "p50_latency_ms": round(percentile(lat, 50) * 1e3, 6),
            "p90_latency_ms": round(percentile(lat, 90) * 1e3, 6),
            "p99_latency_ms": round(percentile(lat, 99) * 1e3, 6),
            "max_latency_ms": round(max(lat) * 1e3, 6) if lat else 0.0,
            "batches": self.batches,
            "mean_batch_size": round(mean_batch, 6),
        }
        if self.waits or self.executes:
            w, e = list(self.waits), list(self.executes)
            mean = lambda xs: (sum(xs) / len(xs)) if xs else 0.0  # noqa: E731
            out["queue_wait_ms"] = {
                "mean": round(mean(w) * 1e3, 6),
                "p99": round(percentile(w, 99) * 1e3, 6)}
            out["execute_ms"] = {
                "mean": round(mean(e) * 1e3, 6),
                "p99": round(percentile(e, 99) * 1e3, 6)}
        if max_batch:
            out["batch_occupancy"] = round(mean_batch / max_batch, 6)
        return out


class Metrics:
    """Aggregates serving telemetry; see module docstring."""

    def __init__(self, max_samples: int = 4096) -> None:
        self.max_samples = max_samples
        self._global = _Series(max_samples)
        self._per_key: Dict[str, _Series] = {}
        self._key_names: Dict[str, str] = {}    # key -> "model@graph" label
        self.rejected = 0
        self.max_queue_depth = 0
        self._depth_sum = 0
        self._depth_obs = 0
        self._served = 0
        self._serve_wall = 0.0
        # Live-graph (repro_torch.livegraph) observability: which graph
        # version is active, how often it changed, and how much traffic
        # each version served — version skew made visible.
        self.active_graph_version: Optional[int] = None
        self.cutovers = 0
        self.versions_reclaimed = 0
        self._version_requests: Dict[int, int] = {}
        # Per-cutover version-skew log: requests still pinned to the
        # outgoing version at swap time (bounded; oldest dropped).
        self._cutover_log: Deque[dict] = deque(maxlen=256)
        # Per-request phase samples (latency joined to its breakdown),
        # so a p99 number can be traced to where the time went.
        self._phase_samples: Deque[dict] = deque(maxlen=max_samples)

    # ------------------------------------------------------------------ #
    def _series(self, key: str) -> _Series:
        if key not in self._per_key:
            self._per_key[key] = _Series(self.max_samples)
        return self._per_key[key]

    def record_response(self, resp, latency_s: float,
                        queue_wait_s: Optional[float] = None,
                        execute_s: Optional[float] = None,
                        compile_s: Optional[float] = None) -> None:
        """One completed request.  ``latency_s`` is the full experienced
        latency (queue wait + compile + execute), measured by the loop;
        the optional phase terms feed the wait-vs-execute split and the
        per-request breakdown behind :meth:`slowest`."""
        self._global.record(resp, latency_s, queue_wait_s, execute_s)
        self._series(resp.cache_key).record(resp, latency_s,
                                            queue_wait_s, execute_s)
        self._key_names.setdefault(
            resp.cache_key, f"{resp.model_name}@{resp.graph_name}")
        if queue_wait_s is not None or execute_s is not None:
            self._phase_samples.append({
                "request_id": getattr(resp, "request_id", None),
                "latency_ms": round(latency_s * 1e3, 6),
                "queue_wait_ms": round((queue_wait_s or 0.0) * 1e3, 6),
                "execute_ms": round((execute_s or 0.0) * 1e3, 6),
                "compile_ms": round((compile_s or 0.0) * 1e3, 6),
            })

    def slowest(self, n: int = 5) -> List[dict]:
        """The ``n`` worst recorded requests WITH their phase breakdown
        — how a p99 latency sample is traced to queue wait vs compile
        vs execute (requires the loop to report phase terms)."""
        return sorted(self._phase_samples,
                      key=lambda s: s["latency_ms"],
                      reverse=True)[:n]

    def record_batch(self, key: str, size: int) -> None:
        self._global.record_batch(size)
        self._series(key).record_batch(size)

    def record_queue_depth(self, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, depth)
        self._depth_sum += depth
        self._depth_obs += 1

    def record_rejection(self) -> None:
        self.rejected += 1

    def record_serve_wall(self, n_requests: int, wall_s: float) -> None:
        """Credit a completed serve() drain toward throughput."""
        self._served += n_requests
        self._serve_wall += wall_s

    # ------------------------------------------------------------------ #
    # Live-graph versioning (called by repro_torch.livegraph's server
    # and the serving loop's admission/release path).
    # ------------------------------------------------------------------ #
    def set_active_version(self, vid: int) -> None:
        self.active_graph_version = vid

    def record_cutover(self, from_vid: int, to_vid: int,
                       pinned_old: int = 0) -> None:
        """One zero-downtime version swap completed.  ``pinned_old`` is
        the number of requests still pinned to ``from_vid`` at swap
        time — the per-cutover version skew."""
        self.cutovers += 1
        self.active_graph_version = to_vid
        self._cutover_log.append({"from": from_vid, "to": to_vid,
                                  "pinned_old": int(pinned_old)})

    def record_version_request(self, vid: int) -> None:
        """One request served on graph version ``vid``."""
        self._version_requests[vid] = \
            self._version_requests.get(vid, 0) + 1

    def record_version_reclaimed(self, vid: int) -> None:
        self.versions_reclaimed += 1

    # ------------------------------------------------------------------ #
    @property
    def throughput_rps(self) -> float:
        return self._served / self._serve_wall if self._serve_wall else 0.0

    def snapshot(self, max_batch: Optional[int] = None) -> dict:
        """JSON-serializable view of everything recorded so far."""
        g = self._global.snapshot(max_batch)
        g.update({
            "throughput_rps": round(self.throughput_rps, 6),
            "rejected": self.rejected,
            "max_queue_depth": self.max_queue_depth,
            "mean_queue_depth": round(
                self._depth_sum / self._depth_obs, 6)
            if self._depth_obs else 0.0,
        })
        per_key = {}
        for key, series in self._per_key.items():
            s = series.snapshot(max_batch)
            s["name"] = self._key_names.get(key, key[:12])
            per_key[key] = s
        out = {"global": g, "per_key": per_key}
        if (self.active_graph_version is not None or self.cutovers
                or self._version_requests):
            # Only present when live graphs are in play: snapshots of
            # static-graph deployments are unchanged.
            out["livegraph"] = {
                "active_version": self.active_graph_version,
                "cutovers": self.cutovers,
                "versions_reclaimed": self.versions_reclaimed,
                "requests_per_version": {
                    f"v{k}": v for k, v in
                    sorted(self._version_requests.items())},
                "cutover_log": list(self._cutover_log),
                "max_version_skew": max(
                    (c["pinned_old"] for c in self._cutover_log),
                    default=0),
            }
        return out
