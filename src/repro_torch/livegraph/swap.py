"""Zero-downtime version cutover for the serving runtime.

(The port's copy of ``repro/livegraph/swap.py``.)

:class:`LiveGraphServer` is the *handle* a live graph is served
through: requests are built with ``graph=server`` (it quacks enough
like a :class:`~repro_torch.core.graph.Graph` for cost estimation and
naming), and the admission points — ``ServeLoop.submit``,
``Engine.submit`` / ``submit_batch`` — resolve the handle to the
active :class:`GraphVersion` at admission time via :meth:`admit`,
which pins the version with an inflight refcount.

The cutover protocol (the "swap") is then just bookkeeping:

  1. ``apply(delta)`` builds version N+1 in the
     :class:`GraphVersionStore` (copy-on-write; O(touched tiles)) and
     atomically makes it the active version — *new* admissions route to
     N+1 immediately;
  2. requests already admitted against N keep their pin and finish on
     N's tiles — no request is ever dropped or served a half-patched
     graph (a version is immutable);
  3. when a retired version's inflight count drains to zero it is
     reclaimed: dropped from the store, its bound-program cache
     released, its uniquely-owned tiles left to the collector.  Tiles
     shared with live versions survive by reference.

Because a content-only delta keeps the structural signature, the
program-cache entry compiled for version N serves N+1 as well — the
admission path rebinds it to the new tiles (``GraphVersion.bind``)
without recompiling, so a cutover costs O(touched tiles), never T_LoC.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.obs.tracer import get_tracer

from .delta import GraphDelta
from .versioning import GraphVersion, GraphVersionStore


class LiveGraphServer:
    """Versioned serving handle over a :class:`GraphVersionStore`."""

    def __init__(self, store: GraphVersionStore, *,
                 metrics=None) -> None:
        self.store = store
        self.metrics = metrics
        self._lock = threading.Lock()
        self._active = store.head
        self._inflight: Dict[int, int] = {self._active.vid: 0}
        self._retired: Set[int] = set()
        self._served: Dict[int, int] = {}
        self.cutovers = 0
        self.reclaimed: List[int] = []
        # Duck-type marker: the engine/runtime admission points detect a
        # live handle via `getattr(graph, "_live_server", None)`.
        self._live_server = self
        if metrics is not None:
            metrics.set_active_version(self._active.vid)

    # ------------------------------------------------------------------ #
    # Graph-ish surface: enough for request_cost / builders / naming
    # before admission resolves the handle to a concrete version.
    # ------------------------------------------------------------------ #
    @property
    def active(self) -> GraphVersion:
        with self._lock:
            return self._active

    @property
    def n_vertices(self) -> int:
        return self.active.n_vertices

    @property
    def n_edges(self) -> int:
        return self.active.live_edges

    @property
    def feat_dim(self) -> int:
        return self.active.store.feat_dim

    @property
    def n_classes(self) -> int:
        return self.active.store.n_classes

    @property
    def name(self) -> str:
        return self.active.graph_name

    # ------------------------------------------------------------------ #
    # Pinning protocol.
    # ------------------------------------------------------------------ #
    def admit(self) -> GraphVersion:
        """Pin the active version for one request; pair with
        :meth:`release` when the request completes (or fails)."""
        with self._lock:
            v = self._active
            self._inflight[v.vid] = self._inflight.get(v.vid, 0) + 1
            return v

    def release(self, vid: int, served: bool = True) -> None:
        """Unpin; reclaim a retired version once it drains."""
        with self._lock:
            left = self._inflight.get(vid, 0) - 1
            self._inflight[vid] = max(left, 0)
            if served:
                self._served[vid] = self._served.get(vid, 0) + 1
                if self.metrics is not None:
                    self.metrics.record_version_request(vid)
            if left <= 0 and vid in self._retired:
                self._reclaim(vid)

    def _reclaim(self, vid: int) -> None:
        # caller holds the lock
        self._retired.discard(vid)
        self._inflight.pop(vid, None)
        if self.store.drop(vid):
            self.reclaimed.append(vid)
            if self.metrics is not None:
                self.metrics.record_version_reclaimed(vid)
            get_tracer().instant("reclaim", cat="livegraph",
                                 track="livegraph", args={"vid": vid})

    # ------------------------------------------------------------------ #
    # Cutover.
    # ------------------------------------------------------------------ #
    def apply(self, delta: GraphDelta) -> GraphVersion:
        """Apply a delta and cut over to the new version (see module
        docstring).  Returns the new active version."""
        new = self.store.apply(delta)
        return self.cutover(new)

    def cutover(self, version: GraphVersion) -> GraphVersion:
        """Atomically retire the active version in favor of
        ``version``; drained retirees are reclaimed on the spot."""
        with self._lock:
            old = self._active
            if version.vid == old.vid:
                return old
            self._active = version
            self._inflight.setdefault(version.vid, 0)
            self._retired.discard(version.vid)   # rollback re-arms it
            self.cutovers += 1
            self._retired.add(old.vid)
            pinned_old = self._inflight.get(old.vid, 0)
            if self.metrics is not None:
                self.metrics.record_cutover(old.vid, version.vid,
                                            pinned_old=pinned_old)
            get_tracer().instant(
                "cutover", cat="livegraph", track="livegraph",
                args={"from": old.vid, "to": version.vid,
                      "pinned_old": pinned_old})
            if pinned_old <= 0:
                self._reclaim(old.vid)
            return version

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """JSON-serializable serving-side version state."""
        with self._lock:
            return {
                "active_version": self._active.vid,
                "cutovers": self.cutovers,
                "inflight": {f"v{k}": v for k, v in
                             sorted(self._inflight.items()) if v},
                "requests_per_version": {
                    f"v{k}": v for k, v in sorted(self._served.items())},
                "versions_held": len(self.store),
                "versions_reclaimed": list(self.reclaimed),
                "content_signature": self._active.content_signature,
                "structural_signature":
                    self._active.structural_signature,
            }


# --------------------------------------------------------------------------- #
# Admission-point helpers (duck-typed so engine/runtime need no import
# of this package on their hot paths).
# --------------------------------------------------------------------------- #
def resolve_version(graph) -> Optional[GraphVersion]:
    """The version a graph-ish object denotes right now: a live handle
    resolves to its active version, a materialized version graph to its
    backing version, anything else to ``None``.  Does NOT pin."""
    server = getattr(graph, "_live_server", None)
    if server is not None:
        return server.active
    return getattr(graph, "_live_version", None)


def admit(graph) -> Tuple[object, Optional[Tuple[LiveGraphServer, int]]]:
    """Admission-time resolution: live handles are pinned (admit) and
    swapped for the active version's materialized graph; everything
    else passes through.  Returns ``(graph, pin)`` — callers must
    ``pin[0].release(pin[1])`` when the request completes."""
    server = getattr(graph, "_live_server", None)
    if server is None:
        return graph, None
    version = server.admit()
    return version.as_graph(), (server, version.vid)
