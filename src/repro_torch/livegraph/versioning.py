"""Copy-on-write graph versions — immutable snapshots sharing tiles.

(The port's copy of ``repro/livegraph/versioning.py``.  What the port
adds: a new version holds the staged copies of the tiles it shares with
its parent (:meth:`GraphVersionStore.apply`), and reclaiming a version
frees its own (:meth:`GraphVersion.release_bindings`).)

A :class:`GraphVersionStore` holds the lineage of a deployed graph:
version 0 is the initial partitioning, and every applied
:class:`~repro_torch.livegraph.delta.GraphDelta` appends one immutable
:class:`GraphVersion`.  Versions share everything a delta did not touch
— per-tile edge lists, ELL slices, and content hashes are all held by
reference — so K small deltas cost O(K x touched), not O(K x graph).

A version owns the executor-facing views of its snapshot:

  * ``pgraph``      — the :class:`PartitionedGraph` the executor stages
    (the device-resident and host-streaming paths read ``prog.pgraph``
    at staging time, so patched tiles flow through every residency
    transparently; the port's executor shares the staged copies of
    untouched tiles with the parent version);
  * ``as_graph()``  — the materialized canonical COO (lazy, cached):
    what a cold compile would consume, and what the sampling layer's
    CSR view builds from;
  * ``bind(prog)``  — rebind a structurally-matching compiled program
    to this version's tiles.  The bound copy is cached per program
    cache key: a fresh object whose ``pgraph`` is the version's, and a
    *stable* one, so steady-state traffic on one version reuses its
    staged tiles.  Its manifest is a
    shallow copy carrying this version's ``tile_stats`` and graph name.

The store is NOT the serving cutover mechanism — that is
``livegraph.swap.LiveGraphServer``, which pins versions across request
lifetimes and reclaims drained ones via :meth:`GraphVersionStore.drop`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.core.graph import Graph
from repro_torch.core.passes.partition import PartitionConfig

from .delta import GraphDelta
from .tiles import PatchStats, TileStore, tile_density_stats


class GraphVersion:
    """One immutable snapshot of a live graph."""

    def __init__(self, vid: int, store: TileStore,
                 stats: Optional[PatchStats] = None) -> None:
        self.vid = vid
        self.store = store
        self.stats = stats
        self.pgraph = store.build_pgraph()
        self._graph: Optional[Graph] = None
        # key -> (source binary, bound program).  The source binary is
        # kept separately because rebinding may itself rewrite the
        # binary (incremental remap below), so ``bound.binary`` is not
        # a stable identity for "did the caller hand us a new program".
        self._bound: Dict[str, Tuple[bytes, object]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    @property
    def n_vertices(self) -> int:
        return self.store.n_vertices

    @property
    def live_edges(self) -> int:
        return self.store.live_edges

    @property
    def graph_name(self) -> str:
        return f"{self.store.name}@v{self.vid}"

    @property
    def structural_signature(self) -> str:
        return self.store.structural_signature()

    @property
    def content_signature(self) -> str:
        return self.store.content_signature()

    # ------------------------------------------------------------------ #
    def as_graph(self) -> Graph:
        """Materialized canonical COO (lazy, cached).  The result
        carries a ``_live_version`` backref, which is how the engine
        recognizes versioned graphs: ``graph_signature`` then returns
        the structural signature (an O(1) lookup — content-only deltas
        keep the program-cache key) and ``compile``/``submit`` rebind
        cache hits to this version's tiles."""
        with self._lock:
            if self._graph is None:
                g = self.store.as_coo()
                g.name = self.graph_name
                g.__dict__["_live_version"] = self
                self._graph = g
            return self._graph

    def bind(self, prog):
        """Rebind a compiled program to this version's tiles (cached
        per program cache key; see module docstring)."""
        if prog.pgraph is self.pgraph:
            return prog
        mine = self.pgraph.config
        theirs = prog.pgraph.config
        if (theirs.n1, theirs.n2, theirs.width_cap) != \
                (mine.n1, mine.n2, mine.width_cap):
            raise ValueError(
                "cannot bind program compiled for tile geometry "
                f"(n1, n2, cap)=({theirs.n1}, {theirs.n2}, "
                f"{theirs.width_cap}) to a live graph partitioned at "
                f"({mine.n1}, {mine.n2}, {mine.width_cap}); give the "
                "Engine and the GraphVersionStore the same geometry")
        key = prog.cache_key or f"id:{id(prog)}"
        with self._lock:
            entry = self._bound.get(key)
            if entry is not None and entry[0] is prog.binary:
                return entry[1]
            manifest = dict(prog.manifest)
            geo = dict(manifest.get("geometry", {}))
            geo.update(n_vertices=self.pgraph.n_vertices,
                       n_edges=self.pgraph.n_edges,
                       n_blocks=self.pgraph.n_blocks)
            manifest["geometry"] = geo
            manifest["graph_name"] = self.graph_name
            manifest["graph_version"] = self.vid
            manifest["content_signature"] = self.content_signature
            manifest["tile_stats"] = tile_density_stats(self.pgraph)
            bound = dataclasses.replace(
                prog, pgraph=self.pgraph, manifest=manifest,
                source=None)
            if manifest.get("remap") is not None:
                bound = self._rebind_remap(bound)
            self._bound[key] = (prog.binary, bound)
            return bound

    def _rebind_remap(self, bound):
        """Re-run the sparsity-adaptive remapper against this version's
        tile densities.  A delta version (``self.stats`` is set) only
        re-prices the tiles its delta actually patched — untouched
        tiles keep their encoded mode and record entry verbatim; a
        version with no patch record re-prices everything."""
        from repro_torch.core.passes.remap import remap_program

        rec = bound.manifest["remap"]
        only = None
        if self.stats is not None:
            only = sorted(self.stats.patched)
            if not only:
                return bound
        return remap_program(
            bound, source="tile_stats",
            constants=rec.get("constants"),
            margin=float(rec.get("margin", 0.1)),
            only_tiles=only)

    def release_bindings(self) -> None:
        """Drop the bound-program cache and this version's staged tiles
        (reclaim path): the device copies and pinned host buffers of the
        tiles no other version holds are freed, shared ones stay."""
        from repro_torch.engine.executor import release_staging
        with self._lock:
            self._bound.clear()
        release_staging(self.pgraph)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"GraphVersion(v{self.vid}, |V|={self.n_vertices}, "
                f"|E|={self.live_edges}, "
                f"tiles={len(self.store.tiles)})")


# --------------------------------------------------------------------------- #
class GraphVersionStore:
    """Lineage of a live graph; apply deltas, hold/share versions.

    ``geometry`` must match the Engine(s) that will serve this graph —
    the store partitions with it, and :meth:`GraphVersion.bind` refuses
    a mismatch.  Thread-safe: ``apply`` serializes writers; readers see
    immutable versions.
    """

    def __init__(self, graph: Graph, geometry: PartitionConfig,
                 name: Optional[str] = None) -> None:
        if geometry is None:
            raise ValueError(
                "GraphVersionStore needs an explicit PartitionConfig "
                "(the same one the serving Engine is fixed at)")
        g = graph if name is None else dataclasses.replace(
            graph, name=name)
        self._lock = threading.Lock()
        v0 = GraphVersion(0, TileStore.from_graph(g, geometry))
        self._versions: Dict[int, GraphVersion] = {0: v0}
        self._head = v0
        self._next_vid = 1

    # ------------------------------------------------------------------ #
    @property
    def head(self) -> GraphVersion:
        return self._head

    def get(self, vid: int) -> Optional[GraphVersion]:
        with self._lock:
            return self._versions.get(vid)

    def versions(self) -> Dict[int, GraphVersion]:
        with self._lock:
            return dict(self._versions)

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)

    # ------------------------------------------------------------------ #
    def apply(self, delta: GraphDelta) -> GraphVersion:
        """Head + delta -> new head version (copy-on-write).

        Also invalidates the cached views of the previous head's
        materialized graph (CSR adjacency, signature memos): holders of
        "the live graph" re-resolve instead of silently reading the
        pre-delta adjacency out of a memo.
        """
        with self._lock:
            base = self._head
            if delta.base_vertices != base.n_vertices:
                raise ValueError(
                    f"delta recorded against {delta.base_vertices} "
                    f"vertices, head version v{base.vid} has "
                    f"{base.n_vertices}")
            store, stats = base.store.apply(delta.coalesce())
            v = GraphVersion(self._next_vid, store, stats=stats)
            # The port's addition: wherever the base is staged, the new
            # version holds the copies of the tiles it shares with it,
            # so reclaiming the base frees only the base's own tiles.
            from repro_torch.engine.executor import inherit_staging
            inherit_staging(v.pgraph, base.pgraph)
            self._next_vid += 1
            self._versions[v.vid] = v
            self._head = v
            if base._graph is not None:
                base._graph.invalidate_views()
            return v

    def drop(self, vid: int) -> bool:
        """Forget a non-head version (its uniquely-owned tiles and
        bound programs become collectable).  Returns True if dropped."""
        with self._lock:
            if vid == self._head.vid:
                return False
            v = self._versions.pop(vid, None)
            if v is not None:
                v.release_bindings()
            return v is not None
