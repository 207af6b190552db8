"""Incremental fiber-shard tile patching (the live half of Step 3).

(The port's copy of ``repro/livegraph/tiles.py``; ``tile_density_stats``
is defined here only, and the port's manifests read it.)

``core/passes/partition.py`` turns a COO graph into (j, k) blocked-ELL
sub-shard tiles.  A delta only touches the tiles its edges fall in —
edge (u, v) lives in exactly tile (v//N1, u//N1) — so this module keeps
the per-tile edge lists as first-class state (:class:`TileStore`) and
rebuilds ONLY the touched tiles, reusing the partitioner's exact layout
rules (dst-major rows, LANE-rounded widths, width_cap slicing).

Two signatures fall out of the per-tile content hashes:

  * **structural signature** — tile grid geometry + the set of
    (j, k, n_slices) entries (+ feat_dim/n_classes, which size builder
    models).  This is everything the *instruction binary* depends on:
    ``kernel_map`` emits instructions per tile slice, and residency /
    placement schedules derive from the same structure.  It is what
    ``engine.graph_signature`` returns for a live version, so the
    program-cache key only changes when the padded geometry actually
    changes — a content-only delta is a guaranteed cache hit.
  * **content signature** — a Merkle-style root over the per-tile
    hashes.  Unchanged tiles keep their hash (they are shared by
    reference across versions), so a delta re-hashes O(touched) tiles,
    not O(all).  It identifies the exact graph *contents* for
    version-skew observability.

Bit-identity with a cold compile is by construction: every edge carries
a birth sequence number (its position in the canonical COO order that
``GraphDelta.apply_to`` produces), rows are ordered (dst, src, seq) —
precisely the stable (dst, src, original-position) order
``partition_graph`` emits — and edge ids (the ``edge_pos`` ELL plane)
come from a stable allocator, free ids reused smallest-first.  Edge-id
*values* differ from a cold compile's, but the executor only requires
them to be internally consistent and collision-free below
``PartitionedGraph.n_edges`` (which the store sets to the id-space
capacity), so outputs match bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.passes.partition import (LANE, ELLTile,
                                               PartitionConfig,
                                               PartitionedGraph)

TileKey = Tuple[int, int]


@dataclasses.dataclass
class TileEdges:
    """Live edges of one (j, k) sub-shard, in ELL emission order
    (sorted by (dst, src, birth-seq); global vertex ids)."""

    src: np.ndarray      # int32 [n]
    dst: np.ndarray      # int32 [n]
    weight: np.ndarray   # float32 [n]
    eid: np.ndarray      # int32 [n]  stable edge ids (the epos plane)
    seq: np.ndarray      # int64 [n]  birth order (canonical COO order)

    @property
    def n(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class PatchStats:
    """What one delta application did to the tile grid."""

    edges_added: int = 0
    edges_removed: int = 0
    vertices_added: int = 0
    tiles_before: int = 0
    tiles_after: int = 0
    tiles_patched: int = 0        # rebuilt in place (key existed before)
    tiles_created: int = 0
    tiles_dropped: int = 0
    structural_change: bool = False
    # "j:k" -> {"nnz", "slices", "width", "density"} for rebuilt tiles
    patched: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def tiles_retained(self) -> int:
        """Tiles shared by reference with the previous version."""
        return self.tiles_after - self.tiles_patched - self.tiles_created

    @property
    def retention(self) -> float:
        return self.tiles_retained / self.tiles_after \
            if self.tiles_after else 1.0

    def as_dict(self) -> dict:
        return {
            "edges_added": self.edges_added,
            "edges_removed": self.edges_removed,
            "vertices_added": self.vertices_added,
            "tiles_before": self.tiles_before,
            "tiles_after": self.tiles_after,
            "tiles_patched": self.tiles_patched,
            "tiles_created": self.tiles_created,
            "tiles_dropped": self.tiles_dropped,
            "tiles_retained": self.tiles_retained,
            "retention": round(self.retention, 6),
            "structural_change": self.structural_change,
        }


# --------------------------------------------------------------------------- #
# Layout helpers — the partitioner's inner loop, factored per tile.
# --------------------------------------------------------------------------- #
def ell_slices(j: int, k: int, te: TileEdges,
               cfg: PartitionConfig) -> List[ELLTile]:
    """One (j, k) edge list -> blocked-ELL slices, bit-identical to the
    corresponding tile of :func:`partition_graph` (same row order, same
    LANE-rounded widths, same width_cap slicing)."""
    n1 = cfg.n1
    ls = (te.src - k * n1).astype(np.int32)
    ld = (te.dst - j * n1).astype(np.int32)
    counts = np.bincount(ld, minlength=n1)
    row_start = np.zeros(n1 + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = (np.arange(te.n) - row_start[ld]).astype(np.int64)
    full_width = int(counts.max()) if te.n else 0
    slices: List[ELLTile] = []
    for s0 in range(0, full_width, cfg.width_cap):
        sel = (slot >= s0) & (slot < s0 + cfg.width_cap)
        if not sel.any():
            continue
        sw = int(counts.clip(s0, s0 + cfg.width_cap).max() - s0)
        width = max(LANE, int(math.ceil(sw / LANE) * LANE))
        cols = np.zeros((n1, width), np.int32)
        vals = np.zeros((n1, width), np.float32)
        epos = np.full((n1, width), -1, np.int32)
        r, c = ld[sel], (slot[sel] - s0).astype(np.int64)
        cols[r, c] = ls[sel]
        vals[r, c] = te.weight[sel]
        epos[r, c] = te.eid[sel]
        slices.append(ELLTile(j, k, cols, vals, epos, nnz=int(sel.sum())))
    return slices


def tile_hash(slices: List[ELLTile]) -> str:
    """Content hash of one tile (all its slices)."""
    h = hashlib.sha1()
    for t in slices:
        h.update(np.int64([t.cols.shape[1], t.nnz]).tobytes())
        h.update(np.ascontiguousarray(t.cols).tobytes())
        h.update(np.ascontiguousarray(t.vals).tobytes())
        h.update(np.ascontiguousarray(t.edge_pos).tobytes())
    return h.hexdigest()


def as_graph_data(pg: PartitionedGraph) -> dict:
    """A PartitionedGraph as runtime ``graph_data`` (the executor's
    Dynasparse-style graph-as-data structure): patched live tiles can
    ride a structurally-matching program as *data* instead of being
    bound in — the route the sampling layer's bucketed serving uses."""
    tiles = {}
    for (j, k), slices in pg.tiles.items():
        for s, t in enumerate(slices):
            tiles[f"{j}:{k}:{s}"] = {
                "cols": t.cols, "vals": t.vals,
                "mask": t.edge_pos >= 0, "epos": t.edge_pos,
            }
    return {"tiles": tiles, "inv_in_degree": pg.inv_in_degree}


def tile_density_stats(pg: PartitionedGraph) -> dict:
    """Per-tile nnz/density summary (manifest ``tile_stats`` section).

    Cheap to compute from the ELL metadata and recorded at every
    compile *and* every live-tile rebind — the bind-time observability
    a Dynasparse-style kernel remapper needs (see ROADMAP)."""
    n1 = pg.config.n1
    tiles: Dict[str, dict] = {}
    total_nnz = 0
    padded_slots = 0
    for (j, k) in sorted(pg.tiles):
        slices = pg.tiles[(j, k)]
        nnz = sum(t.nnz for t in slices)
        width = sum(t.width for t in slices)
        slots = n1 * width
        total_nnz += nnz
        padded_slots += slots
        tiles[f"{j}:{k}"] = {
            "nnz": int(nnz),
            "slices": len(slices),
            "width": int(width),
            "density": round(nnz / slots, 6) if slots else 0.0,
        }
    return {
        "n_tiles": len(tiles),
        "total_nnz": int(total_nnz),
        "padded_slots": int(padded_slots),
        "mean_density": round(total_nnz / padded_slots, 6)
        if padded_slots else 0.0,
        "tiles": tiles,
    }


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class TileStore:
    """Per-tile edge lists + their ELL form + content hashes.

    Immutable by convention: :meth:`apply` returns a NEW store sharing
    every untouched tile (edge lists, ELL slices, hashes) by reference
    — the copy-on-write substrate of ``GraphVersionStore``.
    """

    cfg: PartitionConfig
    n_vertices: int
    n_blocks: int
    feat_dim: int
    n_classes: int
    name: str
    edges: Dict[TileKey, TileEdges]
    tiles: Dict[TileKey, List[ELLTile]]
    hashes: Dict[TileKey, str]
    indeg: np.ndarray            # int64 [nb * n1] live in-degrees
    eid_capacity: int            # edge-id space size (== pgraph.n_edges)
    free_eids: np.ndarray        # int64, sorted ascending
    next_seq: int
    live_edges: int

    # ------------------------------------------------------------------ #
    @classmethod
    def from_graph(cls, g: Graph, cfg: PartitionConfig) -> "TileStore":
        """Initial build — same grouping as :func:`partition_graph`;
        edge ids and birth seqs start as the canonical COO positions."""
        n1 = cfg.n1
        nb = cfg.n_blocks(g.n_vertices)
        order = np.lexsort((g.src, g.dst)).astype(np.int64)
        src, dst = g.src[order], g.dst[order]
        w, eid = g.weight[order], order
        key = (dst // n1).astype(np.int64) * nb + (src // n1)
        korder = np.argsort(key, kind="stable")
        src, dst, w, eid, key = (a[korder]
                                 for a in (src, dst, w, eid, key))
        edges: Dict[TileKey, TileEdges] = {}
        tiles: Dict[TileKey, List[ELLTile]] = {}
        hashes: Dict[TileKey, str] = {}
        uniq = np.unique(key)
        lows = np.searchsorted(key, uniq, side="left")
        highs = np.searchsorted(key, uniq, side="right")
        for uk, lo, hi in zip(uniq, lows, highs):
            jk = (int(uk // nb), int(uk % nb))
            te = TileEdges(src=src[lo:hi].astype(np.int32),
                           dst=dst[lo:hi].astype(np.int32),
                           weight=w[lo:hi].astype(np.float32),
                           eid=eid[lo:hi].astype(np.int32),
                           seq=eid[lo:hi].astype(np.int64))
            edges[jk] = te
            tiles[jk] = ell_slices(jk[0], jk[1], te, cfg)
            hashes[jk] = tile_hash(tiles[jk])
        indeg = np.bincount(g.dst, minlength=nb * n1).astype(np.int64)
        return cls(cfg=cfg, n_vertices=g.n_vertices, n_blocks=nb,
                   feat_dim=g.feat_dim, n_classes=g.n_classes,
                   name=g.name, edges=edges, tiles=tiles, hashes=hashes,
                   indeg=indeg, eid_capacity=g.n_edges,
                   free_eids=np.empty(0, np.int64),
                   next_seq=g.n_edges, live_edges=g.n_edges)

    # ------------------------------------------------------------------ #
    def _tile_key(self, u: int, v: int) -> TileKey:
        return (v // self.cfg.n1, u // self.cfg.n1)

    def apply(self, cd) -> Tuple["TileStore", PatchStats]:
        """One coalesced delta -> (new store, patch stats).  O(touched
        tiles + |V|) — untouched tiles are shared by reference."""
        n1 = self.cfg.n1
        nv = self.n_vertices + cd.n_new_vertices
        nb = max(self.n_blocks, self.cfg.n_blocks(nv))
        stats = PatchStats(vertices_added=cd.n_new_vertices,
                           tiles_before=len(self.edges))

        # Group the delta by touched tile, preserving add arrival order.
        rm_by_tile: Dict[TileKey, List[Tuple[int, int]]] = {}
        for (u, v) in cd.removed_pairs:
            if u >= self.n_vertices or v >= self.n_vertices:
                raise KeyError(f"remove_edge({u}, {v}): endpoint beyond "
                               f"base graph ({self.n_vertices} vertices)")
            rm_by_tile.setdefault(self._tile_key(u, v), []).append((u, v))
        add_by_tile: Dict[TileKey, List[int]] = {}
        for i in range(cd.n_adds):
            jk = self._tile_key(int(cd.add_src[i]), int(cd.add_dst[i]))
            add_by_tile.setdefault(jk, []).append(i)
        touched = sorted(set(rm_by_tile) | set(add_by_tile))

        # Pass 1 — keep masks + freed edge ids per touched tile.
        keep_masks: Dict[TileKey, np.ndarray] = {}
        freed: List[np.ndarray] = []
        removed_dst: List[np.ndarray] = []
        for jk in touched:
            old = self.edges.get(jk)
            pairs = rm_by_tile.get(jk, [])
            if old is None:
                for (u, v) in pairs:
                    if cd.must_exist[(u, v)]:
                        raise KeyError(f"remove_edge({u}, {v}): no such "
                                       f"edge in {self.name!r}")
                continue
            keep = np.ones(old.n, bool)
            if pairs:
                okey = old.src.astype(np.int64) * nv + old.dst
                dead = np.array([u * nv + v for u, v in pairs], np.int64)
                hit = np.isin(okey, dead)
                present = set(np.unique(okey[hit]).tolist())
                for (u, v) in pairs:
                    if cd.must_exist[(u, v)] \
                            and u * nv + v not in present:
                        raise KeyError(f"remove_edge({u}, {v}): no such "
                                       f"edge in {self.name!r}")
                keep = ~hit
                freed.append(old.eid[hit].astype(np.int64))
                removed_dst.append(old.dst[hit])
            keep_masks[jk] = keep

        # Allocate stable edge ids for the adds: reuse freed ids
        # smallest-first (ids freed by THIS delta included), then grow
        # the capacity — keeps the id space (and the executor's
        # edge-valued buffers) near the live edge count under churn.
        pool = np.sort(np.concatenate([self.free_eids] + freed)) \
            if freed else self.free_eids
        n_add = cd.n_adds
        reuse = min(n_add, pool.shape[0])
        fresh = n_add - reuse
        add_eids = np.concatenate([
            pool[:reuse],
            np.arange(self.eid_capacity, self.eid_capacity + fresh,
                      dtype=np.int64)])
        free_eids = pool[reuse:]
        eid_capacity = self.eid_capacity + fresh
        add_seq = np.arange(self.next_seq, self.next_seq + n_add,
                            dtype=np.int64)

        # Pass 2 — rebuild touched tiles (everything else is shared).
        edges = dict(self.edges)
        tiles = dict(self.tiles)
        hashes = dict(self.hashes)
        for jk in touched:
            old = self.edges.get(jk)
            keep = keep_masks.get(jk)
            ai = np.array(add_by_tile.get(jk, []), np.int64)
            parts_src = [cd.add_src[ai]]
            parts_dst = [cd.add_dst[ai]]
            parts_w = [cd.add_weight[ai]]
            parts_eid = [add_eids[ai].astype(np.int32)]
            parts_seq = [add_seq[ai]]
            if old is not None:
                parts_src.insert(0, old.src[keep])
                parts_dst.insert(0, old.dst[keep])
                parts_w.insert(0, old.weight[keep])
                parts_eid.insert(0, old.eid[keep])
                parts_seq.insert(0, old.seq[keep])
            te = TileEdges(
                src=np.concatenate(parts_src).astype(np.int32),
                dst=np.concatenate(parts_dst).astype(np.int32),
                weight=np.concatenate(parts_w).astype(np.float32),
                eid=np.concatenate(parts_eid).astype(np.int32),
                seq=np.concatenate(parts_seq))
            if te.n == 0:
                if old is None:
                    # Adds and removes netted to zero inside a tile
                    # that never existed — nothing to keep.
                    stats.tiles_dropped += 1
                    continue
                # An existing tile emptied by the delta keeps its slice
                # COUNT as zero-nnz LANE-wide slices: the structural
                # signature (and with it the program-cache key and each
                # binary's per-slice instruction addressing) depends on
                # (j, k, n_slices), so preserving the count turns
                # "tile went empty" into a content-only delta.  The
                # bind-time remapper elides these slices as SKIP.
                empty = [
                    ELLTile(jk[0], jk[1],
                            np.zeros((n1, LANE), np.int32),
                            np.zeros((n1, LANE), np.float32),
                            np.full((n1, LANE), -1, np.int32), nnz=0)
                    for _ in self.tiles[jk]]
                edges[jk] = te
                tiles[jk] = empty
                hashes[jk] = tile_hash(empty)
                stats.tiles_patched += 1
                stats.patched[f"{jk[0]}:{jk[1]}"] = {
                    "nnz": 0, "slices": len(empty),
                    "width": sum(t.width for t in empty),
                    "density": 0.0,
                }
                continue
            # (dst, src, birth-seq): the partitioner's stable
            # (dst, src, COO-position) order, reproduced incrementally.
            order = np.lexsort((te.seq, te.src, te.dst))
            te = TileEdges(src=te.src[order], dst=te.dst[order],
                           weight=te.weight[order], eid=te.eid[order],
                           seq=te.seq[order])
            edges[jk] = te
            tiles[jk] = ell_slices(jk[0], jk[1], te, self.cfg)
            hashes[jk] = tile_hash(tiles[jk])
            if old is None:
                stats.tiles_created += 1
            else:
                stats.tiles_patched += 1
            width = sum(t.width for t in tiles[jk])
            stats.patched[f"{jk[0]}:{jk[1]}"] = {
                "nnz": te.n, "slices": len(tiles[jk]), "width": width,
                "density": round(te.n / (n1 * width), 6) if width else 0.0,
            }

        n_removed = int(sum(a.shape[0] for a in freed))
        stats.edges_added = n_add
        stats.edges_removed = n_removed
        stats.tiles_after = len(edges)

        indeg = np.zeros(nb * n1, np.int64)
        indeg[:self.indeg.shape[0]] = self.indeg
        for d in removed_dst:
            np.subtract.at(indeg, d, 1)
        if n_add:
            np.add.at(indeg, cd.add_dst, 1)

        new = TileStore(
            cfg=self.cfg, n_vertices=nv, n_blocks=nb,
            feat_dim=self.feat_dim, n_classes=self.n_classes,
            name=self.name, edges=edges, tiles=tiles, hashes=hashes,
            indeg=indeg, eid_capacity=eid_capacity, free_eids=free_eids,
            next_seq=self.next_seq + n_add,
            live_edges=self.live_edges + n_add - n_removed)
        stats.structural_change = \
            new.structural_signature() != self.structural_signature()
        return new, stats

    # ------------------------------------------------------------------ #
    # Signatures (see module docstring).
    # ------------------------------------------------------------------ #
    def structural_signature(self) -> str:
        """Everything the instruction binary depends on; memoized —
        stores are immutable after construction."""
        cached = self.__dict__.get("_structural_sig")
        if cached is None:
            h = hashlib.sha1()
            h.update(f"live|{self.cfg.n1}:{self.cfg.n2}:"
                     f"{self.cfg.width_cap}|{self.n_blocks}|"
                     f"{self.feat_dim}:{self.n_classes}".encode())
            for (j, k) in sorted(self.tiles):
                h.update(f"|{j}:{k}:{len(self.tiles[(j, k)])}".encode())
            cached = h.hexdigest()
            self.__dict__["_structural_sig"] = cached
        return cached

    def content_signature(self) -> str:
        """Merkle-style root over the per-tile hashes (memoized).
        Unchanged tiles keep their leaf hash across versions, so a
        delta re-hashes O(touched) leaves + one O(tiles) fold."""
        cached = self.__dict__.get("_content_sig")
        if cached is None:
            h = hashlib.sha1(self.structural_signature().encode())
            for jk in sorted(self.hashes):
                h.update(f"|{jk[0]}:{jk[1]}:{self.hashes[jk]}".encode())
            cached = h.hexdigest()
            self.__dict__["_content_sig"] = cached
        return cached

    # ------------------------------------------------------------------ #
    def build_pgraph(self) -> PartitionedGraph:
        """Assemble the PartitionedGraph the executor consumes.

        ``n_edges`` is the edge-id *capacity*, not the live edge count:
        the executor sizes edge-valued buffers ``n_edges + 1`` and pads
        with index ``n_edges``, so every stable edge id stays in range
        and the pad slot never collides with a live id."""
        inv = (1.0 / np.maximum(self.indeg.astype(np.float32), 1.0)
               ).astype(np.float32)
        return PartitionedGraph(
            config=self.cfg, n_vertices=self.n_vertices,
            n_edges=self.eid_capacity, n_blocks=self.n_blocks,
            tiles=dict(self.tiles), inv_in_degree=inv)

    def as_coo(self) -> Graph:
        """Materialize the canonical COO graph (edges in birth order) —
        identical, edge for edge, to chaining ``GraphDelta.apply_to``
        over the version history."""
        if self.edges:
            src = np.concatenate([te.src for te in self.edges.values()])
            dst = np.concatenate([te.dst for te in self.edges.values()])
            w = np.concatenate([te.weight for te in self.edges.values()])
            seq = np.concatenate([te.seq for te in self.edges.values()])
            order = np.argsort(seq, kind="stable")
            src, dst, w = src[order], dst[order], w[order]
        else:
            src = np.empty(0, np.int32)
            dst = np.empty(0, np.int32)
            w = np.empty(0, np.float32)
        return Graph(n_vertices=self.n_vertices, src=src, dst=dst,
                     weight=w, feat_dim=self.feat_dim,
                     n_classes=self.n_classes, name=self.name)
