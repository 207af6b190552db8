"""Compiler Step 3 — fiber-shard data partitioning (paper §6.5, Fig. 8).

The adjacency matrix A is split into *shards* of N1 rows; each shard into
*sub-shards* of N1 columns.  The feature matrix H is split into *fibers* of
N2 columns; each fiber into *sub-fibers* of N1 rows.  Every layer consumes
and produces the same (N1, N2) layout, so no inter-layer repartitioning is
needed (partition-centric execution, Algorithms 6-8).

TPU adaptation (see DESIGN.md §2): each sub-shard is stored as a *blocked
ELL* tile — rows sorted, per-row edges contiguous, padded to the tile's max
row degree (rounded to a multiple of 8 lanes).  Destination-sorting at
compile time replaces the FPGA's runtime RAW-hazard reorder unit; ELL
row-ownership replaces the banked-SRAM shuffle networks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from ..graph import Graph

LANE = 8  # pad max-nnz to a multiple of this (TPU sublane friendliness)


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    n1: int               # rows per shard == cols per sub-shard
    n2: int               # feature columns per fiber
    vmem_budget_bytes: int = 0  # informational: what drove the choice
    width_cap: int = 512  # max ELL width; wider rows are sliced into
                          # multiple accumulating tiles (power-law guard)

    def n_blocks(self, n_vertices: int) -> int:
        return math.ceil(n_vertices / self.n1)

    def n_fibers(self, f: int) -> int:
        return math.ceil(f / self.n2)


def choose_partition(
    n_vertices: int,
    f_max: int,
    vmem_budget_bytes: int = 3 << 20,   # paper: 3MB Feature Buffer per PE
    dtype_bytes: int = 4,
    n1_cap: int = 16384,                # paper: N_F1 = 16384
) -> PartitionConfig:
    """Pick (N1, N2) so a feature sub-fiber tile fits the buffer budget.

    Mirrors the paper's buffer sizing: N1 is the largest power of two such
    that an N1 x N2 tile (plus double-buffering already accounted in the
    budget) fits, capped by N_F1 and |V|."""
    n2 = min(128, max(LANE, 1 << (max(f_max, 1) - 1).bit_length()
                      if f_max < 128 else 128))
    n1 = 1 << int(math.log2(max(vmem_budget_bytes // (n2 * dtype_bytes), LANE)))
    n1 = int(min(n1, n1_cap))
    # Do not over-partition tiny graphs.
    while n1 >= 2 * n_vertices and n1 > LANE:
        n1 //= 2
    return PartitionConfig(n1=n1, n2=n2, vmem_budget_bytes=vmem_budget_bytes)


@dataclasses.dataclass
class ELLTile:
    """Sub-shard A(j, k) in blocked-ELL form (dst-major)."""

    shard_row: int            # j: destination block index
    shard_col: int            # k: source block index
    cols: np.ndarray          # int32 [n1, width] local src index, 0 pad
    vals: np.ndarray          # float32 [n1, width], 0 pad
    edge_pos: np.ndarray      # int32 [n1, width] global edge id, -1 pad
    nnz: int                  # true number of edges in this tile

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])


@dataclasses.dataclass
class PartitionedGraph:
    config: PartitionConfig
    n_vertices: int
    n_edges: int
    n_blocks: int
    # (j, k) -> one or more ELL slices (several when a row block exceeds
    # the width cap; slices accumulate into the same output tile).
    tiles: Dict[Tuple[int, int], List[ELLTile]]
    # For MEAN aggregation: 1/in-degree per vertex (padded length).
    inv_in_degree: np.ndarray

    def tile_bytes(self) -> int:
        return sum(t.cols.nbytes + t.vals.nbytes + t.edge_pos.nbytes
                   for ts in self.tiles.values() for t in ts)

    def total_nnz(self) -> int:
        return sum(t.nnz for ts in self.tiles.values() for t in ts)

    # -------------------------------------------------------------- #
    # Working-set sizing for the partition-centric streaming executor
    # (one destination shard resident at a time, Algorithms 6-8).
    # -------------------------------------------------------------- #
    def subfiber_bytes(self, f_pad: int, dtype_bytes: int = 4) -> int:
        """Bytes of one staged source block: an [n1, f_pad] sub-fiber."""
        return self.config.n1 * int(f_pad) * dtype_bytes

    def shard_tile_bytes(self, j: int) -> int:
        """Bytes of destination shard ``j``'s sub-shard tiles (row j of
        the (j, k) tile grid) — the EDGE-buffer half of its working set."""
        return sum(t.cols.nbytes + t.vals.nbytes + t.edge_pos.nbytes
                   for k in range(self.n_blocks)
                   for t in self.tiles.get((j, k), []))

    def shard_working_set_bytes(self, j: int, sources, f_pad: int) -> int:
        """Device bytes to stage destination shard ``j``: its tiles plus
        the source sub-fibers ``sources`` it gathers from."""
        return (self.shard_tile_bytes(j)
                + len(set(sources)) * self.subfiber_bytes(f_pad))


# --------------------------------------------------------------------------- #
# Device-placement halo sets (multi-device partition-centric execution).
#
# When destination shards are placed on the devices of a mesh, each device
# owns the output sub-fibers of its assigned row blocks.  For a given
# layer, the *halo set* of a device is the set of source blocks its shards
# gather from but it does not own — exactly the sub-fibers that must move
# over the interconnect before the layer can run.  Computing the sets at
# compile time makes the exchange volume a manifest fact, the software
# analogue of the paper's compile-time data-movement plan.
# --------------------------------------------------------------------------- #
def halo_sets(assignment: List[int], sources: Dict[str, List[int]],
              n_devices: int) -> List[List[int]]:
    """Per-device halo sets for one layer.

    ``assignment`` maps row block -> owning device (LPT output);
    ``sources`` is the layer's residency table (destination shard ->
    source blocks it gathers from, stringified keys as in the manifest).
    Returns, per device, the sorted source blocks it needs but does not
    own.  Layers whose shards only read their own row block (GEMM,
    vector-add, activations) get empty halo sets.
    """
    owned: List[set] = [set() for _ in range(n_devices)]
    for j, d in enumerate(assignment):
        owned[d].add(j)
    need: List[set] = [set() for _ in range(n_devices)]
    for js, ks in sources.items():
        d = assignment[int(js)]
        need[d].update(int(k) for k in ks)
    return [sorted(need[d] - owned[d]) for d in range(n_devices)]


def partition_graph(g: Graph, cfg: PartitionConfig) -> PartitionedGraph:
    """COO -> fiber-shard blocked-ELL tiles.  O(|V| + |E|) (paper §8.1)."""
    n1 = cfg.n1
    nb = cfg.n_blocks(g.n_vertices)
    gs = g.sorted_by_dst()
    src, dst, w = gs.src, gs.dst, gs.weight
    eid = np.lexsort((g.src, g.dst)).astype(np.int32)  # original edge ids

    jb = dst // n1
    kb = src // n1
    key = jb.astype(np.int64) * nb + kb
    order = np.argsort(key, kind="stable")
    src, dst, w, eid, key = (a[order] for a in (src, dst, w, eid, key))

    tiles: Dict[Tuple[int, int], List[ELLTile]] = {}
    uniq = np.unique(key)
    lows = np.searchsorted(key, uniq, side="left")
    highs = np.searchsorted(key, uniq, side="right")
    for uk, lo, hi in zip(uniq, lows, highs):
        j, k = int(uk // nb), int(uk % nb)
        ls = (src[lo:hi] - k * n1).astype(np.int32)
        ld = (dst[lo:hi] - j * n1).astype(np.int32)
        lw = w[lo:hi]
        le = eid[lo:hi]
        # rows are dst-sorted already; per-row slot index:
        counts = np.bincount(ld, minlength=n1)
        row_start = np.zeros(n1 + 1, np.int64)
        np.cumsum(counts, out=row_start[1:])
        slot = (np.arange(hi - lo) - row_start[ld]).astype(np.int64)
        full_width = int(counts.max())
        slices = []
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
            vals[r, c] = lw[sel]
            epos[r, c] = le[sel]
            slices.append(ELLTile(j, k, cols, vals, epos,
                                  nnz=int(sel.sum())))
        tiles[(j, k)] = slices

    indeg = np.bincount(g.dst, minlength=nb * n1).astype(np.float32)
    inv = 1.0 / np.maximum(indeg, 1.0)
    return PartitionedGraph(
        config=cfg, n_vertices=g.n_vertices, n_edges=g.n_edges,
        n_blocks=nb, tiles=tiles, inv_in_degree=inv.astype(np.float32),
    )
