"""Geometry buckets: pad sampled subgraphs into canonical ELL layouts.

A copy of ``repro/sampling/buckets.py`` (numpy only; a test holds the two
equal on the same inputs).

Sampled ego networks have wildly varying (|V|, |E|, max degree); compiled
one-by-one they would thrash the engine's program cache (every request
pays T_LoC).  Following Dynasparse (arXiv 2303.12901) the variability is
absorbed at *runtime* by data-layout normalization instead:

  * a :class:`Bucket` rounds (|V|, max in-degree, |E|) up to powers of
    two — the subgraph "geometry";
  * :func:`template_graph` builds ONE deterministic graph per bucket
    whose fiber-shard partition is the bucket's *canonical layout*:
    every (shard j, sub-shard k) pair present, exactly one ELL slice,
    width exactly ``bucket.width``.  The engine compiles this template
    once; its cache key is the bucket's identity;
  * :func:`layout_graph` lays ANY subgraph that fits the bucket into
    that same canonical layout as plain arrays (``graph_data``) — the
    per-request topology the executor consumes *as data*, one lane of a
    batch each.

Padding is inert by construction: empty ELL slots are zero-weight
self-referencing entries (col 0, val 0, mask off) — the blocked-ELL
equivalent of zero-weight self-edges — and padded vertices are zero
feature rows, so padded execution is bit-identical to the unpadded
subgraph run (asserted end-to-end in ``tests/test_torch_sampling.py``).

With all requests in a bucket sharing one template graph object, the
``(model schema, graph signature, geometry)`` program-cache key collides
across users, and the runtime ``Batcher`` coalesces their requests into
one binary pass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.passes.partition import LANE, PartitionConfig


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Power-of-two geometry class of a (padded) subgraph."""

    n_vertices: int      # V rounded up to a power of two (>= LANE)
    n_edges: int         # E rounded up (see bucket_for for the bounds)
    width: int           # canonical ELL width >= max in-degree
    feat_dim: int
    n_classes: int

    @property
    def key(self) -> str:
        return (f"v{self.n_vertices}-e{self.n_edges}-w{self.width}-"
                f"f{self.feat_dim}-c{self.n_classes}")

    def n_blocks(self, n1: int) -> int:
        return -(-self.n_vertices // n1)


def bucket_for(g: Graph, cfg: PartitionConfig) -> Bucket:
    """Smallest bucket that admits ``g`` under tile geometry ``cfg``.

    The canonical layout gives every (dst row, source block) pair
    ``width`` ELL slots, so it admits any subgraph whose max in-degree
    is <= ``width``; |E| is rounded up to a power of two but kept within
    [template minimum, layout capacity] so the template itself is
    constructible (see :func:`template_graph`).
    """
    v = max(next_pow2(max(g.n_vertices, 1)), LANE)
    indeg = np.bincount(g.dst, minlength=g.n_vertices) if g.n_edges \
        else np.zeros(1, np.int64)
    width = max(next_pow2(int(indeg.max())), LANE)
    if width > cfg.width_cap:
        raise ValueError(
            f"max in-degree {int(indeg.max())} needs ELL width {width} "
            f"> width_cap {cfg.width_cap}; raise the cap or lower the "
            "sampling fanouts")
    nb = -(-v // cfg.n1)
    e = next_pow2(max(g.n_edges, 1))
    e = max(e, nb * nb * width)          # template floor: fill every tile
    e = min(e, v * nb * width)           # layout capacity ceiling
    return Bucket(n_vertices=v, n_edges=e, width=width,
                  feat_dim=g.feat_dim, n_classes=g.n_classes)


def template_graph(bucket: Bucket, cfg: PartitionConfig) -> Graph:
    """The bucket's canonical compile-time graph.

    Deterministic COO whose :func:`~repro_torch.core.passes.partition.
    partition_graph` output is exactly the canonical layout: all
    ``nb x nb`` (j, k) tile pairs populated, one ELL slice each, width
    exactly ``bucket.width`` (the width-defining run is ``width``
    parallel edges on the first row of every pair).  Edge *values* are
    placeholders — per-request topology arrives as ``graph_data``.
    """
    n1 = cfg.n1
    v, w, e = bucket.n_vertices, bucket.width, bucket.n_edges
    nb = bucket.n_blocks(n1)
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    pos = 0
    used: Dict[tuple, int] = {}
    for j in range(nb):                  # width-defining full rows
        for k in range(nb):
            src[pos:pos + w] = k * n1
            dst[pos:pos + w] = j * n1
            pos += w
            used[(j * n1, k)] = w
    for d in range(v):                   # spread the remainder
        if pos >= e:
            break
        for k in range(nb):
            room = w - used.get((d, k), 0)
            take = min(room, e - pos)
            if take <= 0:
                continue
            src[pos:pos + take] = k * n1
            dst[pos:pos + take] = d
            pos += take
            if pos >= e:
                break
    if pos != e:                         # cannot happen: e <= v * nb * w
        raise AssertionError(
            f"template for bucket {bucket.key} placed {pos}/{e} edges")
    return Graph(n_vertices=v, src=src, dst=dst,
                 weight=np.ones(e, np.float32),
                 feat_dim=bucket.feat_dim, n_classes=bucket.n_classes,
                 name=f"bucket:{bucket.key}")


def layout_graph(g: Graph, bucket: Bucket,
                 cfg: PartitionConfig) -> Dict[str, object]:
    """Lay a subgraph into the bucket's canonical layout as arrays.

    Returns the ``graph_data`` structure the binary executor consumes in
    place of the program's baked tiles::

        {"tiles": {"j:k:0": {"cols", "vals", "mask", "epos"}, ...},
         "inv_in_degree": float32 [nb * n1]}

    Edge placement mirrors ``partition_graph`` exactly — (dst, src)
    sorted, per-row slots in that order, ``epos`` = original COO edge
    index, pad slots ``epos == -1`` — so padded execution reproduces the
    unpadded program's arithmetic bit for bit.
    """
    n1 = cfg.n1
    nb = bucket.n_blocks(n1)
    w = bucket.width
    if g.n_vertices > bucket.n_vertices or g.n_edges > bucket.n_edges:
        raise ValueError(
            f"graph (V={g.n_vertices}, E={g.n_edges}) exceeds bucket "
            f"{bucket.key}")

    order = np.lexsort((g.src, g.dst))
    src = g.src[order].astype(np.int64)
    dst = g.dst[order].astype(np.int64)
    val = g.weight[order].astype(np.float32)
    eid = order.astype(np.int32)

    cols = np.zeros((nb, nb, n1, w), np.int32)
    vals = np.zeros((nb, nb, n1, w), np.float32)
    mask = np.zeros((nb, nb, n1, w), bool)
    epos = np.full((nb, nb, n1, w), -1, np.int32)

    # slot index = rank of the edge within its (dst, src-block) run,
    # computed vectorized over the (dst, src)-sorted stream.
    j = dst // n1
    k = src // n1
    run = dst * nb + k                   # (dst row, source block) run id
    if run.shape[0]:
        change = np.empty(run.shape[0], bool)
        change[0] = True
        np.not_equal(run[1:], run[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        slot = np.arange(run.shape[0]) - np.repeat(
            starts, np.diff(np.append(starts, run.shape[0])))
        if slot.size and int(slot.max()) >= w:
            raise ValueError(
                f"in-degree run exceeds bucket width {w} "
                f"(bucket {bucket.key} mismatched to graph)")
        r = dst % n1
        cols[j, k, r, slot] = (src % n1).astype(np.int32)
        vals[j, k, r, slot] = val
        mask[j, k, r, slot] = True
        epos[j, k, r, slot] = eid

    tiles = {f"{jj}:{kk}:0": {
        "cols": cols[jj, kk], "vals": vals[jj, kk],
        "mask": mask[jj, kk], "epos": epos[jj, kk]}
        for jj in range(nb) for kk in range(nb)}
    indeg = np.bincount(g.dst, minlength=nb * n1).astype(np.float32)
    inv = (1.0 / np.maximum(indeg, 1.0)).astype(np.float32)
    return {"tiles": tiles, "inv_in_degree": inv}
