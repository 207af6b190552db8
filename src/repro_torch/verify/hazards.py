"""Hazard graph derivation — RAW/WAR/WAW edges over Tiling Blocks.

The FPGA overlay resolves hazards in hardware (the paper's
lock/unlock-annotated double-buffer WAR protection and its
destination-sorting RAW reorder unit); the software overlay resolves
them by construction (layer-sequential dispatch).  Either way the
*true* dependence structure is a property of the binary, and this
module makes it explicit:

  * tile-level edges between Tiling Blocks (RAW: a block reads a value
    another block wrote; WAW/WAR only arise in malformed programs —
    duplicate defs — and are reported, not tolerated);
  * layer-level edges (the coarse DAG the streaming and mesh paths
    sequence by);
  * staging/halo dependencies: which producer layers each destination
    shard's h2d working set and each device's halo exchange read —
    the edges the JAX package's dynamic race detector
    (``repro.verify.race``) checks recorded traces against.

``dep_graph_manifest`` folds the graph into ``.gagi`` manifests — the
input contract for the ROADMAP's scoreboard-issue executor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.ir import LayerType

from .model import DefUseModel, TileOp, ValueKey, layer_consumes

# Tile-level node/edge lists beyond this many edges are summarized
# (layer-level edges are always emitted): million-vertex programs have
# millions of tile edges and the manifest is a JSON file.
DEP_GRAPH_TILE_EDGE_CAP = 20000


@dataclasses.dataclass
class HazardGraph:
    ops: List[TileOp]
    # (src node, dst node, kind) with kind in {"RAW", "WAR", "WAW"}
    edges: List[Tuple[int, int, str]]
    # (producer lid, consumer lid, "RAW") — layer-boundary dependencies
    layer_edges: List[Tuple[int, int, str]]
    # (lid, shard j) -> producer lids whose outputs the shard's staged
    # working set reads (h2d staging dependencies, -1 = input features)
    stage_deps: Dict[Tuple[int, int], Set[int]]

    @property
    def counts(self) -> Dict[str, int]:
        c = {"RAW": 0, "WAR": 0, "WAW": 0}
        for _, _, kind in self.edges:
            c[kind] += 1
        return c


def build_hazards(model: DefUseModel, lmeta: dict) -> HazardGraph:
    """Derive every hazard edge from the def/use model."""
    ops = model.ops
    def_nodes: Dict[ValueKey, List[int]] = {}
    use_nodes: Dict[ValueKey, List[int]] = {}
    for op in ops:
        for d in op.defs:
            def_nodes.setdefault(d, []).append(op.node_id)
        for u in op.uses:
            use_nodes.setdefault(u, []).append(op.node_id)

    edges: Set[Tuple[int, int, str]] = set()
    # RAW: use after def (and WAR's malformed cousin: def after use of a
    # value someone else owns).
    for u, readers in use_nodes.items():
        writers = def_nodes.get(u)
        if not writers:
            continue
        for r in readers:
            prior = [w for w in writers if w < r]
            if prior:
                edges.add((prior[-1], r, "RAW"))
            later = [w for w in writers if w > r]
            for w in later:
                edges.add((r, w, "WAR"))
    # WAW: duplicate defs of one value.
    for v, writers in def_nodes.items():
        for a, b in zip(writers, writers[1:]):
            edges.add((a, b, "WAW"))

    # Layer-boundary RAW edges from the manifest layer table.
    layer_edges: List[Tuple[int, int, str]] = []
    present = {lp.layer_id for lp in model.plan.layers}
    for lp in model.plan.layers:
        meta = lmeta.get(str(lp.layer_id), {})
        for c in layer_consumes(meta, lp.layer_type):
            if c >= 0 and c in present:
                layer_edges.append((int(c), lp.layer_id, "RAW"))

    # Staging dependencies: shard (lid, j)'s working set reads the
    # sub-fibers of every source block its tiles use — produced by the
    # layers those "v" uses name.
    stage_deps: Dict[Tuple[int, int], Set[int]] = {}
    for op in ops:
        j = _out_shard(op)
        if j < 0:
            continue
        dep = stage_deps.setdefault((op.layer_id, j), set())
        for u in op.uses:
            if u[0] in ("v", "e"):
                dep.add(int(u[1]))
    return HazardGraph(ops=ops, edges=sorted(edges),
                       layer_edges=layer_edges, stage_deps=stage_deps)


def _out_shard(op: TileOp) -> int:
    """Destination row block of a tile op (the streaming path's shard
    coordinate), from its defs."""
    for d in op.defs:
        if d[0] == "v":
            return int(d[3])
        if d[0] == "e":
            return int(d[2])
    return -1


def sources_by_shard(model: DefUseModel
                     ) -> Dict[int, Dict[int, Set[int]]]:
    """lid -> destination shard j -> source blocks its tiles gather
    from — the def/use re-derivation of the residency ``sources``
    tables (and the halo-set ingredient)."""
    out: Dict[int, Dict[int, Set[int]]] = {}
    for lp in model.plan.layers:
        lt = lp.layer_type
        shard_sources: Dict[int, Set[int]] = {}
        for tp in lp.tiles:
            j = tp.out_j
            if j < 0:
                continue
            e = shard_sources.setdefault(j, set())
            if lt == LayerType.AGGREGATE:
                e.update(int(ins.args[1]) for ins in tp.compute)
            elif lt == LayerType.VECTOR_INNER:
                e.add(int(j))
                e.add(int(tp.tile_k))
            elif not lp.on_edges:
                e.add(int(j))
        out[lp.layer_id] = shard_sources
    return out


# --------------------------------------------------------------------------- #
def dep_graph_manifest(model: DefUseModel, lmeta: dict,
                       hazards: Optional[HazardGraph] = None,
                       tile_edge_cap: int = DEP_GRAPH_TILE_EDGE_CAP
                       ) -> dict:
    """JSON-ready ``dep_graph`` manifest section.

    Layer-level structure is always complete; tile-level nodes/edges
    are included up to ``tile_edge_cap`` edges and marked ``truncated``
    beyond it (the counts stay exact either way)."""
    hz = hazards if hazards is not None else build_hazards(model, lmeta)
    counts = hz.counts
    layers = [{
        "id": int(lp.layer_id),
        "step": step,
        "type": int(lp.layer_type),
        "n_tiles": len(lp.tiles),
        "instr_lo": int(lp.instr_lo),
        "instr_hi": int(lp.instr_hi),
    } for step, lp in enumerate(model.plan.layers)]
    out = {
        "version": 1,
        "layers": layers,
        "layer_edges": [[int(a), int(b), kind]
                        for a, b, kind in hz.layer_edges],
        "n_tile_nodes": len(hz.ops),
        "n_tile_edges": len(hz.edges),
        "edge_counts": counts,
        "truncated": len(hz.edges) > tile_edge_cap,
    }
    if not out["truncated"]:
        out["tile_nodes"] = [[int(op.layer_id), int(op.tile_idx),
                              int(op.instr_lo), int(op.instr_hi),
                              int(op.pe)] for op in hz.ops]
        out["tile_edges"] = [[int(a), int(b), kind]
                             for a, b, kind in hz.edges]
    return out
