"""Def/use model of a decoded GraphAGILE program.

The 128-bit binary is the runtime's only dispatch source, so the static
analyzer re-derives what each Tiling Block *reads* and *writes* purely
from decoded instruction fields (plus the manifest's layer table for
operand indirections the ISA cannot carry: parent ids, vector-add
operands, the edge-weight layer).  Values are tile-granular:

  ("v", lid, i, j)      vertex sub-fiber tile: fiber i, row block j of
                        layer ``lid``'s output (lid = -1: input features)
  ("e", lid, j, k, s)   edge-valued output of layer ``lid`` for graph
                        tile (j, k), ELL width slice s
  ("g", j, k, s)        graph ELL tile (read-only input)
  ("w", lid, k, i)      weight block W(k, i) of a LINEAR layer

This is exactly the granularity the executor dispatches at, so RAW
edges over these values are the true inter-instruction dependencies —
the scoreboard input the ROADMAP's ISA-v4 item needs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.ir import LayerType
from repro_torch.engine.decoder import ExecutionPlan, LayerPlan, TilePlan

ValueKey = Tuple


def _fibers(f: int, n2: int) -> int:
    return max(1, math.ceil(max(f, 0) / n2))


def layer_consumes(meta: dict, layer_type: LayerType) -> List[int]:
    """Value ids a layer reads (-1 = input features), mirroring
    ``repro_torch.core.passes.schedule._layer_consumes`` but reading the
    manifest layer table instead of IR attrs."""
    ewl = meta.get("edge_weight_layer")
    feat_parents = [p for p in meta.get("parents", []) if p != ewl]
    if layer_type == LayerType.VECTOR_ADD:
        consumed = [int(o) for o in meta.get("operands", [])]
    else:
        consumed = [int(feat_parents[0]) if feat_parents else -1]
    if ewl is not None:
        consumed.append(int(ewl))
    return consumed


@dataclasses.dataclass
class TileOp:
    """One Tiling Block as a def/use node."""

    node_id: int                 # stream-ordered
    layer_id: int
    step: int                    # layer position in the stream
    tile_idx: int                # position within the layer
    pe: int
    kind: str                    # spdmm | gemm | sddmm | vadd | act | affine
    instr_lo: int
    instr_hi: int
    defs: List[ValueKey] = dataclasses.field(default_factory=list)
    uses: List[ValueKey] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DefUseModel:
    plan: ExecutionPlan
    ops: List[TileOp]
    predefined: Set[ValueKey]            # inputs, graph tiles, weights
    n1: int
    n2: int
    nb: int
    # lid -> "v" (vertex-valued output) or "e" (edge-valued output)
    layer_kind: Dict[int, str] = dataclasses.field(default_factory=dict)
    # False when no tile universe was supplied: ("g", ...) uses are then
    # treated as always-defined (existence unverifiable).
    graph_tiles_known: bool = True

    def ops_of_layer(self, lid: int) -> List[TileOp]:
        return [op for op in self.ops if op.layer_id == lid]


_TILE_KINDS = {
    LayerType.AGGREGATE: "spdmm",
    LayerType.LINEAR: "gemm",
    LayerType.VECTOR_INNER: "sddmm",
    LayerType.VECTOR_ADD: "vadd",
    LayerType.ACTIVATION: "act",
    LayerType.BATCHNORM: "affine",
}


def _tile_defs_uses(lp: LayerPlan, tp: TilePlan, meta: dict
                    ) -> Tuple[List[ValueKey], List[ValueKey]]:
    """Defs and uses of one decoded Tiling Block, from instruction
    fields + the layer's manifest entry."""
    lid = lp.layer_id
    lt = lp.layer_type
    ewl = meta.get("edge_weight_layer")
    feat_parents = [p for p in meta.get("parents", []) if p != ewl]
    parent = int(feat_parents[0]) if feat_parents else -1

    defs: List[ValueKey] = []
    uses: List[ValueKey] = []
    if lt == LayerType.AGGREGATE:
        defs.append(("v", lid, tp.out_i, tp.out_j))
        for ins in tp.compute:
            j, k, i, packed = ins.args
            s, dyn = packed >> 1, packed & 1
            uses.append(("v", parent, i, k))
            uses.append(("g", j, k, s))
            if dyn:
                uses.append(("e", int(ewl) if ewl is not None else -1,
                             j, k, s))
    elif lt == LayerType.LINEAR:
        defs.append(("v", lid, tp.out_i, tp.out_j))
        for ins in tp.compute:
            j, k, i, _ = ins.args
            uses.append(("v", parent, k, j))
            uses.append(("w", lid, k, i))
    elif lt == LayerType.VECTOR_INNER:
        defs.append(("e", lid, tp.out_j, tp.tile_k, tp.slice_id))
        for ins in tp.compute:
            j, k, i, s = ins.args
            uses.append(("v", parent, i, j))
            uses.append(("v", parent, i, k))
        if tp.compute:
            uses.append(("g", tp.out_j, tp.tile_k, tp.slice_id))
    elif lt == LayerType.VECTOR_ADD:
        defs.append(("v", lid, tp.out_i, tp.out_j))
        ops = [int(o) for o in meta.get("operands", [])]
        for o in ops:
            uses.append(("v", o, tp.out_i, tp.out_j))
    elif lt in (LayerType.ACTIVATION, LayerType.BATCHNORM):
        if lp.on_edges:
            defs.append(("e", lid, tp.out_j, tp.tile_k, tp.slice_id))
            uses.append(("e", parent, tp.out_j, tp.tile_k, tp.slice_id))
        else:
            defs.append(("v", lid, tp.out_i, tp.out_j))
            uses.append(("v", parent, tp.out_i, tp.out_j))
    # Deduplicate uses, preserving order (a fiber re-read costs nothing
    # and would double-count hazard edges).
    seen: Set[ValueKey] = set()
    uses = [u for u in uses if not (u in seen or seen.add(u))]
    return defs, uses


def build_model(plan: ExecutionPlan, lmeta: dict, geometry: dict,
                pgraph=None,
                tile_slices: Optional[Dict[Tuple[int, int], int]] = None
                ) -> DefUseModel:
    """Decode plan + manifest layer table -> def/use model.

    ``geometry`` is the manifest ``geometry`` section (n1/n2/n_blocks);
    ``pgraph`` (optional) contributes the exact graph-tile universe —
    without it, pass ``tile_slices`` (see
    :func:`tile_slices_from_stats`) or graph-tile existence goes
    unchecked.
    """
    n1, n2 = int(geometry["n1"]), int(geometry["n2"])
    nb = int(geometry["n_blocks"])

    predefined: Set[ValueKey] = set()
    # Graph tiles: the (j, k, s) universe.
    slices: Optional[Dict[Tuple[int, int], int]] = None
    if pgraph is not None:
        slices = {(j, k): len(sl) for (j, k), sl in pgraph.tiles.items()}
    elif tile_slices is not None:
        slices = tile_slices
    graph_tiles_known = slices is not None
    if slices is not None:
        for (j, k), n in slices.items():
            for s in range(n):
                predefined.add(("g", j, k, s))

    layer_kind: Dict[int, str] = {}
    for lp in plan.layers:
        edge = (lp.layer_type == LayerType.VECTOR_INNER or lp.on_edges)
        layer_kind[lp.layer_id] = "e" if edge else "v"
        meta = lmeta.get(str(lp.layer_id), {})
        # Input features: every (i, j) fiber tile a -1 consumer can read.
        if -1 in layer_consumes(meta, lp.layer_type):
            for i in range(_fibers(lp.f_in, n2)):
                for j in range(nb):
                    predefined.add(("v", -1, i, j))
        # Weight blocks of LINEAR layers are manifest payload, always
        # present for the announced (f_in, f_out) grid.
        if lp.layer_type == LayerType.LINEAR:
            for k in range(_fibers(lp.f_in, n2)):
                for i in range(_fibers(lp.f_out, n2)):
                    predefined.add(("w", lp.layer_id, k, i))

    ops: List[TileOp] = []
    for step, lp in enumerate(plan.layers):
        meta = lmeta.get(str(lp.layer_id), {})
        kind = _TILE_KINDS.get(lp.layer_type, "?")
        for t_idx, tp in enumerate(lp.tiles):
            defs, uses = _tile_defs_uses(lp, tp, meta)
            ops.append(TileOp(
                node_id=len(ops), layer_id=lp.layer_id, step=step,
                tile_idx=t_idx, pe=tp.pe, kind=kind,
                instr_lo=tp.instr_lo, instr_hi=tp.instr_hi,
                defs=defs, uses=uses))
    return DefUseModel(plan=plan, ops=ops, predefined=predefined,
                       n1=n1, n2=n2, nb=nb, layer_kind=layer_kind,
                       graph_tiles_known=graph_tiles_known)


def tile_slices_from_stats(tile_stats: dict
                           ) -> Dict[Tuple[int, int], int]:
    """(j, k) -> slice count from a manifest ``tile_stats`` section —
    the graph-tile universe when no :class:`PartitionedGraph` is at
    hand (bytes + manifest verification)."""
    out: Dict[Tuple[int, int], int] = {}
    for key, rec in tile_stats.get("tiles", {}).items():
        j, k = key.split(":")
        out[(int(j), int(k))] = int(rec.get("slices", 1))
    return out
