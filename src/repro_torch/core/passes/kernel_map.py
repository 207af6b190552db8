"""Compiler Step 4a — kernel mapping (paper §6.6).

Each IR layer becomes a **Layer Block**: one Control-and-Scheduling
Instruction (CSI) plus a set of **Tiling Blocks** obtained by unfolding the
outer loops of the partition-centric execution scheme (Algorithms 6-8).
A Tiling Block is an inseparable instruction sequence executed by one PE.

Mode selection: Aggregate -> SpDMM mode, Linear -> GEMM mode,
Vector-Inner -> SDDMM mode, Vector-Add -> vector-addition mode,
standalone Activation/BatchNorm -> ACT/AFFINE epilogue instructions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from ..ir import Activation, LayerIR, LayerType, ModelIR
from ..isa import (FLAG_ACC, FLAG_LAST, FLAG_LOCK, FLAG_UNLOCK, Buf, Instr,
                   Opcode, Region)
from .partition import PartitionedGraph


@dataclasses.dataclass
class TilingBlock:
    layer_id: int
    kind: str                      # spdmm | gemm | sddmm | vadd | act | affine
    out_i: int                     # output fiber index (or -1)
    out_j: int                     # output row-block / shard-row (or -1)
    k_list: List[Tuple[int, int]]  # reduction steps: (block, slice) pairs
    cost: float                    # scheduler load estimate
    instrs: List[Instr] = dataclasses.field(default_factory=list)
    pe: int = 0                    # assigned by the scheduler
    tile_k: int = -1               # sddmm: source block index
    slice_id: int = 0              # sddmm: ELL width slice index


@dataclasses.dataclass
class LayerBlock:
    layer_id: int
    layer: LayerIR
    csi: Instr
    tiling_blocks: List[TilingBlock]


@dataclasses.dataclass
class Program:
    model: ModelIR
    pgraph: PartitionedGraph
    layer_blocks: List[LayerBlock]
    n_pes: int
    f_pad: Dict[int, Tuple[int, int]]  # layer -> (padded f_in, padded f_out)

    def all_instrs(self) -> List[Instr]:
        out: List[Instr] = []
        for lb in self.layer_blocks:
            out.append(lb.csi)
            for tb in lb.tiling_blocks:
                out.extend(tb.instrs)
        out.append(Instr(Opcode.HALT))
        return out

    def instruction_count(self) -> int:
        return len(self.all_instrs())


def _epilogue(l: LayerIR, instrs: List[Instr], on_edges: bool) -> None:
    """Fused scale/shift + activation epilogue instructions."""
    if "fused_scale" in l.attrs:
        instrs.append(Instr(Opcode.AFFINE, on_edges=on_edges,
                            args=(l.layer_id, 0, 0, 0)))
    if "fused_act" in l.attrs:
        instrs.append(Instr(Opcode.ACT, act=int(l.attrs["fused_act"]),
                            act_en=True, on_edges=on_edges,
                            args=(l.layer_id, 0, 0, 0)))


def map_layer(
    l: LayerIR, pg: PartitionedGraph, nb: int
) -> List[TilingBlock]:
    cfg = pg.config
    n1, n2 = cfg.n1, cfg.n2
    fi = max(1, math.ceil(l.f_in / n2))
    fo = max(1, math.ceil(l.f_out / n2))
    blocks: List[TilingBlock] = []

    if l.layer_type == LayerType.AGGREGATE:
        dyn = 1 if "edge_weight_layer" in l.attrs else 0
        for i in range(fi):                      # fiber loop  (Alg. 6 line 2)
            for j in range(nb):                  # shard loop  (Alg. 6 line 3)
                ks: List[Tuple[int, int]] = []
                ins: List[Instr] = []
                nnz_total = 0
                for k in range(nb):
                    for s, t in enumerate(pg.tiles.get((j, k), [])):
                        ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                         args=(Buf.EDGE, Region.SUBSHARD,
                                               j, k), arg4=t.nnz))
                        ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                         args=(Buf.FEATURE, Region.SUBFIBER,
                                               i, k)))
                        if dyn:
                            ins.append(Instr(
                                Opcode.MEM_RD,
                                args=(Buf.EDGE, Region.EDGE_WEIGHTS, j, k)))
                        acc = FLAG_ACC if ks else 0
                        # args[3] packs (ELL slice << 1 | dyn) so the
                        # runtime can address pg.tiles[(j, k)][s].
                        ins.append(Instr(Opcode.SPDMM,
                                         flags=FLAG_UNLOCK | acc,
                                         args=(j, k, i, (s << 1) | dyn),
                                         arg4=t.nnz))
                        ks.append((k, s))
                        nnz_total += t.nnz
                _epilogue(l, ins, on_edges=False)
                ins.append(Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                                 args=(Buf.RESULT, Region.OUT_SUBFIBER,
                                       i, j)))
                # Load estimate in the same units as the sddmm branch and
                # the conformance oracle (work scales with the layer's
                # feature width, not the padded fiber tile).
                blocks.append(TilingBlock(
                    l.layer_id, "spdmm", i, j, ks,
                    cost=max(nnz_total, 1) * l.f_in, instrs=ins))

    elif l.layer_type == LayerType.LINEAR:
        for i in range(fo):                      # output fiber
            for j in range(nb):                  # row block
                ins = []
                ks = []
                for k in range(fi):              # reduction over input fibers
                    ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                     args=(Buf.FEATURE, Region.SUBFIBER,
                                           k, j)))
                    ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                     args=(Buf.WEIGHT, Region.WEIGHT_BLOCK,
                                           k, i)))
                    acc = FLAG_ACC if ks else 0
                    ins.append(Instr(Opcode.GEMM, flags=FLAG_UNLOCK | acc,
                                     args=(j, k, i, 0),
                                     arg4=n1 * n2 * n2))
                    ks.append((k, 0))
                _epilogue(l, ins, on_edges=False)
                ins.append(Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                                 args=(Buf.RESULT, Region.OUT_SUBFIBER,
                                       i, j)))
                blocks.append(TilingBlock(
                    l.layer_id, "gemm", i, j, ks,
                    cost=2.0 * n1 * n2 * n2 * fi, instrs=ins))

    elif l.layer_type == LayerType.VECTOR_INNER:
        for (j, k), slices in sorted(pg.tiles.items()):   # Alg. 7
            for s, t in enumerate(slices):
                ins = [Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                             args=(Buf.EDGE, Region.SUBSHARD, j, k),
                             arg4=t.nnz)]
                ks = []
                for i in range(fi):
                    ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                     args=(Buf.FEATURE, Region.SUBFIBER,
                                           i, j)))
                    ins.append(Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                                     args=(Buf.FEATURE, Region.SUBFIBER,
                                           i, k)))
                    acc = FLAG_ACC if ks else 0
                    ins.append(Instr(Opcode.SDDMM, flags=FLAG_UNLOCK | acc,
                                     args=(j, k, i, s), arg4=t.nnz))
                    ks.append((i, 0))
                _epilogue(l, ins, on_edges=True)
                ins.append(Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                                 args=(Buf.RESULT, Region.OUT_EDGE, j, k)))
                blocks.append(TilingBlock(
                    l.layer_id, "sddmm", -1, j, ks,
                    cost=max(t.nnz, 1) * l.f_in, instrs=ins,
                    tile_k=k, slice_id=s))

    elif l.layer_type == LayerType.VECTOR_ADD:
        for i in range(fi):                      # Alg. 8
            for j in range(nb):
                ins = [
                    Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                          args=(Buf.FEATURE, Region.SUBFIBER, i, j)),
                    Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                          args=(Buf.FEATURE, Region.SUBFIBER, i, j)),
                    Instr(Opcode.VADD, flags=FLAG_UNLOCK,
                          args=(i, j, 0, 0)),
                ]
                _epilogue(l, ins, on_edges=False)
                ins.append(Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                                 args=(Buf.RESULT, Region.OUT_SUBFIBER,
                                       i, j)))
                blocks.append(TilingBlock(
                    l.layer_id, "vadd", i, j, [], cost=n1 * n2, instrs=ins))

    elif l.layer_type in (LayerType.ACTIVATION, LayerType.BATCHNORM):
        on_edges = bool(l.attrs.get("on_edges"))
        op = (Opcode.AFFINE if l.layer_type == LayerType.BATCHNORM
              else Opcode.ACT)
        if on_edges:
            # One tiling block per edge tile.
            for (j, k), slices in sorted(pg.tiles.items()):
                for s, t in enumerate(slices):
                    ins = [
                        Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                              args=(Buf.EDGE, Region.EDGE_WEIGHTS, j, k)),
                        Instr(op, act=int(l.act), act_en=True, on_edges=True,
                              flags=FLAG_UNLOCK, args=(l.layer_id, j, k, s)),
                        Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                              args=(Buf.RESULT, Region.OUT_EDGE, j, k)),
                    ]
                    blocks.append(TilingBlock(
                        l.layer_id, "act", -1, j, [(k, s)],
                        cost=max(t.nnz, 1), instrs=ins))
        else:
            for i in range(fi):
                for j in range(nb):
                    ins = [
                        Instr(Opcode.MEM_RD, flags=FLAG_LOCK,
                              args=(Buf.FEATURE, Region.SUBFIBER, i, j)),
                        Instr(op, act=int(l.act), act_en=l.act_enabled,
                              flags=FLAG_UNLOCK, args=(l.layer_id, i, j, 0)),
                        Instr(Opcode.MEM_WR, flags=FLAG_LAST,
                              args=(Buf.RESULT, Region.OUT_SUBFIBER, i, j)),
                    ]
                    blocks.append(TilingBlock(
                        l.layer_id,
                        "affine" if op == Opcode.AFFINE else "act",
                        i, j, [], cost=n1 * n2, instrs=ins))
    else:
        raise ValueError(l.layer_type)
    return blocks


def run(m: ModelIR, pg: PartitionedGraph, n_pes: int = 8) -> Program:
    nb = pg.n_blocks
    layer_blocks: List[LayerBlock] = []
    f_pad: Dict[int, Tuple[int, int]] = {}
    for lid in m.topo_order():
        l = m.layers[lid]
        tbs = map_layer(l, pg, nb)
        # The CSI act field is the layer's mode selector (ISA v3): AggOp
        # for AGGREGATE, Activation for ACTIVATION, 1 for pair-sum
        # VECTOR_INNER — so the runtime dispatches from the binary alone.
        if l.layer_type == LayerType.AGGREGATE:
            mode = int(l.agg_op)
        elif l.layer_type == LayerType.VECTOR_INNER:
            mode = 1 if l.attrs.get("mode") == "pair_sum" else 0
        else:
            mode = int(l.act)
        csi = Instr(Opcode.CSI, act=mode, act_en=l.act_enabled,
                    on_edges=bool(l.attrs.get("on_edges"))
                    or l.layer_type == LayerType.VECTOR_INNER,
                    args=(lid, int(l.layer_type), l.f_in, l.f_out),
                    arg4=len(tbs))
        layer_blocks.append(LayerBlock(lid, l, csi, tbs))
        n2 = pg.config.n2
        f_pad[lid] = (math.ceil(max(l.f_in, 1) / n2) * n2,
                      math.ceil(max(l.f_out, 1) / n2) * n2)
    return Program(model=m, pgraph=pg, layer_blocks=layer_blocks,
                   n_pes=n_pes, f_pad=f_pad)
