"""Binary decoder: 128-bit instruction stream -> execution plan.

This is the software analogue of the overlay's Instruction Queue +
scheduler (paper §5.2): the serialized binary is split at CSI boundaries
into Layer Blocks, each Layer Block into Tiling Blocks delimited by the
FLAG_LAST MEM_WR, and every dispatch fact the executor needs — kernel
kind, output tile coordinates, reduction steps, fused epilogues, PE
assignment — is read back out of instruction fields.  No IR objects are
consulted; the ISA is load-bearing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.ir import LayerType
from repro_torch.core.isa import FLAG_LAST, Instr, Opcode, Region, disassemble

_COMPUTE_OPS = (Opcode.GEMM, Opcode.SPDMM, Opcode.SDDMM, Opcode.VADD)


@dataclasses.dataclass
class TilePlan:
    """One decoded Tiling Block: an inseparable sequence for one PE."""

    pe: int
    compute: List[Instr]                 # compute instrs, stream order
    epilogue: List[Tuple[str, int]]      # ("affine", 0) / ("act", act_id)
    out_i: int = -1                      # output fiber (vertex-valued)
    out_j: int = -1                      # output row-block / shard row
    tile_k: int = -1                     # edge-valued: source block
    slice_id: int = 0                    # edge-valued: ELL width slice
    instr_lo: int = -1                   # first instruction index of block
    instr_hi: int = -1                   # FLAG_LAST MEM_WR index (inclusive)


@dataclasses.dataclass
class LayerPlan:
    """One decoded Layer Block (CSI + its tiling blocks)."""

    layer_id: int
    layer_type: LayerType
    f_in: int
    f_out: int
    mode: int            # CSI act field: AggOp / Activation / pair-sum
    act_enabled: bool
    on_edges: bool
    tiles: List[TilePlan]
    instr_lo: int = -1                   # CSI instruction index
    instr_hi: int = -1                   # last instruction index (inclusive)


@dataclasses.dataclass
class ExecutionPlan:
    layers: List[LayerPlan]

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def _close_tile(layer: LayerPlan, instrs: List[Instr],
                base: int = -1) -> TilePlan:
    lt = layer.layer_type
    standalone_act = lt in (LayerType.ACTIVATION, LayerType.BATCHNORM)
    compute: List[Instr] = []
    epilogue: List[Tuple[str, int]] = []
    tp = TilePlan(pe=0, compute=compute, epilogue=epilogue)
    for off, ins in enumerate(instrs):
        if ins.op in _COMPUTE_OPS:
            compute.append(ins)
        elif ins.op in (Opcode.ACT, Opcode.AFFINE):
            if standalone_act:
                compute.append(ins)
            elif ins.op == Opcode.AFFINE:
                epilogue.append(("affine", 0))
            else:
                epilogue.append(("act", ins.act))
        elif ins.op == Opcode.MEM_WR:
            tp.pe = ins.pe
            try:
                region = Region(ins.args[1])
            except ValueError:
                where = base + off if base >= 0 else off
                raise ValueError(
                    f"malformed program: instruction {where} MEM_WR "
                    f"names unknown region {ins.args[1]} (valid: "
                    f"0..{max(Region)})") from None
            if region == Region.OUT_SUBFIBER:
                tp.out_i, tp.out_j = ins.args[2], ins.args[3]
            else:                                   # OUT_EDGE: (j, k)
                tp.out_j, tp.tile_k = ins.args[2], ins.args[3]
    # Edge-valued kernels carry the ELL slice in their compute instr.
    if compute and compute[0].op == Opcode.SDDMM:
        tp.slice_id = compute[0].args[3]
    elif compute and standalone_act and layer.on_edges:
        tp.slice_id = compute[0].args[3]
    return tp


def decode_program(instrs: List[Instr]) -> ExecutionPlan:
    """Group a decoded instruction list into layer/tiling blocks."""
    layers: List[LayerPlan] = []
    current: Optional[LayerPlan] = None
    pending: List[Instr] = []
    pending_lo = -1                      # stream index of pending[0]
    expected: List[int] = []             # CSI-announced tiling block counts
    for idx, ins in enumerate(instrs):
        if ins.op == Opcode.HALT:
            break
        if ins.op == Opcode.CSI:
            try:
                layer_type = LayerType(ins.args[1])
            except ValueError:
                raise ValueError(
                    f"malformed program: instruction {idx} CSI "
                    f"announces unknown layer type {ins.args[1]} "
                    f"(valid: 0..{max(LayerType)})") from None
            current = LayerPlan(
                layer_id=ins.args[0],
                layer_type=layer_type,
                f_in=ins.args[2], f_out=ins.args[3],
                mode=ins.act, act_enabled=ins.act_en,
                on_edges=ins.on_edges, tiles=[],
                instr_lo=idx, instr_hi=idx)
            layers.append(current)
            expected.append(ins.arg4)
            pending = []
            pending_lo = -1
            continue
        if current is None:
            raise ValueError(
                f"malformed program: {ins.op.name} before the first CSI")
        if not pending:
            pending_lo = idx
        pending.append(ins)
        current.instr_hi = idx
        if ins.op == Opcode.MEM_WR and ins.flags & FLAG_LAST:
            tp = _close_tile(current, pending, base=pending_lo)
            tp.instr_lo, tp.instr_hi = pending_lo, idx
            current.tiles.append(tp)
            pending = []
            pending_lo = -1
    for lp, n in zip(layers, expected):
        if len(lp.tiles) != n:
            raise ValueError(
                f"malformed program: layer {lp.layer_id} announces {n} "
                f"tiling blocks but {len(lp.tiles)} were decoded")
    return ExecutionPlan(layers=layers)


def decode_binary(binary: bytes) -> ExecutionPlan:
    return decode_program(disassemble(binary))
