"""GraphAGILE instruction set (paper §5.3, Fig. 3).

Every high-level instruction is 128 bits, packed as ``uint32[4]``:

  word0: opcode(8) | pe_id(8) | act(6) | act_en(1) | on_edges(1) | flags(8)
  word1: arg0(16) | arg1(16)
  word2: arg2(16) | arg3(16)
  word3: arg4(32)          (sizes that may exceed 16 bits: nnz, counts)

The flags byte carries the double-buffer mutex annotations the compiler
emits (paper §6.6): LOCK marks a memory-read that acquires a buffer,
UNLOCK marks the compute instruction that releases it.

Since format VERSION 3 the binary is *load-bearing*: the runtime
(`repro_torch.engine`) executes a program by decoding this stream, so every
dispatch decision is encoded in instruction fields.  Per-opcode argument
conventions:

  CSI     args=(layer_id, layer_type, f_in, f_out)  arg4=#tiling blocks
          act carries the layer's mode selector: the AggOp for AGGREGATE
          layers, the Activation for ACTIVATION layers, 1 for pair-sum
          VECTOR_INNER layers; on_edges set for edge-valued layers.
  GEMM    args=(j, k, i, 0)        out row-block j, reduction fiber k,
                                   output fiber i; arg4 = n1*n2*n2 MACs
  SPDMM   args=(j, k, i, s<<1|dyn) sub-shard A(j,k) ELL slice s, input
                                   fiber i, dyn=per-edge weights; arg4=nnz
  SDDMM   args=(j, k, i, s)        arg4 = nnz
  VADD    args=(i, j, 0, 0)
  ACT/AFFINE (standalone layers)   vertex: args=(layer_id, i, j, 0)
                                   edge:   args=(layer_id, j, k, s)
  ACT/AFFINE (fused epilogue)      args=(layer_id, 0, 0, 0); applied to
                                   the tiling block's accumulator
  MEM_WR  args=(Buf.RESULT, region, i, j) / (.., OUT_EDGE, j, k);
          FLAG_LAST terminates the enclosing tiling block.

A tiling block is the instruction span up to (and including) the first
FLAG_LAST; a layer block is a CSI plus its arg4-announced tiling blocks;
HALT ends the program.
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import List, Tuple

import numpy as np

MAGIC = 0x47414749  # "GAGI"
VERSION = 3         # v3: self-describing coordinates (see module docstring)
HEADER_BYTES = 16
INSTR_BYTES = 16


class Opcode(enum.IntEnum):
    NOP = 0
    CSI = 1        # control & scheduling: heads a Layer Block
    MEM_RD = 2
    MEM_WR = 3
    GEMM = 4
    SPDMM = 5
    SDDMM = 6
    VADD = 7
    ACT = 8
    AFFINE = 9     # standalone batchnorm (only when fusion disabled)
    HALT = 10


class Buf(enum.IntEnum):
    EDGE = 0
    FEATURE = 1
    WEIGHT = 2
    RESULT = 3


class Region(enum.IntEnum):
    SUBSHARD = 0       # A(j, k)
    SUBFIBER = 1       # H(i, j)   (fiber i, row-block j)
    WEIGHT_BLOCK = 2   # W(k, i)
    EDGE_WEIGHTS = 3   # per-edge scalar array segment
    OUT_SUBFIBER = 4
    OUT_EDGE = 5


FLAG_LOCK = 1
FLAG_UNLOCK = 2
FLAG_ACC = 4        # accumulate into result buffer
FLAG_LAST = 8       # last instruction of a tiling block


@dataclasses.dataclass
class Instr:
    op: Opcode
    pe: int = 0
    act: int = 0
    act_en: bool = False
    on_edges: bool = False
    flags: int = 0
    args: Tuple[int, int, int, int] = (0, 0, 0, 0)
    arg4: int = 0

    # ------------------------------------------------------------------ #
    def encode(self) -> np.ndarray:
        # Since ISA v3 these fields drive execution, so out-of-range
        # values must fail loudly at codegen instead of silently wrapping
        # into a wrong-but-decodable binary.
        for name, val, hi in (("pe", self.pe, 0xFF), ("act", self.act, 0x3F),
                              ("flags", self.flags, 0xFF),
                              ("arg4", self.arg4, 0xFFFFFFFF),
                              *((f"args[{i}]", a, 0xFFFF)
                                for i, a in enumerate(self.args))):
            if not 0 <= int(val) <= hi:
                raise ValueError(
                    f"{self.op.name}: field {name}={val} exceeds its "
                    f"encoding range [0, {hi}] — model/graph too large "
                    "for the 128-bit instruction format")
        w0 = ((int(self.op) & 0xFF)
              | (self.pe & 0xFF) << 8
              | (self.act & 0x3F) << 16
              | (1 << 22 if self.act_en else 0)
              | (1 << 23 if self.on_edges else 0)
              | (self.flags & 0xFF) << 24)
        a = [int(x) & 0xFFFF for x in self.args]
        w1 = a[0] | a[1] << 16
        w2 = a[2] | a[3] << 16
        w3 = int(self.arg4) & 0xFFFFFFFF
        return np.array([w0, w1, w2, w3], dtype=np.uint32)

    @staticmethod
    def decode(words: np.ndarray) -> "Instr":
        w0, w1, w2, w3 = (int(w) for w in words)
        opcode = w0 & 0xFF
        try:
            op = Opcode(opcode)
        except ValueError:
            raise ValueError(
                f"unknown opcode {opcode} (word0=0x{w0:08X}); valid "
                f"opcodes are 0..{max(Opcode)}") from None
        return Instr(
            op=op,
            pe=(w0 >> 8) & 0xFF,
            act=(w0 >> 16) & 0x3F,
            act_en=bool(w0 >> 22 & 1),
            on_edges=bool(w0 >> 23 & 1),
            flags=(w0 >> 24) & 0xFF,
            args=(w1 & 0xFFFF, w1 >> 16, w2 & 0xFFFF, w2 >> 16),
            arg4=w3,
        )

    def __repr__(self) -> str:  # compact trace form
        f = "".join(c for c, m in zip("LUAZ", (1, 2, 4, 8)) if self.flags & m)
        return (f"{self.op.name}(pe{self.pe} args={list(self.args)} "
                f"a4={self.arg4}{' ' + f if f else ''})")


# --------------------------------------------------------------------------- #
def assemble(instrs: List[Instr]) -> bytes:
    """Binary file: 16-byte header + 16 bytes per instruction (Table 8)."""
    header = struct.pack("<IIII", MAGIC, VERSION, len(instrs), 0)
    if not instrs:
        return header
    body = np.stack([i.encode() for i in instrs]).astype("<u4").tobytes()
    return header + body


def disassemble(blob: bytes) -> List[Instr]:
    """Decode a binary produced by :func:`assemble`.

    Raises ``ValueError`` (never a bare assert / struct.error / numpy
    reshape crash) on a wrong magic, an incompatible format version, a
    payload that disagrees with the header's instruction count in
    EITHER direction (truncation or trailing bytes), a body that is not
    a whole number of 16-byte instructions, or an out-of-range opcode —
    each error names the byte offset / instruction index at fault.
    """
    if len(blob) < HEADER_BYTES:
        raise ValueError(
            f"GraphAGILE binary too short: {len(blob)} bytes, need at "
            f"least the {HEADER_BYTES}-byte header")
    magic, version, n, _ = struct.unpack_from("<IIII", blob, 0)
    if magic != MAGIC:
        raise ValueError(
            f"bad magic 0x{magic:08X} at offset 0: not a GraphAGILE "
            f"binary (expected 0x{MAGIC:08X} 'GAGI')")
    if version != VERSION:
        raise ValueError(
            f"unsupported GraphAGILE binary version {version} at "
            f"offset 4 (this runtime decodes version {VERSION})")
    expected = HEADER_BYTES + n * INSTR_BYTES
    if len(blob) < expected:
        raise ValueError(
            f"truncated GraphAGILE binary: header announces {n} "
            f"instructions ({expected} bytes) but only {len(blob)} "
            "bytes are present")
    if len(blob) > expected:
        raise ValueError(
            f"oversized GraphAGILE binary: header announces {n} "
            f"instructions ({expected} bytes) but {len(blob)} bytes are "
            f"present — {len(blob) - expected} trailing byte(s) at "
            f"offset {expected}")
    words = np.frombuffer(blob, dtype="<u4", offset=HEADER_BYTES,
                          count=n * 4).reshape(n, 4)
    out: List[Instr] = []
    for idx, w in enumerate(words):
        try:
            out.append(Instr.decode(w))
        except ValueError as e:
            raise ValueError(
                f"instruction {idx} (byte offset "
                f"{HEADER_BYTES + idx * INSTR_BYTES}): {e}") from None
    return out
