"""The checker suite — static verification of a GraphAGILE program.

Entry points accept the three forms a program travels in (raw bytes, a
decoded :class:`ExecutionPlan`, a ``.gagi`` bundle / in-memory
:class:`CompiledProgram`) and run every check the available inputs
support — nothing is ever *executed*:

  structure           header/payload agreement, opcode + field ranges,
                      CSI tiling-block accounting, HALT discipline
  def_before_use      every tile read has an earlier (or pre-defined)
                      writer
  use_after_free      no read lands after the residency schedule's
                      last-use position frees the value
  partition_coverage  every (fiber, shard) / (j, k, slice) tile of a
                      layer is produced exactly once
  kernel_legality     per-opcode argument conventions vs tile geometry
                      (coordinates, reduction bounds, nnz, MAC counts,
                      mode selectors, PE range)
  halo_completeness   manifest halo sets == re-derived remote-source
                      sets per device
  resident_budget     independent re-derivation of the device-resident
                      peak-bytes estimate
  liveness_schedule   manifest residency tables == re-derived tables

Violations carry ``instr_lo``/``instr_hi`` so they join against traces
and ``ExecStats.per_layer`` rows.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.ir import Activation, AggOp, LayerType
from repro_torch.core.isa import (FLAG_ACC, FLAG_LAST, FLAG_LOCK,
                                  FLAG_UNLOCK, Buf, Instr, Opcode, Region,
                                  disassemble)
from repro_torch.engine.decoder import ExecutionPlan, decode_program

from .hazards import build_hazards, sources_by_shard
from .model import DefUseModel, build_model, tile_slices_from_stats
from .report import VerifyReport

_KNOWN_FLAGS = FLAG_LOCK | FLAG_UNLOCK | FLAG_ACC | FLAG_LAST
_MAX_VIOLATIONS_PER_CHECK = 16


class _Budget:
    """Caps per-check violation volume so a thoroughly corrupted binary
    reports a readable sample, not a million rows."""

    def __init__(self, report: VerifyReport) -> None:
        self.report = report
        self.counts: Dict[str, int] = {}

    def add(self, check: str, message: str, **kw) -> None:
        n = self.counts.get(check, 0)
        self.counts[check] = n + 1
        if n < _MAX_VIOLATIONS_PER_CHECK:
            self.report.add(check, message, **kw)
        elif n == _MAX_VIOLATIONS_PER_CHECK:
            self.report.add(check, "further violations suppressed "
                            f"(cap {_MAX_VIOLATIONS_PER_CHECK})")


def _fibers(f: int, n2: int) -> int:
    return max(1, math.ceil(max(f, 0) / n2))


# --------------------------------------------------------------------------- #
# structure
# --------------------------------------------------------------------------- #
def check_structure(instrs: List[Instr], report: VerifyReport) -> bool:
    """Instruction-stream sanity beyond what decode enforces.  Returns
    False when the stream is too broken for the semantic checks."""
    report.ran("structure")
    v = _Budget(report)
    if not instrs or instrs[-1].op != Opcode.HALT:
        v.add("structure", "program does not end with HALT",
              instr_lo=len(instrs) - 1 if instrs else -1,
              instr_hi=len(instrs) - 1 if instrs else -1)
    halted = False
    for idx, ins in enumerate(instrs):
        if halted:
            v.add("structure",
                  f"{ins.op.name} after HALT is unreachable",
                  instr_lo=idx, instr_hi=idx)
            continue
        if ins.op == Opcode.HALT:
            halted = True
            continue
        if ins.flags & ~_KNOWN_FLAGS:
            v.add("structure",
                  f"{ins.op.name} carries unknown flag bits "
                  f"0x{ins.flags & ~_KNOWN_FLAGS:02X}",
                  instr_lo=idx, instr_hi=idx)
        if ins.op in (Opcode.MEM_RD, Opcode.MEM_WR):
            if ins.args[0] not in tuple(Buf):
                v.add("structure",
                      f"{ins.op.name} names unknown buffer "
                      f"{ins.args[0]}", instr_lo=idx, instr_hi=idx)
            if ins.args[1] not in tuple(Region):
                v.add("structure",
                      f"{ins.op.name} names unknown region "
                      f"{ins.args[1]}", instr_lo=idx, instr_hi=idx)
    return v.counts.get("structure", 0) == 0


# --------------------------------------------------------------------------- #
# def_before_use / use_after_free
# --------------------------------------------------------------------------- #
def check_def_before_use(model: DefUseModel,
                         report: VerifyReport) -> None:
    report.ran("def_before_use")
    v = _Budget(report)
    defined: Set[Tuple] = set(model.predefined)
    for op in model.ops:
        for u in op.uses:
            if u[0] == "g" and not model.graph_tiles_known:
                continue
            if u not in defined:
                v.add("def_before_use",
                      f"{op.kind} tile reads {u} before any definition",
                      layer_id=op.layer_id,
                      instr_lo=op.instr_lo, instr_hi=op.instr_hi)
        defined.update(op.defs)


def derive_last_use(model: DefUseModel) -> Dict[int, int]:
    """Interval-liveness table re-derived from the def/use model: value
    id -> layer step of its last consumer (-1 = input features; the
    sink gets one-past-the-last-layer, the executor's output slice).

    A value no instruction reads dies at the step of the layer the layer
    table names as its consumer, as the manifest's residency schedule
    frees it: that is a remapped binary whose skip-empty elision drained
    every tile its consumer reads.  (A departure from ``repro``, whose
    copy keeps such a value live to the end and so reports a
    ``resident_budget`` drift against the executor's estimate.)"""
    last: Dict[int, int] = {}
    for op in model.ops:
        for u in op.uses:
            if u[0] in ("v", "e"):
                lid = int(u[1])
                last[lid] = max(last.get(lid, op.step), op.step)
    read = set(last)
    for step, lp in enumerate(model.plan.layers):
        for lid in model.consumes.get(lp.layer_id, ()):
            if lid not in read:
                last[lid] = max(last.get(lid, step), step)
    if model.plan.layers:
        last[model.plan.layers[-1].layer_id] = len(model.plan.layers)
    return last


def check_use_after_free(model: DefUseModel, residency: dict,
                         report: VerifyReport) -> None:
    """Every read must land at or before the residency schedule's
    last-use position — a later read would hit a freed buffer."""
    report.ran("use_after_free")
    v = _Budget(report)
    sched = {int(k): int(t) for k, t in
             residency.get("last_use", {}).items()}
    for op in model.ops:
        for u in op.uses:
            if u[0] not in ("v", "e"):
                continue
            lid = int(u[1])
            freed_at = sched.get(lid)
            if freed_at is not None and op.step > freed_at:
                v.add("use_after_free",
                      f"{op.kind} tile at layer step {op.step} reads "
                      f"value {lid}, freed after step {freed_at} by the "
                      "residency schedule",
                      layer_id=op.layer_id,
                      instr_lo=op.instr_lo, instr_hi=op.instr_hi)


# --------------------------------------------------------------------------- #
# partition_coverage
# --------------------------------------------------------------------------- #
def check_partition_coverage(model: DefUseModel, report: VerifyReport,
                             ) -> None:
    report.ran("partition_coverage")
    v = _Budget(report)
    n2, nb = model.n2, model.nb
    # Graph-tile slice universe, from the predefined set.
    eslices: Dict[Tuple[int, int], int] = {}
    for key in model.predefined:
        if key[0] == "g":
            _, j, k, s = key
            eslices[(j, k)] = max(eslices.get((j, k), 0), s + 1)
    for lp in model.plan.layers:
        lt = lp.layer_type
        edge_layer = (lt == LayerType.VECTOR_INNER or lp.on_edges)
        if edge_layer:
            if not model.graph_tiles_known:
                continue
            expected = {(j, k, s) for (j, k), n in eslices.items()
                        for s in range(n)}
            got: Dict[Tuple[int, int, int], int] = {}
            for tp in lp.tiles:
                c = (tp.out_j, tp.tile_k, tp.slice_id)
                got[c] = got.get(c, 0) + 1
            label = "(j, k, slice)"
        else:
            nf = _fibers(lp.f_out if lt == LayerType.LINEAR else lp.f_in,
                         n2)
            expected = {(i, j) for i in range(nf) for j in range(nb)}
            got = {}
            for tp in lp.tiles:
                c = (tp.out_i, tp.out_j)
                got[c] = got.get(c, 0) + 1
            label = "(fiber, shard)"
        for c in sorted(expected - set(got)):
            v.add("partition_coverage",
                  f"{label} tile {c} is never produced",
                  layer_id=lp.layer_id,
                  instr_lo=lp.instr_lo, instr_hi=lp.instr_hi)
        for c, n in sorted(got.items()):
            if c not in expected:
                v.add("partition_coverage",
                      f"unexpected {label} tile {c} outside the "
                      "partition grid", layer_id=lp.layer_id,
                      instr_lo=lp.instr_lo, instr_hi=lp.instr_hi)
            elif n > 1:
                v.add("partition_coverage",
                      f"{label} tile {c} is produced {n} times",
                      layer_id=lp.layer_id,
                      instr_lo=lp.instr_lo, instr_hi=lp.instr_hi)


# --------------------------------------------------------------------------- #
# kernel_legality
# --------------------------------------------------------------------------- #
_ALLOWED_COMPUTE = {
    LayerType.AGGREGATE: {Opcode.SPDMM},
    LayerType.LINEAR: {Opcode.GEMM},
    LayerType.VECTOR_INNER: {Opcode.SDDMM},
    LayerType.VECTOR_ADD: {Opcode.VADD},
    LayerType.ACTIVATION: {Opcode.ACT},
    LayerType.BATCHNORM: {Opcode.AFFINE, Opcode.ACT},
}


def check_kernel_legality(model: DefUseModel, report: VerifyReport,
                          n_pes: Optional[int] = None, pgraph=None,
                          rebound: bool = False,
                          remap: Optional[dict] = None) -> None:
    """Per-opcode argument conventions vs the tile geometry.

    ``rebound`` (livegraph): tile *contents* were patched after codegen,
    so nnz operands in the binary are checked against slice capacity
    (n1 x width) instead of exact equality.

    ``remap`` (sparsity-adaptive remapping): the manifest ``remap``
    record.  When present, an AGGREGATE tile the record marks ``gemm``
    may be encoded as a dense-aggregate GEMM — SUM/MEAN reductions
    only, MAC count n1*n1*n2 (the densified block), distinguishing it
    from a LINEAR GEMM's n1*n2*n2 — and a tile marked ``skip`` must
    carry no compute at all and hold zero live edges.  Any encoding
    that disagrees with the record fails in BOTH directions: a GEMM
    whose tile the record calls spdmm/skip/absent, and an SPDMM whose
    tile the record calls gemm in a densifiable layer."""
    report.ran("kernel_legality")
    v = _Budget(report)
    rec_tiles = (remap or {}).get("tiles", {})
    n1, n2, nb = model.n1, model.n2, model.nb
    for lp in model.plan.layers:
        lt = lp.layer_type
        fi = _fibers(lp.f_in, n2)
        fo = _fibers(lp.f_out, n2)
        # CSI mode selector ranges.
        if lt == LayerType.AGGREGATE and lp.mode not in tuple(AggOp):
            v.add("kernel_legality",
                  f"CSI announces AggOp {lp.mode}, outside the "
                  "AggOp range", layer_id=lp.layer_id,
                  instr_lo=lp.instr_lo, instr_hi=lp.instr_lo)
        if lt == LayerType.ACTIVATION and \
                lp.mode not in tuple(Activation):
            v.add("kernel_legality",
                  f"CSI announces Activation {lp.mode}, outside the "
                  "Activation range", layer_id=lp.layer_id,
                  instr_lo=lp.instr_lo, instr_hi=lp.instr_lo)
        if lt == LayerType.VECTOR_INNER and lp.mode not in (0, 1):
            v.add("kernel_legality",
                  f"CSI announces vector-inner mode {lp.mode} "
                  "(expected 0=dot or 1=pair-sum)",
                  layer_id=lp.layer_id,
                  instr_lo=lp.instr_lo, instr_hi=lp.instr_lo)
        allowed = _ALLOWED_COMPUTE.get(lt, set())
        for tp in lp.tiles:
            lo, hi = tp.instr_lo, tp.instr_hi

            def bad(msg: str) -> None:
                v.add("kernel_legality", msg, layer_id=lp.layer_id,
                      instr_lo=lo, instr_hi=hi)

            if n_pes is not None and tp.pe >= n_pes:
                bad(f"tile assigned to PE {tp.pe} but the overlay has "
                    f"{n_pes} PEs")
            if tp.out_j >= nb:
                bad(f"destination row block {tp.out_j} outside the "
                    f"{nb}-block grid")
            for ins in tp.compute:
                if lt == LayerType.AGGREGATE and ins.op == Opcode.GEMM:
                    j, k, i, _packed = ins.args
                    entry = rec_tiles.get(f"{j}:{k}")
                    mode = entry.get("mode") if entry else None
                    if remap is None:
                        bad("GEMM inside an AGGREGATE layer with no "
                            "remap record (expects SPDMM)")
                    elif mode != "gemm":
                        bad(f"GEMM encodes aggregate tile ({j}, {k}) "
                            "but the remap record marks it "
                            f"{mode or 'unmapped'}")
                    if lp.mode in (int(AggOp.SUM), int(AggOp.MEAN)):
                        if ins.arg4 != n1 * n1 * n2:
                            bad("dense-aggregate GEMM announces "
                                f"{ins.arg4} MACs, the densified tile "
                                f"implies {n1 * n1 * n2}")
                    else:
                        bad("dense-aggregate GEMM under a non-linear "
                            f"reduction (AggOp {lp.mode}); only "
                            "SUM/MEAN may densify")
                    if (j, i) != (tp.out_j, tp.out_i):
                        bad(f"GEMM targets (j={j}, i={i}) but the "
                            f"tiling block writes (j={tp.out_j}, "
                            f"i={tp.out_i})")
                    if k >= nb:
                        bad(f"GEMM source block {k} outside the "
                            f"{nb}-block grid")
                    if i >= fi:
                        bad(f"GEMM input fiber {i} outside the "
                            f"{fi}-fiber grid")
                    continue
                if ins.op not in allowed:
                    bad(f"{ins.op.name} inside a {lt.name} layer "
                        "(expects "
                        f"{'/'.join(o.name for o in sorted(allowed))})")
                    continue
                if ins.op == Opcode.GEMM:
                    j, k, i, _ = ins.args
                    if (j, i) != (tp.out_j, tp.out_i):
                        bad(f"GEMM targets (j={j}, i={i}) but the "
                            f"tiling block writes (j={tp.out_j}, "
                            f"i={tp.out_i})")
                    if k >= fi:
                        bad(f"GEMM reduction fiber {k} outside the "
                            f"{fi}-fiber input grid")
                    if i >= fo:
                        bad(f"GEMM output fiber {i} outside the "
                            f"{fo}-fiber output grid")
                    if ins.arg4 != n1 * n2 * n2:
                        bad(f"GEMM announces {ins.arg4} MACs, tile "
                            f"geometry implies {n1 * n2 * n2}")
                elif ins.op == Opcode.SPDMM:
                    j, k, i, packed = ins.args
                    s = packed >> 1
                    if (j, i) != (tp.out_j, tp.out_i):
                        bad(f"SPDMM targets (j={j}, i={i}) but the "
                            f"tiling block writes (j={tp.out_j}, "
                            f"i={tp.out_i})")
                    if k >= nb:
                        bad(f"SPDMM source block {k} outside the "
                            f"{nb}-block grid")
                    if i >= fi:
                        bad(f"SPDMM input fiber {i} outside the "
                            f"{fi}-fiber grid")
                    entry = rec_tiles.get(f"{j}:{k}")
                    emode = entry.get("mode") if entry else None
                    if emode == "gemm" and lp.mode in (
                            int(AggOp.SUM), int(AggOp.MEAN)):
                        bad(f"SPDMM encodes aggregate tile ({j}, {k}) "
                            "but the remap record marks it gemm")
                    elif emode == "skip":
                        bad(f"tile ({j}, {k}) still carries compute "
                            "but the remap record elides it as "
                            "skip-empty")
                    _check_nnz(ins, j, k, s, pgraph, rebound, n1, bad)
                elif ins.op == Opcode.SDDMM:
                    j, k, i, s = ins.args
                    if (j, k, s) != (tp.out_j, tp.tile_k, tp.slice_id):
                        bad(f"SDDMM addresses tile ({j}, {k}, {s}) but "
                            "the tiling block writes "
                            f"({tp.out_j}, {tp.tile_k}, {tp.slice_id})")
                    if i >= fi:
                        bad(f"SDDMM fiber {i} outside the {fi}-fiber "
                            "grid")
                    _check_nnz(ins, j, k, s, pgraph, rebound, n1, bad)
                elif ins.op == Opcode.VADD:
                    i, j = ins.args[0], ins.args[1]
                    if (i, j) != (tp.out_i, tp.out_j):
                        bad(f"VADD targets (i={i}, j={j}) but the "
                            f"tiling block writes (i={tp.out_i}, "
                            f"j={tp.out_j})")
                elif ins.op in (Opcode.ACT, Opcode.AFFINE):
                    if ins.args[0] != lp.layer_id:
                        bad(f"{ins.op.name} names layer {ins.args[0]} "
                            f"inside layer {lp.layer_id}'s block")
                    if ins.op == Opcode.ACT and ins.act_en \
                            and ins.act not in tuple(Activation):
                        bad(f"ACT selects activation {ins.act}, "
                            "outside the Activation range")
    # Skip-elided tiles must actually be empty — a record that elides
    # a tile with live edges would silently drop messages.
    if rec_tiles and pgraph is not None:
        for jk, entry in sorted(rec_tiles.items()):
            if entry.get("mode") != "skip":
                continue
            j, k = (int(x) for x in jk.split(":"))
            nnz = sum(int(t.nnz) for t in pgraph.tiles.get((j, k), []))
            if nnz:
                v.add("kernel_legality",
                      f"remap record elides tile ({j}, {k}) as "
                      f"skip-empty but its ELL slices hold {nnz} "
                      "live edges")


def _check_nnz(ins, j: int, k: int, s: int, pgraph, rebound: bool,
               n1: int, bad) -> None:
    if pgraph is None:
        return
    slices = pgraph.tiles.get((j, k), [])
    if s >= len(slices):
        bad(f"{ins.op.name} addresses ELL slice {s} of tile "
            f"({j}, {k}) but only {len(slices)} slice(s) exist")
        return
    tile = slices[s]
    if rebound:
        if ins.arg4 == 0 or tile.nnz == 0:
            # A rebind can empty a slice (live tile drained by a
            # delta) without re-encoding arg4; staging reads the ELL
            # planes by shape, so the operand is advisory here.
            return
        cap = n1 * tile.width
        if ins.arg4 > cap:
            bad(f"{ins.op.name} announces {ins.arg4} nnz for tile "
                f"({j}, {k}, {s}) — over the {cap}-slot slice "
                "capacity even after rebind")
    elif ins.arg4 != tile.nnz:
        bad(f"{ins.op.name} announces {ins.arg4} nnz for tile "
            f"({j}, {k}, {s}) but the ELL slice holds {tile.nnz}")


# --------------------------------------------------------------------------- #
# liveness_schedule / halo_completeness
# --------------------------------------------------------------------------- #
def derive_residency_tables(model: DefUseModel) -> dict:
    """Residency schedule re-derived from the def/use model (same
    semantics as ``repro_torch.core.passes.schedule.residency_schedule``,
    but
    computed from decoded instructions — the verifier's independent
    path)."""
    from repro_torch.core.passes.schedule import _order_shards
    layers: Dict[str, dict] = {}
    shard_sources = sources_by_shard(model)
    for lp in model.plan.layers:
        sources = shard_sources[lp.layer_id]
        layers[str(lp.layer_id)] = {
            "shard_order": [int(j) for j in _order_shards(sources)],
            "sources": {str(j): sorted(int(k) for k in ks)
                        for j, ks in sources.items()},
        }
    return {
        "last_use": {str(k): int(t)
                     for k, t in sorted(derive_last_use(model).items())},
        "layers": layers,
    }


def check_liveness_schedule(model: DefUseModel, residency: dict,
                            report: VerifyReport,
                            remapped: bool = False) -> None:
    """``remapped``: skip-elided tiles removed reads *after* the
    residency schedule was built, so the binary's tables may be a
    conservative SUBSET of the manifest's (earlier last_use, fewer
    gather sources) — the manifest then over-retains, which is safe.
    The reverse direction (binary reads more than the manifest
    schedules) still fails."""
    report.ran("liveness_schedule")
    v = _Budget(report)
    derived = derive_residency_tables(model)
    man_last = {int(k): int(t) for k, t in
                residency.get("last_use", {}).items()}
    der_last = {int(k): int(t) for k, t in derived["last_use"].items()}
    for lid in sorted(set(man_last) | set(der_last)):
        a, b = man_last.get(lid), der_last.get(lid)
        if a == b:
            continue
        if remapped and a is not None and (b is None or b <= a):
            continue
        v.add("liveness_schedule",
              f"last_use[{lid}]: manifest says step {a}, binary "
              f"implies step {b}", layer_id=lid)
    man_layers = residency.get("layers", {})
    for lp in model.plan.layers:
        key = str(lp.layer_id)
        mine = derived["layers"][key]
        theirs = man_layers.get(key)
        if theirs is None:
            v.add("liveness_schedule",
                  "manifest residency has no entry for this layer",
                  layer_id=lp.layer_id, instr_lo=lp.instr_lo,
                  instr_hi=lp.instr_hi)
            continue
        theirs_src = theirs.get("sources") or {}
        if theirs_src != mine["sources"]:
            subset = remapped and all(
                set(ks) <= {int(x) for x in theirs_src.get(jstr, [])}
                for jstr, ks in mine["sources"].items())
            if not subset:
                v.add("liveness_schedule",
                      "manifest per-shard source lists disagree with "
                      "the binary's gather set", layer_id=lp.layer_id,
                      instr_lo=lp.instr_lo, instr_hi=lp.instr_hi)
        if sorted(theirs.get("shard_order", [])) != \
                sorted(mine["shard_order"]):
            v.add("liveness_schedule",
                  "manifest shard_order is not a permutation of the "
                  "binary's destination shards", layer_id=lp.layer_id,
                  instr_lo=lp.instr_lo, instr_hi=lp.instr_hi)


def check_halo_completeness(model: DefUseModel, placement: dict,
                            report: VerifyReport,
                            remapped: bool = False) -> None:
    """Every remote source block a device's shards gather from must be
    in that device's manifest halo set (and nothing else).  When
    ``remapped``, skip elision may have removed gathers after the
    placement was scheduled, so an over-full halo set (extra blocks)
    is tolerated; a missing block still fails."""
    report.ran("halo_completeness")
    v = _Budget(report)
    assignment = [int(a) for a in placement.get("assignment", [])]
    n_devices = int(placement.get("n_devices", 0))
    if len(assignment) < model.nb or n_devices <= 0:
        v.add("halo_completeness",
              f"placement assigns {len(assignment)} row blocks but the "
              f"program addresses {model.nb}")
        return
    owned: List[Set[int]] = [set() for _ in range(n_devices)]
    for j, d in enumerate(assignment):
        owned[d].add(j)
    shard_sources = sources_by_shard(model)
    man_layers = placement.get("layers", {})
    for lp in model.plan.layers:
        rec = man_layers.get(str(lp.layer_id))
        if rec is None:
            v.add("halo_completeness",
                  "placement has no entry for this layer",
                  layer_id=lp.layer_id, instr_lo=lp.instr_lo,
                  instr_hi=lp.instr_hi)
            continue
        need: List[Set[int]] = [set() for _ in range(n_devices)]
        for j, ks in shard_sources[lp.layer_id].items():
            need[assignment[j]].update(ks)
        for d in range(n_devices):
            halo = set(int(k) for k in rec.get("halo", {})
                       .get(str(d), []))
            required = need[d] - owned[d]
            missing = required - halo
            extra = halo - required
            if missing:
                v.add("halo_completeness",
                      f"device {d} gathers remote source blocks "
                      f"{sorted(missing)} absent from its halo set",
                      layer_id=lp.layer_id, instr_lo=lp.instr_lo,
                      instr_hi=lp.instr_hi)
            if extra and not remapped:
                v.add("halo_completeness",
                      f"device {d}'s halo set lists blocks "
                      f"{sorted(extra)} no shard of it reads",
                      layer_id=lp.layer_id, instr_lo=lp.instr_lo,
                      instr_hi=lp.instr_hi)


# --------------------------------------------------------------------------- #
# resident_budget
# --------------------------------------------------------------------------- #
def rederive_device_peak_bytes(model: DefUseModel, pgraph,
                               weights: Dict) -> int:
    """Liveness-aware peak device bytes of a device-resident pass,
    re-derived from CSI fields + the def/use liveness — independent of
    ``BinaryExecutor._live_profile`` (numpy-free accounting)."""
    import numpy as np
    n1, n2, nb = model.n1, model.n2, model.nb
    static = (pgraph.tile_bytes()
              + sum(int(np.asarray(w).size)
                    * np.asarray(w).dtype.itemsize
                    for w in weights.values())
              + pgraph.inv_in_degree.size
              * pgraph.inv_in_degree.dtype.itemsize)
    layers = model.plan.layers
    if not layers:
        return static
    fin_pad0 = _fibers(layers[0].f_in, n2) * n2
    x_bytes = nb * n1 * fin_pad0 * 4
    last = derive_last_use(model)
    sizes: Dict[int, int] = {}
    births: Dict[int, int] = {}
    for t, lp in enumerate(layers):
        births[lp.layer_id] = t
        if model.layer_kind[lp.layer_id] == "e":
            sizes[lp.layer_id] = (pgraph.n_edges + 1) * 4
        else:
            f = (lp.f_out if lp.layer_type == LayerType.LINEAR
                 else lp.f_in)
            sizes[lp.layer_id] = nb * n1 * _fibers(f, n2) * n2 * 4
    n = len(layers)
    peak_live = max(
        sum(sz for lid, sz in sizes.items()
            if births[lid] <= t <= max(last.get(lid, n), births[lid]))
        for t in range(n))
    return static + x_bytes + peak_live


def check_resident_budget(model: DefUseModel, prog,
                          report: VerifyReport) -> None:
    """The executor's budget gate prices runs with
    ``estimate_device_peak_bytes``; this check re-derives the same peak
    from the binary alone and flags any drift between the two."""
    report.ran("resident_budget")
    from repro_torch.engine.executor import BinaryExecutor
    mine = rederive_device_peak_bytes(model, prog.pgraph, prog.weights)
    # The estimate reads the plan and the arrays' shapes only; no device
    # is touched, so a CPU executor prices a program of any device.
    theirs = BinaryExecutor(device="cpu").estimate_device_peak_bytes(prog)
    report.stats["device_peak_bytes"] = int(mine)
    if mine != theirs:
        report.add(
            "resident_budget",
            f"re-derived device-resident peak is {mine} bytes but the "
            f"executor's estimate is {theirs} — the budget gate and "
            f"the binary disagree by {abs(mine - theirs)} bytes")


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def verify_plan(plan: ExecutionPlan, instrs: List[Instr],
                lmeta: Optional[dict], geometry: Optional[dict],
                *, pgraph=None, weights=None, prog=None,
                residency: Optional[dict] = None,
                placement: Optional[dict] = None,
                n_pes: Optional[int] = None, rebound: bool = False,
                tile_slices=None, remap: Optional[dict] = None,
                label: str = "") -> VerifyReport:
    """Run every check the supplied inputs support."""
    report = VerifyReport(program=label)
    report.stats.update(n_instrs=len(instrs), n_layers=plan.n_layers,
                        n_tiles=sum(len(lp.tiles)
                                    for lp in plan.layers))
    check_structure(instrs, report)
    if lmeta is None or geometry is None:
        reason = "needs a manifest (layer table + geometry)"
        for c in ("def_before_use", "use_after_free",
                  "partition_coverage", "kernel_legality",
                  "liveness_schedule"):
            report.skip(c, reason)
        report.skip("halo_completeness", reason)
        report.skip("resident_budget", reason)
        return report
    model = build_model(plan, lmeta, geometry, pgraph=pgraph,
                        tile_slices=tile_slices)
    hz = build_hazards(model, lmeta)
    report.stats.update(n_values=len(model.predefined),
                        hazard_edges=hz.counts)
    check_def_before_use(model, report)
    check_partition_coverage(model, report)
    check_kernel_legality(model, report, n_pes=n_pes, pgraph=pgraph,
                          rebound=rebound, remap=remap)
    if residency is not None:
        check_use_after_free(model, residency, report)
        check_liveness_schedule(model, residency, report,
                                remapped=remap is not None)
    else:
        reason = "no residency schedule supplied"
        report.skip("use_after_free", reason)
        report.skip("liveness_schedule", reason)
    if placement is not None:
        check_halo_completeness(model, placement, report,
                                remapped=remap is not None)
    else:
        report.skip("halo_completeness",
                    "program carries no placement schedule")
    if prog is not None and pgraph is not None:
        check_resident_budget(model, prog, report)
    else:
        report.skip("resident_budget",
                    "needs tiles + weights (full program)")
    return report


def verify_binary(binary: bytes, manifest: Optional[dict] = None,
                  pgraph=None, label: str = "") -> VerifyReport:
    """Verify raw binary bytes (+ optional manifest / tiles).  Decode
    failures become ``structure`` violations, never exceptions."""
    report = VerifyReport(program=label or "<binary>")
    try:
        instrs = disassemble(binary)
        plan = decode_program(instrs)
    except ValueError as e:
        report.ran("structure")
        report.add("structure", str(e))
        for c in ("def_before_use", "use_after_free",
                  "partition_coverage", "kernel_legality",
                  "halo_completeness", "resident_budget",
                  "liveness_schedule"):
            report.skip(c, "binary failed to decode")
        return report
    lmeta = manifest.get("layers") if manifest else None
    geometry = manifest.get("geometry") if manifest else None
    tile_slices = None
    if pgraph is None and manifest and "tile_stats" in manifest:
        tile_slices = tile_slices_from_stats(manifest["tile_stats"])
    return verify_plan(
        plan, instrs, lmeta, geometry, pgraph=pgraph,
        residency=manifest.get("residency") if manifest else None,
        placement=manifest.get("placement") if manifest else None,
        n_pes=(int(geometry.get("n_pes", 0)) or None)
        if geometry else None,
        rebound=bool(manifest and "graph_version" in manifest),
        tile_slices=tile_slices,
        remap=manifest.get("remap") if manifest else None,
        label=report.program)


def verify_program(prog, label: str = "") -> VerifyReport:
    """Verify a :class:`CompiledProgram` — the full suite."""
    name = label or f"{prog.model_name}::{prog.graph_name}"
    report = VerifyReport(program=name)
    try:
        instrs = disassemble(prog.binary)
        plan = decode_program(instrs)
    except ValueError as e:
        report.ran("structure")
        report.add("structure", str(e))
        for c in ("def_before_use", "use_after_free",
                  "partition_coverage", "kernel_legality",
                  "halo_completeness", "resident_budget",
                  "liveness_schedule"):
            report.skip(c, "binary failed to decode")
        return report
    man = prog.manifest
    geometry = man.get("geometry")
    return verify_plan(
        plan, instrs, man.get("layers"), geometry,
        pgraph=prog.pgraph, weights=prog.weights, prog=prog,
        residency=man.get("residency"),
        placement=man.get("placement"),
        n_pes=(int(geometry.get("n_pes", 0)) or None)
        if geometry else None,
        rebound="graph_version" in man, remap=man.get("remap"),
        label=name)


def verify_gagi(path: str) -> VerifyReport:
    """Load a ``.gagi`` bundle and verify it."""
    from repro_torch.engine.program import CompiledProgram
    import os
    prog = CompiledProgram.load(path)
    return verify_program(prog, label=os.path.basename(path))


def verify(obj, **kw) -> VerifyReport:
    """Polymorphic front door: bytes, ``.gagi`` path, ExecutionPlan, or
    CompiledProgram."""
    if isinstance(obj, bytes):
        return verify_binary(obj, **kw)
    if isinstance(obj, str):
        return verify_gagi(obj)
    if isinstance(obj, ExecutionPlan):
        instrs: List[Instr] = []
        return verify_plan(obj, instrs, kw.get("lmeta"),
                           kw.get("geometry"),
                           label=kw.get("label", "<plan>"))
    return verify_program(obj, label=kw.get("label", ""))
