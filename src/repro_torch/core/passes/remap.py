"""Bind-time sparsity-adaptive kernel remapping (Dynasparse-style).

A copy of ``repro/core/passes/remap.py``: for the same program,
constants and ``force`` / ``modes`` it writes the same binary bytes and
the same ``remap`` record (a test holds the two equal).  Only
``probe_oracle`` differs: it times the port's ACK, with CUDA events on a
CUDA device.  The default constants are the H100 data-sheet figures of
:mod:`repro_torch.core.perfmodel` (the JAX package's are its own), so
a test that compares the two packages' remaps hands both the same
constants.

GraphAGILE fixes each layer's ACK mode at compile time from static
geometry (paper §6.6): every AGGREGATE tile runs SpDMM.  But tile density
varies wildly inside one power-law graph — a hub tile at 20% density is
matmul-shaped work being executed as gathers, and a live-graph delta can
empty a tile entirely.  This pass re-prices every AGGREGATE tiling step
against a roofline cost model and **re-encodes the already-assembled
binary in place** — no recompile, no new partition, the program-cache key
survives modulo the recorded ``remap_signature``:

  * ``spdmm``  — leave the canonical encoding alone (or restore it).
  * ``gemm``   — densify the ELL slice into an (n1, n1) adjacency block
    and dispatch the systolic-array GEMM path: the SPDMM compute
    instruction's opcode byte flips to GEMM and its arg4 becomes the
    dense MAC count ``n1*n1*n2``.  Only layers whose AggOp is linear
    (SUM/MEAN) are eligible — max/min have no dense-matmul equivalent,
    so those layers keep SpDMM for a globally-gemm'd tile.
  * ``skip``   — nnz == 0: the whole MEM_RD/compute group is opcode-NOPed
    (args/arg4/flags preserved), so the decoder never materializes the
    tile step and the executor's accumulate-identity is exact for every
    AggOp.

Because NOPed instructions keep their argument fields and the compiler
never emits NOPs itself, a remapped binary is **self-describing**: the
original encoding is recoverable from flags+args patterns alone
(FLAG_UNLOCK ⇒ compute step, FLAG_LOCK+Buf.EDGE ⇒ sub-shard read,
FLAG_LOCK+Buf.FEATURE ⇒ fiber read, flags==0+EDGE_WEIGHTS ⇒ dynamic
edge-weight read).  ``remap_program`` therefore restores-to-canonical
before applying fresh decisions, which makes incremental re-remapping
(``only_tiles=`` — the livegraph rebind path hands in just the tiles a
delta patched) a pure word-level edit on the previous binary.

Cost oracle: two-term rooflines over :class:`ModelConstants` — the
paper-default datasheet numbers, or the *calibrated* effective constants
a conformance report fitted from measured runs.  With
``probe=True`` the oracle is replaced by direct microbenchmarks of the
two ACK kernels at the program's actual tile geometry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ir import AggOp, LayerType
from ..isa import (FLAG_UNLOCK, HEADER_BYTES, Buf, Instr, Opcode, Region)
from ..perfmodel import DEFAULT_CONSTANTS, ModelConstants

MODES = ("spdmm", "gemm", "skip")

# float32 operand widths of the roofline traffic terms
_ELL_BYTES_PER_SLOT = 8          # cols (int32) + vals (float32)
_F32 = 4


# --------------------------------------------------------------------------- #
# Cost oracle
# --------------------------------------------------------------------------- #
def resolve_constants(constants: Any = None) -> Tuple[ModelConstants, bool]:
    """Normalize a constants source into ``(ModelConstants, calibrated)``.

    Accepts ``None`` (paper defaults), a :class:`ModelConstants`, a
    ``{field: value}`` dict (a report's ``calibrated_constants``; unknown
    or falsy entries fall back to the default), or any object exposing a
    ``calibrated_constants`` attribute (a ``ConformanceReport``).
    """
    if constants is None:
        return DEFAULT_CONSTANTS, False
    if isinstance(constants, ModelConstants):
        return constants, True
    if isinstance(constants, dict):
        names = {f.name for f in dataclasses.fields(ModelConstants)}
        vals = {k: float(v) for k, v in constants.items()
                if k in names and v}
        return dataclasses.replace(DEFAULT_CONSTANTS, **vals), bool(vals)
    cal = getattr(constants, "calibrated_constants", None)
    if cal is not None:
        return resolve_constants(dict(cal))
    raise TypeError(f"cannot derive ModelConstants from {type(constants)}")


def price_tile(nnz: int, width: int, n_slices: int, n1: int, n2: int,
               c: ModelConstants) -> Tuple[float, float]:
    """(t_spdmm, t_gemm) roofline seconds for one (j, k) aggregate step.

    SpDMM reads the ELL slices (cols+vals) plus one feature tile per
    slice and runs 2·nnz·n2 MACs on the vector path; densified GEMM runs
    one n1×n1×n2 matmul per slice on the systolic path, reading the
    dense block + feature tile and writing the accumulator.
    """
    t_sp = max(2.0 * nnz * n2 / c.vpu_flops,
               (n1 * width * _ELL_BYTES_PER_SLOT
                + max(n_slices, 1) * n1 * n2 * _F32) / c.hbm_bw)
    t_ge_one = max(2.0 * n1 * n1 * n2 / c.peak_flops,
                   (n1 * n1 * _F32 + 2 * n1 * n2 * _F32) / c.hbm_bw)
    return t_sp, max(n_slices, 1) * t_ge_one


def probe_oracle(ack, n1: int, n2: int, widths: Sequence[int],
                 reps: int = 3, device: Any = "cpu") -> Dict[str, Any]:
    """Microbenchmark the two ACK kernels at the actual tile geometry.

    Returns ``{"spdmm": {width: seconds}, "gemm": seconds}`` — per-slice
    costs measured min-of-``reps`` on synthetic operands (the JAX
    package's seeded numpy draws, as torch tensors on ``device``), so the
    decision reflects what the kernels really cost on this backend
    rather than what the datasheet roofline promises.  On a CUDA device
    each call is timed by a CUDA event pair on the current stream; on
    the CPU by ``perf_counter``.
    """
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    h = put(rng.standard_normal((n1, n2)), torch.float32)
    acc = torch.zeros((n1, n2), dtype=torch.float32, device=dev)
    flag = torch.zeros((n1,), dtype=torch.bool, device=dev)

    def _once(fn) -> float:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def _time(fn) -> float:
        _once(fn)                               # build/warm
        return min(_once(fn) for _ in range(reps))

    per_w: Dict[int, float] = {}
    gemm_t = None
    for w in sorted({int(w) for w in widths if w > 0}):
        cols = put(rng.integers(0, n1, (n1, w)), torch.int32)
        vals = put(rng.random((n1, w)), torch.float32)
        mask = torch.ones((n1, w), dtype=torch.bool, device=dev)
        per_w[w] = _time(lambda: ack.spdmm(h, cols, vals, mask, acc, flag,
                                           "sum"))
        if gemm_t is None:      # scatter cost is width-marginal; dot dominates
            gemm_t = _time(lambda: ack.gemm_agg(cols, vals, h, acc))
    return {"spdmm": per_w, "gemm": gemm_t if gemm_t is not None else 0.0}


# --------------------------------------------------------------------------- #
# Density sources
# --------------------------------------------------------------------------- #
def resolve_density(prog, source: str = "auto"
                    ) -> Tuple[Dict[str, dict], str]:
    """Per-``"j:k"`` ``{nnz, width, slices, density}`` plus the source name.

    Structure (slice count / widths) always comes from the program's
    partitioned graph; nnz/density are overlaid from the requested
    source: the manifest ``exec_profile`` of a traced run, the
    ``tile_stats`` refreshed at livegraph rebind, or the ELL tiles
    themselves (``pgraph``).  ``auto`` prefers profile, then stats.
    """
    if source not in ("auto", "exec_profile", "tile_stats", "pgraph"):
        raise ValueError(f"unknown density source {source!r}")
    pg = prog.pgraph
    n1 = pg.config.n1
    stats: Dict[str, dict] = {}
    for (j, k), slices in pg.tiles.items():
        width = int(sum(t.cols.shape[1] for t in slices))
        nnz = int(sum(t.nnz for t in slices))
        stats[f"{j}:{k}"] = {
            "nnz": nnz, "width": width, "slices": len(slices),
            "density": nnz / float(n1 * width) if width else 0.0}
    src = "pgraph"
    ep = prog.manifest.get("exec_profile") or {}
    if source in ("auto", "exec_profile") and ep.get("tiles"):
        seen: Dict[str, int] = {}
        for key, t in ep["tiles"].items():
            j, k, _s = key.split(":")
            seen[f"{j}:{k}"] = seen.get(f"{j}:{k}", 0) + int(t.get("nnz", 0))
        for jk, nnz in seen.items():
            if jk in stats:
                w = stats[jk]["width"]
                stats[jk]["nnz"] = nnz
                stats[jk]["density"] = nnz / float(n1 * w) if w else 0.0
        src = "exec_profile"
    elif source in ("auto", "tile_stats") and \
            (prog.manifest.get("tile_stats") or {}).get("tiles"):
        for jk, t in prog.manifest["tile_stats"]["tiles"].items():
            if jk in stats:
                w = stats[jk]["width"]
                stats[jk]["nnz"] = int(t.get("nnz", stats[jk]["nnz"]))
                stats[jk]["density"] = (stats[jk]["nnz"] / float(n1 * w)
                                        if w else 0.0)
        src = "tile_stats"
    elif source in ("exec_profile", "tile_stats"):
        raise ValueError(
            f"density source {source!r} requested but the manifest "
            "carries no such section")
    return stats, src


# --------------------------------------------------------------------------- #
# Binary scan: aggregate tile groups in a remapped-or-canonical stream
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _Group:
    """One aggregate tile step: its compute instr + member MEM_RDs."""

    j: int
    k: int
    s: int
    dyn: int
    agg: AggOp
    compute: int                 # instruction index
    mem: Tuple[int, ...]         # MEM_RD (or NOPed MEM_RD) indices


def _scan_groups(instrs: List[Instr]) -> List[_Group]:
    """Walk the stream, collecting every AGGREGATE tile group.

    Works on canonical AND previously-remapped binaries: the compiler
    never emits NOP, so any NOP here is an elided group member —
    FLAG_UNLOCK marks the (elided) compute step, everything else a
    (elided) memory read.
    """
    groups: List[_Group] = []
    agg: Optional[AggOp] = None
    pending: List[int] = []
    for idx, ins in enumerate(instrs):
        if ins.op == Opcode.CSI:
            lt = LayerType(ins.args[1])
            agg = AggOp(ins.act) if lt == LayerType.AGGREGATE else None
            pending = []
            continue
        if agg is None:
            continue
        is_compute = (ins.op in (Opcode.SPDMM, Opcode.GEMM)
                      or (ins.op == Opcode.NOP and ins.flags & FLAG_UNLOCK))
        if is_compute:
            j, k, _i, packed = ins.args
            groups.append(_Group(j=j, k=k, s=packed >> 1, dyn=packed & 1,
                                 agg=agg, compute=idx, mem=tuple(pending)))
            pending = []
        elif ins.op in (Opcode.MEM_RD, Opcode.NOP):
            pending.append(idx)
        else:                    # ACT/AFFINE/MEM_WR close any pending run
            pending = []
    return groups


def _set_opcode(words: np.ndarray, idx: int, op: Opcode) -> None:
    words[idx, 0] = (int(words[idx, 0]) & 0xFFFFFF00) | int(op)


def _restore_group(words: np.ndarray, instrs: List[Instr], g: _Group,
                   pg) -> None:
    """Rewrite one group back to its canonical SpDMM encoding."""
    slices = pg.tiles.get((g.j, g.k), [])
    nnz = int(slices[g.s].nnz) if g.s < len(slices) else 0
    _set_opcode(words, g.compute, Opcode.SPDMM)
    words[g.compute, 3] = nnz
    for m in g.mem:
        _set_opcode(words, m, Opcode.MEM_RD)
        ins = instrs[m]
        if ins.args[0] == int(Buf.EDGE) and \
                ins.args[1] == int(Region.SUBSHARD):
            words[m, 3] = nnz


# --------------------------------------------------------------------------- #
# Decision + application
# --------------------------------------------------------------------------- #
def _decide(st: dict, n1: int, n2: int, c: ModelConstants, margin: float,
            allowed: set, probe_t: Optional[dict],
            slice_widths: Sequence[int]) -> Tuple[str, float]:
    """(mode, predicted per-step gain seconds) for one (j, k) tile."""
    nnz, width, n_slices = st["nnz"], st["width"], st["slices"]
    if probe_t is not None:
        t_sp = sum(probe_t["spdmm"].get(int(w), 0.0) for w in slice_widths)
        t_ge = max(n_slices, 1) * probe_t["gemm"]
    else:
        t_sp, t_ge = price_tile(nnz, width, n_slices, n1, n2, c)
    if nnz == 0 and "skip" in allowed:
        return "skip", t_sp
    gemm_ok = ("gemm" in allowed
               and n1 * n1 * n2 <= 0xFFFFFFFF)       # arg4 encoding range
    if gemm_ok and t_ge * (1.0 + margin) < t_sp:
        return "gemm", t_sp - t_ge
    return "spdmm", 0.0


def remap_program(prog, *, source: str = "auto", constants: Any = None,
                  margin: float = 0.1, force: Any = None,
                  modes: Optional[Sequence[str]] = None,
                  only_tiles: Optional[Sequence[str]] = None,
                  probe: bool = False, ack: Any = None,
                  device: Any = "cpu"):
    """Re-encode ``prog``'s aggregate kernel fields from tile sparsity.

    Returns a new :class:`~repro_torch.engine.program.CompiledProgram` sharing
    weights/pgraph with ``prog`` — only the binary and manifest differ.
    The manifest gains a ``remap`` record (decision per tile, source,
    constants, signature) and a refreshed ``dep_graph``; the cache key is
    untouched.

    ``only_tiles`` limits re-decision to the named ``"j:k"`` tiles (the
    livegraph incremental path); every other tile's encoding — canonical
    or previously remapped — is byte-preserved.  ``force`` pins the mode
    ("gemm" / "spdmm" / "skip", or a per-tile dict) for oracle tests;
    forced skip is only honored on genuinely empty tiles.  ``probe=True``
    replaces the roofline with kernel microbenchmarks via ``ack`` on
    ``device`` (the executor's).
    """
    from repro_torch.obs.tracer import get_tracer
    t0 = time.perf_counter()
    pg = prog.pgraph
    n1, n2 = pg.config.n1, pg.config.n2
    c, calibrated = resolve_constants(constants)
    stats, src = resolve_density(prog, source)
    allowed = set(modes) if modes is not None else set(MODES)
    bad = allowed - set(MODES)
    if bad:
        raise ValueError(f"unknown remap modes {sorted(bad)}")
    target = set(only_tiles) if only_tiles is not None else None

    probe_t = None
    if probe:
        if ack is None:
            raise ValueError("probe=True needs an ACK instance")
        widths = sorted({int(t.cols.shape[1])
                         for slices in pg.tiles.values() for t in slices})
        probe_t = probe_oracle(ack, n1, n2, widths, device=device)

    decisions: Dict[str, dict] = {}
    for jk, st in stats.items():
        if target is not None and jk not in target:
            continue
        j, k = (int(x) for x in jk.split(":"))
        widths = [int(t.cols.shape[1]) for t in pg.tiles.get((j, k), [])]
        mode, gain = _decide(st, n1, n2, c, margin, allowed, probe_t, widths)
        pin = force.get(jk) if isinstance(force, dict) else force
        if pin in ("gemm", "spdmm"):
            mode, gain = pin, 0.0
            if pin == "gemm" and n1 * n1 * n2 > 0xFFFFFFFF:
                mode = "spdmm"
        elif pin == "skip" and st["nnz"] == 0:
            mode = "skip"
        decisions[jk] = {"mode": mode, "density": round(st["density"], 6),
                         "nnz": st["nnz"], "gain_s": gain}

    words = np.frombuffer(prog.binary, dtype="<u4",
                          offset=HEADER_BYTES).reshape(-1, 4).copy()
    instrs = [Instr.decode(w) for w in words]
    groups = _scan_groups(instrs)
    for g in groups:
        d = decisions.get(f"{g.j}:{g.k}")
        if d is None:
            continue                       # outside only_tiles: untouched
        _restore_group(words, instrs, g, pg)
        eff = d["mode"]
        if eff == "gemm" and g.agg not in (AggOp.SUM, AggOp.MEAN):
            eff = "spdmm"                  # max/min stay on the sparse path
        if eff == "gemm":
            _set_opcode(words, g.compute, Opcode.GEMM)
            words[g.compute, 3] = n1 * n1 * n2
        elif eff == "skip":
            for idx in (*g.mem, g.compute):
                _set_opcode(words, idx, Opcode.NOP)
    new_binary = prog.binary[:HEADER_BYTES] + words.tobytes()

    # Merge with a prior record (incremental path), then recount from the
    # final word stream so the record always matches the binary.
    old = prog.manifest.get("remap") or {}
    tiles = dict(old.get("tiles", {})) if target is not None else {}
    tiles.update(decisions)
    counts = {"spdmm": 0, "gemm": 0, "skip": 0}
    for d in tiles.values():
        counts[d["mode"]] += 1
    skipped_ops = remapped_ops = elided = 0
    for g in groups:
        op = int(words[g.compute, 0]) & 0xFF
        if op == int(Opcode.NOP):
            skipped_ops += 1
            elided += 1 + sum(
                1 for m in g.mem if int(words[m, 0]) & 0xFF == 0)
        elif op == int(Opcode.GEMM):
            remapped_ops += 1
    record = {
        "signature": remap_signature(tiles, src, margin, c),
        "source": src,
        "margin": margin,
        "probe": bool(probe),
        "calibrated": bool(calibrated),
        "constants": {"peak_flops": c.peak_flops, "vpu_flops": c.vpu_flops,
                      "hbm_bw": c.hbm_bw},
        "tiles": tiles,
        "counts": counts,
        "remapped_ops": remapped_ops,
        "skipped_tile_ops": skipped_ops,
        "elided_ops": elided,
        "predicted_gain_s": sum(d["gain_s"] for d in tiles.values()),
    }
    new_manifest = dict(prog.manifest)
    new_manifest["remap"] = record
    from repro_torch.engine.program import _dep_graph_section
    new_manifest["dep_graph"] = _dep_graph_section(new_binary, new_manifest,
                                                   pg)
    record["remap_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    get_tracer().instant(
        "remap", cat="compile",
        args={"source": src, "calibrated": bool(calibrated),
              "probe": bool(probe), "counts": counts,
              "remapped_ops": remapped_ops, "skipped_tile_ops": skipped_ops,
              "incremental": target is not None,
              "tiles_considered": len(decisions),
              "remap_ms": record["remap_ms"]})
    return dataclasses.replace(prog, binary=new_binary,
                               manifest=new_manifest, _plan=None)


def remap_signature(tiles: Dict[str, dict], source: str, margin: float,
                    c: ModelConstants) -> str:
    """Stable digest of a remap decision set (what changed vs the cache
    key's canonical binary)."""
    payload = {
        "tiles": {jk: d["mode"] for jk, d in sorted(tiles.items())},
        "source": source,
        "margin": margin,
        "constants": [c.peak_flops, c.vpu_flops, c.hbm_bw],
    }
    return hashlib.sha1(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
