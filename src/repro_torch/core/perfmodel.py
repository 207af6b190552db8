"""Analytic latency model for the overlay, priced for one NVIDIA H100
(a copy of ``repro/core/perfmodel.py`` apart from its default constants;
the two are held equal by a test under equal constants).

The default constants are the H100 SXM5 80GB data-sheet figures at its
700 W power limit, so ``Engine.remap`` with no report prices the card the
port runs on.  The port's GEMM, SpDMM and SDDMM kernels are fp32 kernels
on the CUDA cores, so the compute peaks are the fp32 rate.  A conformance
report (:mod:`repro_torch.obs.conformance`) fits *effective* constants
from measured runs; ``remap(probe=True)`` instead times the port's own
kernels on the card.

The paper evaluates T_LoH with a cycle-accurate simulator of the Alveo
U250 design; our hardware-adapted equivalent is a roofline model over the
compiled Program: each tiling block costs
    max(flops / peak_flops, hbm_bytes / hbm_bw)
(double-buffering overlaps the loads of block t+1 with the compute of
block t — the paper's Fig. 16 optimization — so the max, not the sum),
blocks execute on their assigned PE, and a layer ends when its slowest PE
drains (Algorithm 9 barrier).  ``overlap=False`` models the ablation
(sum instead of max).

``residency="host"`` adds the out-of-core streaming term: every block's
input operands cross the host→device staging link (PCIe-class bandwidth,
``ModelConstants.stage_bw``), double-buffered per shard window so the
layer costs max(exec, stage) under overlap and their sum without.

The model's machine constants live in :class:`ModelConstants` so
a conformance report can fit *effective* constants from measured
runs and re-predict with them; per-block and per-layer breakdowns
(:func:`block_costs`, :func:`layer_costs`) expose what ``predict_loh``
previously reduced to a scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .ir import LayerType
from .passes.kernel_map import Program

# NVIDIA H100 SXM5 80GB at its 700 W power limit, data-sheet figures.
PEAK_FLOPS = 67e12         # H100 SXM5 80GB, 700 W: fp32 on the CUDA cores
VPU_FLOPS = 67e12          # H100 SXM5 80GB, 700 W: fp32 (sparse modes too)
HBM_BW = 3.35e12           # H100 SXM5 80GB, 700 W: HBM3
STAGE_BW = 64e9            # H100 SXM5 80GB, 700 W: PCIe Gen5 x16 host link

# layer-level kernel dispatch, mirroring the executor's _KERNEL_MODES
KERNEL_OF_LAYER = {
    LayerType.AGGREGATE: "spdmm",
    LayerType.LINEAR: "gemm",
    LayerType.VECTOR_INNER: "sddmm",
    LayerType.VECTOR_ADD: "vadd",
    LayerType.ACTIVATION: "act",
    LayerType.BATCHNORM: "act",
}
# tiling-block kinds fold the same way (affine epilogues run on the VPU
# activation path)
KERNEL_OF_KIND = {"affine": "act"}


@dataclasses.dataclass(frozen=True)
class ModelConstants:
    """Machine constants the roofline is evaluated against.

    The defaults are datasheet numbers; conformance calibration
    (:func:`repro_torch.obs.conformance.build_report`) produces a
    fitted instance.
    """

    peak_flops: float = PEAK_FLOPS
    vpu_flops: float = VPU_FLOPS
    hbm_bw: float = HBM_BW
    stage_bw: float = STAGE_BW

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


DEFAULT_CONSTANTS = ModelConstants()


@dataclasses.dataclass
class BlockCost:
    """Predicted cost of one tiling block (one PE work item)."""

    layer_id: int
    kind: str            # tiling-block kind: gemm/spdmm/sddmm/vadd/act/affine
    kernel: str          # executor kernel mode (affine -> act)
    pe: int
    flops: float
    hbm_bytes: float     # total HBM traffic (inputs + output)
    stage_bytes: float   # input operand bytes crossing the h2d link
    t_compute: float
    t_memory: float
    t: float             # effective block time: max(c, m) or sum


@dataclasses.dataclass
class LayerCost:
    """Predicted cost of one layer (Algorithm 9 barrier to barrier)."""

    layer_id: int
    kernel: str
    n_blocks: int
    flops: float
    hbm_bytes: float
    stage_bytes: float
    t_exec: float        # slowest-PE drain time
    t_stage: float       # staging time under host residency (0 on device)
    t: float             # layer wall: max(exec, stage) or sum


def _block_terms(kind: str, tb, pg, f_in: int, c: ModelConstants):
    """Returns (flops, hbm_bytes, stage_in_bytes, t_compute, t_memory)."""
    n1, n2 = pg.config.n1, pg.config.n2
    if kind == "gemm":
        flops = 2.0 * n1 * n2 * n2 * max(len(tb.k_list), 1)
        in_bytes = (n1 * n2 * 4 * len(tb.k_list)
                    + n2 * n2 * 4 * len(tb.k_list))
        bytes_ = in_bytes + n1 * n2 * 4
        t_c, t_m = flops / c.peak_flops, bytes_ / c.hbm_bw
    elif kind == "spdmm":
        nnz = sum(pg.tiles[(tb.out_j, k)][s].nnz for k, s in tb.k_list) \
            if tb.k_list else 0
        flops = 2.0 * nnz * n2
        in_bytes = sum(
            pg.tiles[(tb.out_j, k)][s].cols.nbytes * 2 + n1 * n2 * 4
            for k, s in tb.k_list)
        bytes_ = in_bytes + n1 * n2 * 4
        t_c, t_m = flops / c.vpu_flops, bytes_ / c.hbm_bw
    elif kind == "sddmm":
        t = pg.tiles[(tb.out_j, tb.tile_k)][tb.slice_id]
        flops = 2.0 * t.nnz * f_in
        in_bytes = t.cols.nbytes * 2 + 2 * n1 * f_in * 4
        bytes_ = in_bytes + t.nnz * 4
        t_c, t_m = flops / c.vpu_flops, bytes_ / c.hbm_bw
    else:  # vadd / act / affine: bandwidth bound
        bytes_ = 3.0 * n1 * n2 * 4
        in_bytes = 2.0 * n1 * n2 * 4
        flops = 0.0
        t_c, t_m = bytes_ / c.hbm_bw / 8, bytes_ / c.hbm_bw
    return flops, bytes_, in_bytes, t_c, t_m


def _block_cost(kind: str, tb, pg, f_in: int, overlap: bool,
                constants: Optional[ModelConstants] = None) -> float:
    """Scalar effective time of one tiling block (kept for callers of the
    pre-refactor API)."""
    c = constants or DEFAULT_CONSTANTS
    _, _, _, t_c, t_m = _block_terms(kind, tb, pg, f_in, c)
    return max(t_c, t_m) if overlap else (t_c + t_m)


def block_costs(prog: Program, overlap: bool = True,
                constants: Optional[ModelConstants] = None
                ) -> List[BlockCost]:
    """Per-tiling-block predicted costs for every layer of ``prog``."""
    c = constants or DEFAULT_CONSTANTS
    out: List[BlockCost] = []
    for lb in prog.layer_blocks:
        for tb in lb.tiling_blocks:
            fl, by, sb, t_c, t_m = _block_terms(
                tb.kind, tb, prog.pgraph, lb.layer.f_in, c)
            out.append(BlockCost(
                layer_id=lb.layer_id, kind=tb.kind,
                kernel=KERNEL_OF_KIND.get(tb.kind, tb.kind), pe=tb.pe,
                flops=fl, hbm_bytes=by, stage_bytes=sb,
                t_compute=t_c, t_memory=t_m,
                t=max(t_c, t_m) if overlap else (t_c + t_m)))
    return out


def layer_costs(prog: Program, overlap: bool = True,
                residency: str = "device",
                constants: Optional[ModelConstants] = None
                ) -> List[LayerCost]:
    """Per-layer predicted costs.

    ``residency="host"`` charges each layer's input operand bytes to the
    staging link; double-buffering hides the smaller of (exec, stage)
    under the larger when ``overlap``.
    """
    if residency not in ("device", "host"):
        raise ValueError(f"unknown residency {residency!r}")
    c = constants or DEFAULT_CONSTANTS
    blocks = block_costs(prog, overlap=overlap, constants=c)
    by_layer: Dict[int, List[BlockCost]] = {}
    for b in blocks:
        by_layer.setdefault(b.layer_id, []).append(b)
    out: List[LayerCost] = []
    for lb in prog.layer_blocks:
        bs = by_layer.get(lb.layer_id, [])
        pe_time: Dict[int, float] = {}
        for b in bs:
            pe_time[b.pe] = pe_time.get(b.pe, 0.0) + b.t
        t_exec = max(pe_time.values(), default=0.0)
        stage_bytes = sum(b.stage_bytes for b in bs)
        t_stage = (stage_bytes / c.stage_bw
                   if residency == "host" else 0.0)
        t = max(t_exec, t_stage) if overlap else (t_exec + t_stage)
        out.append(LayerCost(
            layer_id=lb.layer_id,
            kernel=KERNEL_OF_LAYER.get(lb.layer.layer_type, "act"),
            n_blocks=len(bs),
            flops=sum(b.flops for b in bs),
            hbm_bytes=sum(b.hbm_bytes for b in bs),
            stage_bytes=stage_bytes,
            t_exec=t_exec, t_stage=t_stage, t=t))
    return out


def predict_loh(prog: Program, overlap: bool = True,
                residency: str = "device",
                constants: Optional[ModelConstants] = None) -> float:
    """Predicted hardware-execution latency (seconds) under
    ``constants`` (the H100 data-sheet defaults when None)."""
    return sum(lc.t for lc in layer_costs(
        prog, overlap=overlap, residency=residency, constants=constants))
