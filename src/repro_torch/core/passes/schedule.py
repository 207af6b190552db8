"""Compiler Step 4b — task scheduling (paper §6.6, Algorithm 9).

GraphAGILE executes layer by layer.  Within a layer, Tiling Blocks are
assigned to PEs.  The paper does this *dynamically* (idle PE pulls the next
block); in an SPMD software overlay the equivalent is a static balanced
assignment computed at compile time: Longest-Processing-Time (LPT) greedy
bin packing on the per-block cost estimate, which equalizes per-PE work the
same way the idle-PE rule does (and is deterministic, which SPMD needs).
The dynamic behaviour lives in the host serving runtime
(``repro/runtime/serve_loop.py``): its work queue feeds whichever overlay
drains first, and ``repro/runtime/pool.py`` reuses :func:`lpt_assign`
below to place new cache keys on the least-loaded overlay — the idle-PE
rule lifted to request granularity.

Double-buffer overlap: within each PE stream, the MEM_RD instructions of
tiling block t+1 may issue while block t computes (paper's
lock/unlock-annotated WAR protection).  The executor realizes this with
async dispatch; `overlap=False` inserts a barrier after every block
(used by the Fig. 16 ablation).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ir import LayerType
from .kernel_map import Program


@dataclasses.dataclass
class ScheduleReport:
    per_layer_imbalance: List[float]   # max/mean PE load per layer

    @property
    def worst_imbalance(self) -> float:
        return max(self.per_layer_imbalance, default=1.0)


def lpt_assign(costs: Sequence[float], n_bins: int,
               initial_loads: Optional[Sequence[float]] = None
               ) -> Tuple[List[int], List[float]]:
    """Longest-Processing-Time greedy bin packing.

    Items are visited in decreasing cost order; each goes to the
    currently least-loaded bin (ties broken by lowest bin index, so the
    assignment is deterministic).  ``initial_loads`` seeds the bins with
    pre-existing work — the serving runtime passes each overlay's
    outstanding load so new keys land on the idle overlay, mirroring the
    paper's idle-PE-pulls-next-block rule.

    Returns ``(assignment, loads)``: the bin index per item (input
    order) and the final per-bin loads.
    """
    loads = list(initial_loads) if initial_loads is not None \
        else [0.0] * n_bins
    if len(loads) != n_bins:
        raise ValueError(f"initial_loads has {len(loads)} bins, "
                         f"expected {n_bins}")
    heap = [(load, b) for b, load in enumerate(loads)]
    heapq.heapify(heap)
    assignment = [0] * len(costs)
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    for i in order:
        load, b = heapq.heappop(heap)
        assignment[i] = b
        loads[b] = load + costs[i]
        heapq.heappush(heap, (loads[b], b))
    return assignment, loads


# --------------------------------------------------------------------------- #
# Partition-centric residency schedule (paper §6.5, Algorithms 6-8).
#
# The streaming executor works one DESTINATION SHARD at a time: it stages
# shard j's working set (its (j, k) sub-shard tiles plus the source
# sub-fibers k they reference) in the device buffers, computes, writes the
# output sub-fibers back to the host, and meanwhile prefetches shard
# j+1's working set — the paper's computation/communication overlap with
# double-buffered DDR<->BRAM transfers.  This pass emits everything that
# executor needs as *manifest data* so a program loaded from a ``.gagi``
# file streams identically to one compiled in-process:
#
#   * per-layer destination-shard order, greedily sequenced so that
#     consecutive shards share staged source blocks (transfer reuse);
#   * per-shard source-block lists (which sub-fibers to stage);
#   * an interval-liveness table: for every layer output (and the input
#     features, id -1), the position of its LAST consumer in the layer
#     stream — the executor frees each padded output the moment its last
#     consumer has run, so peak memory follows the live-set, not the
#     model depth.
# --------------------------------------------------------------------------- #
def _layer_consumes(l) -> List[int]:
    """Value ids layer ``l`` reads (−1 = the input feature matrix),
    mirroring the executor's operand resolution exactly."""
    ewl = l.attrs.get("edge_weight_layer")
    feat_parents = [p for p in l.parent_ids if p != ewl]
    if l.layer_type == LayerType.VECTOR_ADD:
        consumed = [int(o) for o in l.attrs.get("operands", [])]
    else:
        consumed = [int(feat_parents[0]) if feat_parents else -1]
    if ewl is not None:
        consumed.append(int(ewl))
    return consumed


def _order_shards(sources: Dict[int, Set[int]]) -> List[int]:
    """Greedy max-overlap sequencing of destination shards: start at the
    lowest shard id, then repeatedly pick the unvisited shard sharing
    the most source blocks with the working set just staged (ties to
    the lowest id, so the order is deterministic).  Consecutive shards
    then reuse staged sub-fibers instead of re-transferring them."""
    todo = sorted(sources)
    if not todo:
        return []
    order = [todo.pop(0)]
    while todo:
        prev = sources[order[-1]]
        best = max(todo, key=lambda j: (len(sources[j] & prev), -j))
        todo.remove(best)
        order.append(best)
    return order


def residency_schedule(prog: Program) -> dict:
    """Shard order + source lists + liveness, as JSON-ready manifest data.

    Keys are stringified so the in-process manifest is byte-identical to
    one round-tripped through ``.gagi`` (json object keys are strings).
    """
    last_use: Dict[int, int] = {}
    layers: Dict[str, dict] = {}
    sink_pos = len(prog.layer_blocks)
    for t, lb in enumerate(prog.layer_blocks):
        for c in _layer_consumes(lb.layer):
            last_use[c] = t
        sources: Dict[int, Set[int]] = {}
        for tb in lb.tiling_blocks:
            j = tb.out_j
            if j < 0:
                continue
            e = sources.setdefault(j, set())
            if tb.kind == "spdmm":
                e.update(k for k, _ in tb.k_list)
            elif tb.kind == "sddmm":
                e.add(j)
                e.add(tb.tile_k)
            elif tb.kind in ("act", "affine") and tb.out_i < 0:
                pass                        # edge activation: no fibers
            else:
                e.add(j)                    # gemm/vadd/act: own row block
        order = _order_shards(sources)
        layers[str(lb.layer_id)] = {
            "shard_order": [int(j) for j in order],
            "sources": {str(j): sorted(int(k) for k in ks)
                        for j, ks in sources.items()},
        }
    # The sink is consumed by the final output slice, after every layer.
    if prog.layer_blocks:
        last_use[prog.layer_blocks[-1].layer_id] = sink_pos
    return {
        "last_use": {str(k): int(v) for k, v in sorted(last_use.items())},
        "layers": layers,
    }


# --------------------------------------------------------------------------- #
# Placement schedule — the multi-device generalization of the residency
# schedule.  "Where a shard runs" becomes a compiler output: destination
# row blocks are LPT-assigned to the devices of a mesh (reusing
# :func:`lpt_assign`, the same greedy rule that balances tiling blocks
# over PEs), each device gets its own greedy max-overlap shard order, and
# the per-device HALO sets (source sub-fibers a device gathers from but
# does not own, :func:`repro.core.passes.partition.halo_sets`) are
# recorded per layer so the exchange volume is known at compile time.
# The whole structure is JSON-ready manifest data and round-trips
# ``.gagi`` files; executors derive it from the binary for bundles
# written before manifests carried a ``placement`` section (mirroring
# ``derive_residency``).
# --------------------------------------------------------------------------- #
def shard_block_costs(layer_tiles, n_blocks: int) -> List[float]:
    """Per-destination-row-block load estimate: the number of compute
    instructions targeting the block, summed over all layers.

    ``layer_tiles`` yields per-layer iterables of tiling blocks exposing
    ``out_j`` and a compute-step count.  The metric is chosen so the
    compiler (counting ``k_list`` reduction steps) and the binary
    decoder (counting decoded compute instructions) agree EXACTLY,
    which is what makes the derivation fallback reproduce the emitted
    schedule bit-for-bit."""
    costs = [0.0] * n_blocks
    for tiles in layer_tiles:
        for out_j, n_steps in tiles:
            if out_j >= 0:
                costs[out_j] += n_steps
    return costs


def build_placement(residency: dict, costs: Sequence[float],
                    n_devices: int, n1: int, n2: int,
                    f_in: Dict[str, int]) -> dict:
    """Assemble the placement schedule from its ingredients.

    Shared by :func:`placement_schedule` (compile time, costs from
    TilingBlocks) and ``engine.executor.derive_placement`` (load time,
    costs from the decoded binary) so both produce identical manifests
    given identical inputs.  ``f_in`` maps stringified layer id -> input
    feature width (sizes the halo sub-fibers of that layer)."""
    from .partition import halo_sets
    nb = len(costs)
    assignment, loads = lpt_assign(costs, n_devices)
    layers: Dict[str, dict] = {}
    halo_total = 0
    for lid, rl in residency["layers"].items():
        sources = rl["sources"]
        halos = halo_sets(assignment, sources, n_devices)
        fp = ((max(int(f_in[lid]), 1) + n2 - 1) // n2) * n2
        sub_bytes = n1 * fp * 4
        order: Dict[str, List[int]] = {}
        halo_bytes: Dict[str, int] = {}
        for d in range(n_devices):
            own = {int(j): set(int(k) for k in ks)
                   for j, ks in sources.items()
                   if assignment[int(j)] == d}
            order[str(d)] = [int(j) for j in _order_shards(own)]
            halo_bytes[str(d)] = len(halos[d]) * sub_bytes
            halo_total += halo_bytes[str(d)]
        layers[lid] = {
            "order": order,
            "halo": {str(d): [int(k) for k in halos[d]]
                     for d in range(n_devices)},
            "halo_bytes": halo_bytes,
        }
    return {
        "n_devices": int(n_devices),
        "assignment": [int(a) for a in assignment],
        "loads": [float(l) for l in loads],
        "halo_bytes_total": int(halo_total),
        "layers": layers,
    }


def _tb_steps(tb) -> int:
    """Compute-instruction count of a compiler TilingBlock — matches
    ``len(TilePlan.compute)`` of the same block after decode."""
    return (len(tb.k_list) if tb.kind in ("spdmm", "gemm", "sddmm")
            else 1)


def placement_schedule(prog: Program, n_devices: int,
                       residency: Optional[dict] = None) -> dict:
    """Shard -> device placement + per-device order + halo sets, as
    JSON-ready manifest data (see :func:`build_placement`)."""
    res = residency if residency is not None else residency_schedule(prog)
    costs = shard_block_costs(
        ([(tb.out_j, _tb_steps(tb)) for tb in lb.tiling_blocks]
         for lb in prog.layer_blocks),
        prog.pgraph.n_blocks)
    f_in = {str(lb.layer_id): int(lb.layer.f_in)
            for lb in prog.layer_blocks}
    cfg = prog.pgraph.config
    return build_placement(res, costs, n_devices, cfg.n1, cfg.n2, f_in)


def run(prog: Program, n_pes: int = 8) -> ScheduleReport:
    """LPT-assign tiling blocks to PEs; annotate pe ids on instructions."""
    prog.n_pes = n_pes
    imbalances: List[float] = []
    for lb in prog.layer_blocks:
        tbs = lb.tiling_blocks
        assignment, loads = lpt_assign([tb.cost for tb in tbs], n_pes)
        for tb, pe in zip(tbs, assignment):
            tb.pe = pe
            for ins in tb.instrs:
                ins.pe = pe
        mean = sum(loads) / n_pes
        imbalances.append((max(loads) / mean) if mean > 0 else 1.0)
    return ScheduleReport(per_layer_imbalance=imbalances)
