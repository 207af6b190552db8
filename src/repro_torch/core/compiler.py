"""GraphAGILE software compiler (paper §6, Fig. 1).

  inputs : GNN ModelIR (from the PyG-like builders) + input graph
  output : CompileResult — the Program, the serialized 128-bit binary,
           per-pass reports, and T_LoC (compilation latency).

Pipeline: Input parsing/IR -> Step 1 order optimization -> Step 2 layer
fusion -> Step 3 fiber-shard partitioning -> Step 4 kernel mapping + task
scheduling -> code generation.

The public entry point is :class:`repro_torch.engine.Engine`
(``engine.compile`` wraps :func:`run_pipeline`).  This module is a copy
of the JAX package's compiler: ``tests/test_torch_compiler.py`` holds
its binaries byte-identical to that compiler's, so a ``.gagi`` bundle
from either package runs on either executor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.obs.tracer import get_tracer

from .graph import Graph
from .ir import ModelIR
from .isa import assemble
from .passes import fusion, kernel_map, order_opt, schedule
from .passes.kernel_map import Program
from .passes.partition import (PartitionConfig, choose_partition,
                               partition_graph)


@dataclasses.dataclass
class CompileOptions:
    order_opt: bool = True
    fusion: bool = True
    n_pes: int = 8                      # paper: 8 PEs on Alveo U250
    partition: Optional[PartitionConfig] = None
    vmem_budget_bytes: int = 3 << 20    # paper: 3MB feature buffer / PE


@dataclasses.dataclass
class CompileResult:
    program: Program
    binary: bytes
    t_loc: float                        # seconds — the paper's T_LoC
    order_report: order_opt.OrderOptReport
    fusion_report: fusion.FusionReport
    schedule_report: schedule.ScheduleReport

    @property
    def binary_bytes(self) -> int:
        return len(self.binary)


def run_pipeline(
    model: ModelIR, g: Graph, opts: Optional[CompileOptions] = None
) -> CompileResult:
    """The §6 software-compilation pipeline (internal entry point)."""
    opts = opts or CompileOptions()
    tracer = get_tracer()
    t0 = time.perf_counter()

    m = model.copy()
    # Step 1: computation order optimization.
    with tracer.span("order_opt", cat="compile", track="compile"):
        orep = order_opt.run(m, enabled=opts.order_opt)
    # Step 2: layer fusion.
    with tracer.span("fusion", cat="compile", track="compile") as sp:
        frep = fusion.run(m, enabled=opts.fusion)
        sp.add(layers_before=frep.layers_before,
               layers_after=frep.layers_after)
    # Step 3: data partitioning (O(|V| + |E|)).
    with tracer.span("partition", cat="compile", track="compile") as sp:
        f_max = max(max(l.f_in, l.f_out) for l in m.layers.values())
        cfg = opts.partition or choose_partition(
            g.n_vertices, f_max, opts.vmem_budget_bytes)
        pg = partition_graph(g, cfg)
        sp.add(n1=cfg.n1, n2=cfg.n2, blocks=pg.n_blocks)
    # Step 4: kernel mapping + task scheduling.
    with tracer.span("kernel_map", cat="compile", track="compile"):
        prog = kernel_map.run(m, pg, n_pes=opts.n_pes)
    with tracer.span("schedule", cat="compile", track="compile"):
        srep = schedule.run(prog, n_pes=opts.n_pes)
    # Code generation.
    with tracer.span("codegen", cat="compile", track="compile") as sp:
        binary = assemble(prog.all_instrs())
        sp.add(binary_bytes=len(binary))

    t_loc = time.perf_counter() - t0
    return CompileResult(program=prog, binary=binary, t_loc=t_loc,
                         order_report=orep, fusion_report=frep,
                         schedule_report=srep)

