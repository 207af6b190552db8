"""repro_torch.verify — static program verification for GraphAGILE binaries.

The port's copy of ``repro/verify`` (``model``, ``hazards``, ``checks``,
``race``, ``report`` and the command line), over the port's decoder,
schedule and executor; its reports equal the JAX package's.

Decodes a program (bytes, :class:`ExecutionPlan`, ``.gagi`` bundle, or
in-memory :class:`CompiledProgram`) into a def/use model of tile
buffers, derives the RAW/WAR/WAW hazard graph, and runs a checker suite
over it — def-before-use, use-after-free vs the residency schedule,
partition coverage, kernel-mode legality, halo completeness, an
independent re-derivation of the device-resident peak, and structural
binary sanity.  Nothing is executed.  A second consumer
(:func:`check_trace`) turns the hazard edges into a race detector over
recorded ``repro_torch.obs`` traces; on a CUDA trace it proves the
order in which the host issued the work, not the device's order (see
:mod:`repro_torch.verify.race`).

    from repro_torch.verify import verify
    report = verify(prog)            # or verify(blob), verify("x.gagi")
    assert report.ok, report.to_markdown()

CLI: ``python -m repro_torch.verify program.gagi [--json out] [--md out]``.
"""
from .checks import (check_def_before_use, check_halo_completeness,
                     check_kernel_legality, check_liveness_schedule,
                     check_partition_coverage, check_resident_budget,
                     check_structure, check_use_after_free,
                     derive_last_use, derive_residency_tables,
                     rederive_device_peak_bytes, verify, verify_binary,
                     verify_gagi, verify_plan, verify_program)
from .hazards import (DEP_GRAPH_TILE_EDGE_CAP, HazardGraph,
                      build_hazards, dep_graph_manifest,
                      sources_by_shard)
from .model import (DefUseModel, TileOp, build_model, layer_consumes,
                    tile_slices_from_stats)
from .race import check_trace
from .report import ALL_CHECKS, VerifyError, VerifyReport, Violation

__all__ = [
    "ALL_CHECKS", "VerifyError", "VerifyReport", "Violation",
    "HazardGraph", "DefUseModel", "TileOp", "DEP_GRAPH_TILE_EDGE_CAP",
    "build_model", "build_hazards", "dep_graph_manifest",
    "sources_by_shard", "layer_consumes", "tile_slices_from_stats",
    "check_structure", "check_def_before_use", "check_use_after_free",
    "check_partition_coverage", "check_kernel_legality",
    "check_halo_completeness", "check_resident_budget",
    "check_liveness_schedule", "check_trace",
    "derive_last_use", "derive_residency_tables",
    "rederive_device_peak_bytes",
    "verify", "verify_binary", "verify_gagi", "verify_plan",
    "verify_program",
]
