"""repro_torch.engine — the GraphAGILE engine API on torch.

  * :class:`Engine` — one overlay instance on one device; ``compile`` /
    ``run`` / ``load`` / ``submit`` / ``serve``.
  * :class:`CompiledProgram` — 128-bit ISA binary + weights/graph
    manifest; ``save``/``load`` round-trip ``.gagi`` files, the same
    format the JAX package writes.
  * :class:`BinaryExecutor` — executes by decoding the binary.
"""
from .cache import LRUCache
from .decoder import ExecutionPlan, LayerPlan, TilePlan, decode_binary
from .engine import (Engine, EngineStats, InferenceRequest,
                     InferenceResponse, graph_signature, model_signature)
from .executor import BinaryExecutor, ExecStats, ResidentBudgetError
from .program import CompiledProgram, build_manifest, from_program

__all__ = [
    "Engine", "EngineStats", "InferenceRequest", "InferenceResponse",
    "CompiledProgram", "BinaryExecutor", "ExecStats",
    "ResidentBudgetError", "LRUCache",
    "ExecutionPlan", "LayerPlan", "TilePlan", "decode_binary",
    "build_manifest", "from_program", "graph_signature", "model_signature",
]
