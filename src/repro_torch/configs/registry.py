"""Registry of the architectures the port runs (``--arch <id>``).

Only what the port runs is listed: qwen3-0.6b, granite-8b, gemma3-12b and
gemma3-27b, dense GQA decoders (granite's LM head is untied; gemma3
interleaves five sliding-window layers with one global layer).  The JAX
package's other architectures (``repro.configs.registry``) raise
NotImplementedError here until their blocks are ported (ROADMAP A15).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-8b": "granite_8b",
    "gemma3-12b": "gemma3_12b",
    "gemma3-27b": "gemma3_27b",
}

ARCHS: List[str] = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"architecture {arch!r} does not run in repro_torch (ROADMAP "
            f"A15 lists what is left to port); the port runs {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
