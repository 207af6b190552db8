"""Registry of the architectures the port runs (``--arch <id>``).

Every architecture of the JAX package's registry
(``repro.configs.registry``) is listed: qwen3-0.6b, granite-8b,
gemma3-12b and gemma3-27b, dense GQA decoders (granite's LM head is
untied; gemma3 interleaves five sliding-window layers with one global
layer); kimi-k2-1t-a32b, a GQA decoder (64 query heads over 8 KV heads of
112) whose layers after the first dense one take a MoE FFN of 384 experts,
top-8, and a shared expert; deepseek-v3-671b, MLA attention (a low-rank
query, a latent KV cache) with a MoE FFN of 256 experts after three dense
layers; llama-3.2-vision-11b, a GQA decoder with a cross-attention block
every fifth layer; whisper-base, an encoder-decoder; hymba-1.5b, windowed
GQA attention beside parallel SSM heads in every layer; and xlstm-125m,
alternating mLSTM and sLSTM blocks.  An unknown name raises
NotImplementedError.
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
    "kimi-k2-1t-a32b": "kimi_k2",
    "deepseek-v3-671b": "deepseek_v3",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-base": "whisper_base",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-125m": "xlstm_125m",
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
