"""Step factories: prefill and serve (one-token decode) steps (torch; a
port of ``repro/models/steps.py``; the train step is not ported yet,
ROADMAP A15).

The port's weights live in the :class:`DecoderLM` module, so the
``params`` argument of a step is that module (``model`` itself, or another
one of the same config); the call shapes are JAX's.
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import ModelConfig
from .transformer import DecoderLM


def resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the LM runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0
                ) -> DecoderLM:
    """A decoder LM with random weights from ``seed`` on ``device`` (CUDA
    unless the caller asks for another).  Encoder-decoder and non-dense
    configurations raise NotImplementedError (ROADMAP A15)."""
    if cfg.encoder_decoder or cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}"
            f"{', encoder-decoder' if cfg.encoder_decoder else ''}) is not "
            "ported to repro_torch yet (ROADMAP A15); the port builds dense "
            "decoders")
    return DecoderLM(cfg, device=resolve_device(device), seed=seed)


def make_serve_step(model: DecoderLM, cfg: ModelConfig):
    """One-token greedy decode: (params, cache, token, pos) -> (next
    [B, 1] int32, cache)."""

    def serve_step(params: DecoderLM, cache, token, pos: int):
        logits, cache = params.decode_step(cache, token, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step


def make_prefill_step(model: DecoderLM, cfg: ModelConfig):
    """Forward over the prompt; returns the last position's logits
    [B, vocab].  The head is applied to the last position only, which
    gives the same numbers as slicing the full logits."""

    def prefill(params: DecoderLM, batch: Dict[str, torch.Tensor]):
        x = params.hidden(batch["tokens"])
        return params._logits(x[:, -1, :])

    return prefill
