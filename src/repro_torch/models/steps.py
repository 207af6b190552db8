"""Step factories: train step, prefill and serve (one-token decode)
steps (torch; a port of ``repro/models/steps.py``).

The port's weights live in the :class:`DecoderLM` module, so the
``params`` argument of a step is that module (``model`` itself, or another
one of the same config); the call shapes are JAX's.  The train step
differentiates every parameter (``init_train_state`` turns their
gradients on) with ``torch.autograd.grad`` and updates them in place with
the in-house AdamW (``repro_torch.optim``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)

from .config import ModelConfig
from .layers import softmax_xent
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


def _check_trainable(cfg: ModelConfig) -> None:
    if cfg.encoder_decoder or cfg.cross_attn_every or cfg.is_moe:
        kind = ("encoder-decoder" if cfg.encoder_decoder else
                "cross-attention" if cfg.cross_attn_every else "MoE")
        raise NotImplementedError(
            f"training {cfg.name} ({kind}) is not ported to repro_torch yet "
            "(ROADMAP A15); the port trains dense decoders")


def value_and_grad(params: DecoderLM, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Dict[str, torch.Tensor]]:
    """(total, loss, aux, grads by parameter name) of JAX's ``loss_fn``:
    ``softmax_xent(logits, labels) + router_aux_coef * aux``."""
    named = dict(params.named_parameters())
    logits, aux = params(batch["tokens"])
    loss = softmax_xent(logits, batch["labels"])
    tot = loss + cfg.router_aux_coef * aux
    grads = torch.autograd.grad(tot, list(named.values()))
    return (tot.detach(), loss.detach(), aux.detach(),
            dict(zip(named, grads)))


def make_train_step(model: DecoderLM, cfg: ModelConfig,
                    base_lr: float = 3e-4):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and every gradient, the cosine-scheduled learning rate of the
    step count before the update, one AdamW update (params and state
    written in place).  ``metrics`` holds 0-d tensors ``loss`` and
    ``aux`` (on the model's device) and ``lr`` (on the CPU)."""
    _check_trainable(cfg)

    def train_step(params: DecoderLM, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        _, loss, aux, grads = value_and_grad(params, cfg, batch)
        lr = cosine_schedule(opt_state.step, base_lr)
        _, opt_state = adamw_update(dict(params.named_parameters()), grads,
                                    opt_state, lr)
        return params, opt_state, {"loss": loss, "aux": aux, "lr": lr}

    return train_step


def init_train_state(model: DecoderLM, keep_master: bool = True
                     ) -> Tuple[DecoderLM, AdamWState]:
    """The model with gradients on for every parameter (JAX
    differentiates every leaf) and a fresh AdamW state; the weights are
    the model's own (JAX draws them here from a key)."""
    _check_trainable(model.cfg)
    for p in model.parameters():
        p.requires_grad_(True)
    return model, adamw_init(dict(model.named_parameters()),
                             keep_master=keep_master)


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
