"""Step factories: train step, prefill and serve (one-token decode)
steps (torch; a port of ``repro/models/steps.py``).

The port's weights live in the model module (:class:`DecoderLM`, or
:class:`WhisperModel` for an encoder-decoder), so the ``params`` argument
of a step is that module (``model`` itself, or another one of the same
config); the call shapes are JAX's, batches included: ``tokens`` /
``labels`` (with ``vision`` for a cross-attention decoder) or ``frames``
/ ``targets`` / ``target_labels``.  The train step
differentiates every parameter (``init_train_state`` turns their
gradients on) with ``torch.autograd.grad`` and updates them in place with
the in-house AdamW (``repro_torch.optim``).  :func:`input_specs` gives a
dry-run cell's inputs, as meta tensors or zeros.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)

from .config import ModelConfig, ShapeCell
from .layers import softmax_xent
from .transformer import DecoderLM
from .whisper import WhisperModel

Model = Union[DecoderLM, WhisperModel]


def resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the LM runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                moe_impl: str = "dense", mesh=None) -> Model:
    """The model of ``cfg`` with random weights from ``seed`` on
    ``device`` (CUDA unless the caller asks for another): a
    :class:`WhisperModel` for an encoder-decoder, else a
    :class:`DecoderLM` (dense, with vision cross-attention, hymba's
    attention and SSM heads, xLSTM's mLSTM / sLSTM blocks, or MLA
    attention and MoE FFNs).  ``moe_impl`` and ``mesh`` are JAX's
    ``build_model`` arguments: how MoE blocks run ("dense", the default,
    or "a2a" over a ``launch.mesh.DeviceMesh``)."""
    if cfg.encoder_decoder:
        return WhisperModel(cfg, device=resolve_device(device), seed=seed)
    return DecoderLM(cfg, device=resolve_device(device), seed=seed,
                     moe_impl=moe_impl, mesh=mesh)


def _forward(params: Model, cfg: ModelConfig,
             batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, aux, labels) of JAX ``loss_fn``'s three branches."""
    if cfg.encoder_decoder:
        logits, aux = params(batch["frames"], batch["targets"])
        return logits, aux, batch["target_labels"]
    if cfg.cross_attn_every:
        logits, aux = params(batch["tokens"], cross_kv_x=batch["vision"])
    else:
        logits, aux = params(batch["tokens"])
    return logits, aux, batch["labels"]


def value_and_grad(params: Model, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Dict[str, torch.Tensor]]:
    """(total, loss, aux, grads by parameter name) of JAX's ``loss_fn``:
    ``softmax_xent(logits, labels) + router_aux_coef * aux``."""
    named = dict(params.named_parameters())
    logits, aux, labels = _forward(params, cfg, batch)
    loss = softmax_xent(logits, labels)
    tot = loss + cfg.router_aux_coef * aux
    grads = torch.autograd.grad(tot, list(named.values()))
    return (tot.detach(), loss.detach(), aux.detach(),
            dict(zip(named, grads)))


def make_train_step(model: Model, cfg: ModelConfig,
                    base_lr: float = 3e-4):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and every gradient, the cosine-scheduled learning rate of the
    step count before the update, one AdamW update (params and state
    written in place).  ``metrics`` holds 0-d tensors ``loss`` and
    ``aux`` (on the model's device) and ``lr`` (on the CPU)."""

    def train_step(params: Model, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        _, loss, aux, grads = value_and_grad(params, cfg, batch)
        lr = cosine_schedule(opt_state.step, base_lr)
        _, opt_state = adamw_update(dict(params.named_parameters()), grads,
                                    opt_state, lr)
        return params, opt_state, {"loss": loss, "aux": aux, "lr": lr}

    return train_step


def init_train_state(model: Model, keep_master: bool = True
                     ) -> Tuple[Model, AdamWState]:
    """The model with gradients on for every parameter (JAX
    differentiates every leaf) and a fresh AdamW state; the weights are
    the model's own (JAX draws them here from a key)."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model, adamw_init(dict(model.named_parameters()),
                             keep_master=keep_master)


def make_serve_step(model: Model, cfg: ModelConfig):
    """One-token greedy decode: (params, cache, token, pos) -> (next
    [B, 1] int32, cache); ``pos`` an int or a 0-d integer tensor on the
    model's device (what a captured step reads)."""

    def serve_step(params: Model, cache, token,
                   pos: Union[int, torch.Tensor]):
        logits, cache = params.decode_step(cache, token, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step


def make_prefill_step(model: Model, cfg: ModelConfig):
    """Forward over the prompt (JAX's three branches, as in the train
    step); returns the last position's logits [B, vocab].  The head is
    applied to the last position only, which gives the same numbers as
    slicing the full logits."""

    def prefill(params: Model, batch: Dict[str, torch.Tensor]):
        if cfg.encoder_decoder:
            dec = params.decoder
            x = dec.hidden(batch["targets"],
                           cross_kv_x=params.encode(batch["frames"]))
        else:
            dec = params
            x = dec.hidden(batch["tokens"], cross_kv_x=batch["vision"]
                           if cfg.cross_attn_every else None)
        return dec._logits(x[:, -1, :])

    return prefill


# --------------------------------------------------------------------------- #
def input_specs(cfg: ModelConfig, cell: ShapeCell, device="meta",
                zeros: bool = False) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of one (arch x shape) dry-run cell,
    with JAX's keys, shapes and dtypes: empty tensors on ``device`` (the
    meta device by default: shapes only), or zeros with ``zeros``.  A
    decode cell's inputs are ``token`` [B, 1] and ``pos`` (0-d); its cache
    is the model's own ``init_cache``."""
    def mk(shape, dtype):
        fill = torch.zeros if zeros else torch.empty
        return fill(shape, dtype=dtype, device=device)

    b, t = cell.global_batch, cell.seq_len
    dt = cfg.torch_dtype
    if cell.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            tl = cfg.decoder_target_len
            return {"frames": mk((b, t, cfg.d_model), dt),
                    "targets": mk((b, tl), torch.int32),
                    "target_labels": mk((b, tl), torch.int32)}
        out = {"tokens": mk((b, t), torch.int32),
               "labels": mk((b, t), torch.int32)}
        if cfg.cross_attn_every:
            out["vision"] = mk((b, cfg.n_vision_tokens, cfg.d_model), dt)
        if cell.kind == "prefill":
            out.pop("labels")
        return out
    # decode: one token + cache of seq_len
    return {"token": mk((b, 1), torch.int32),
            "pos": mk((), torch.int32)}
