"""Whisper-style encoder-decoder (arXiv:2212.04356), backbone only (torch;
a port of ``repro/models/whisper.py``).

As in JAX the conv frontend is a stub: the encoder takes precomputed frame
embeddings [B, S_frames, D].  The encoder is a bidirectional transformer
over frames: each block's self-attention is non-causal, with RoPE, and
with default positions it reaches the flash kernel
(``attention.attention``; JAX passes ``arange(S)``, the same function).
The decoder is :class:`DecoderLM` with ``cross_attn_every=1``: a causal LM
with cross-attention to the encoder's output in every layer.

Parameters carry JAX's names: ``encoder.blocks.{i}.ln1 / attn / ln2 /
mlp``, ``encoder.final_norm`` and ``decoder.<DecoderLM's names>``
(``repro_torch.convert.lm_params_from_arrays`` unstacks JAX's encoder
blocks into them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from . import attention as A
from .config import ModelConfig
from .layers import rms_norm, swiglu
from .transformer import Block, DecoderLM, _frozen, _remat


class WhisperModel(nn.Module):
    """Encoder (``n_encoder_layers``) + decoder (``n_layers``) with random
    weights from ``seed`` on ``device`` (on ``meta`` shapes only); the
    encoder's weights are drawn first, then the decoder's."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0
                 ) -> None:
        super().__init__()
        assert cfg.encoder_decoder
        self.cfg = cfg
        device = torch.device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            Block(cfg, gen, device) for _ in range(cfg.n_encoder_layers))
        self.encoder.final_norm = _frozen(torch.zeros(
            cfg.d_model, dtype=cfg.torch_dtype, device=device))
        dec_cfg = dataclasses.replace(cfg, cross_attn_every=1,
                                      encoder_decoder=False)
        self.decoder = DecoderLM(dec_cfg, device=device,
                                 seed=seed + 1)

    @property
    def embed(self) -> nn.Parameter:
        """The decoder's embedding (``launch.serve`` and ``launch.train``
        read its device)."""
        return self.decoder.embed

    # ------------------------------------------------------------------ #
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S, D] (stub frontend output) -> encoder states."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype)
        wanted = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.encoder.parameters())
        body = _remat(self._enc_block, cfg.remat if wanted else "none")
        for bp in self.encoder.blocks:
            x = body(x, bp)
        return rms_norm(x, self.encoder.final_norm, cfg.norm_eps)

    def _enc_block(self, x: torch.Tensor, bp: Block) -> torch.Tensor:
        """One encoder layer, JAX's scan body."""
        cfg = self.cfg
        h = rms_norm(x, bp.ln1, cfg.norm_eps)
        x = x + A.attention(bp.attn, h, causal=False,
                            rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk)
        return x + swiglu(bp.mlp, rms_norm(x, bp.ln2, cfg.norm_eps))

    def forward(self, frames: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced encoder-decoder forward -> (logits, aux)."""
        return self.decoder(targets, cross_kv_x=self.encode(frames))

    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, seq_len: int,
                   cross_len: Optional[int] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """Decoder cache; ``seq_len`` = decoder target capacity;
        ``cross_len`` = encoder frames attended to (JAX's default,
        ``cfg.n_vision_tokens``, when None)."""
        return self.decoder.init_cache(batch, seq_len, cross_len=cross_len)

    def fill_cross_caches(self, cache: List[Dict[str, torch.Tensor]],
                          enc: torch.Tensor) -> None:
        """The decoder's :meth:`DecoderLM.fill_cross_caches` over the
        encoder states ``enc``."""
        self.decoder.fill_cross_caches(cache, enc)

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    token: torch.Tensor, pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        return self.decoder.decode_step(cache, token, pos)
