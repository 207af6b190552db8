"""Config-driven decoder LM (torch; a port of ``repro/models/transformer.py``
for the block kinds the port runs).

JAX scans each segment's superblock over parameters stacked on a leading
``rep`` axis; here the model is an ``nn.Module`` with one submodule per
layer, in the order the scan visits them (for each repeat, each block of
the superblock).  Weights carried from JAX are unstacked by
``repro_torch.convert.lm_params_from_arrays``.

Ported: ``gqa`` attention (causal, full or over a sliding window as in
gemma3's local layers; with or without qk_norm) with a ``dense`` SwiGLU
FFN, and an LM head tied to the embedding (logits ``x @ embed.T``) or
untied (a ``head`` weight [d_model, vocab], logits ``x @ head``).  Any
other block kind raises NotImplementedError naming its ROADMAP item.  A
windowed layer's decode cache is a ring buffer of ``min(window,
seq_len)`` slots, as in JAX.  ``cfg.remat`` (JAX's activation
checkpointing) is not applied: the port's backward keeps the forward's
activations, and only attention recomputes (``attention._FlashAttention``).
Parameters are created with ``requires_grad=False`` (serving needs no
graph); ``steps.init_train_state`` turns gradients on.

Public surface:
  DecoderLM(cfg, device, seed)          — random weights from a seed
  forward(tokens, positions)            — prefill logits, aux
  hidden(tokens, positions)             — final-norm hidden states
  init_cache / decode_step              — KV caches, one token a step
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import attention as A
from .config import ModelConfig
from .layers import dense_init, rms_norm, swiglu, swiglu_init


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    attn: str = "gqa"        # gqa | mla | hymba | mlstm | slstm
    ffn: str = "dense"       # dense | moe | none
    window: int = 0          # sliding-window size (0 = full attention)
    cross_attn: bool = False


def build_segments(cfg: ModelConfig) -> List[Tuple[Tuple[BlockSpec, ...],
                                                   int]]:
    """Architecture pattern -> [(superblock, repeat)]."""
    if cfg.xlstm:
        pair = (BlockSpec(attn="mlstm", ffn="none"),
                BlockSpec(attn="slstm", ffn="none"))
        assert cfg.n_layers % 2 == 0
        return [(pair, cfg.n_layers // 2)]
    if cfg.ssm_heads:  # hymba: parallel attn+ssm heads every layer
        return [((BlockSpec(attn="hymba", window=cfg.local_window),),
                 cfg.n_layers)]
    attn = "mla" if cfg.mla else "gqa"
    ffn_main = "moe" if cfg.is_moe else "dense"
    segs: List[Tuple[Tuple[BlockSpec, ...], int]] = []
    if cfg.attn_pattern == "local_global":
        r = cfg.local_global_ratio
        sb = tuple([BlockSpec(attn=attn, ffn=ffn_main,
                              window=cfg.local_window)] * (r - 1)
                   + [BlockSpec(attn=attn, ffn=ffn_main)])
        rem = cfg.n_layers % r
        if rem:
            segs.append(((BlockSpec(attn=attn, ffn=ffn_main,
                                    window=cfg.local_window),), rem))
        segs.append((sb, cfg.n_layers // r))
        return segs
    if cfg.is_moe and cfg.first_k_dense:
        segs.append(((BlockSpec(attn=attn, ffn="dense"),),
                     cfg.first_k_dense))
        segs.append(((BlockSpec(attn=attn, ffn="moe"),),
                     cfg.n_layers - cfg.first_k_dense))
        return segs
    if cfg.cross_attn_every:
        k = cfg.cross_attn_every
        assert cfg.n_layers % k == 0
        sb = tuple([BlockSpec(attn=attn)] * (k - 1)
                   + [BlockSpec(attn=attn, cross_attn=True)])
        return [(sb, cfg.n_layers // k)]
    return [((BlockSpec(attn=attn, ffn=ffn_main),), cfg.n_layers)]


def layer_specs(cfg: ModelConfig) -> List[BlockSpec]:
    """The block of every layer, in the order JAX's scan applies them."""
    return [spec for sb, rep in build_segments(cfg) for _ in range(rep)
            for spec in sb]


_NOT_PORTED = {
    "mla": "MLA attention (deepseek-v3, kimi-k2)",
    "hymba": "hymba's parallel SSM heads",
    "mlstm": "xLSTM blocks",
    "slstm": "xLSTM blocks",
    "moe": "MoE FFN",
    "none": "FFN-less (xLSTM) blocks",
    "cross_attn": "vision cross-attention",
}


def check_spec(spec: BlockSpec) -> None:
    """Raise NotImplementedError for a block kind the port does not run."""
    for kind in (spec.attn if spec.attn != "gqa" else None,
                 spec.ffn if spec.ffn != "dense" else None,
                 "cross_attn" if spec.cross_attn else None):
        if kind is not None:
            raise NotImplementedError(
                f"{_NOT_PORTED.get(kind, kind)} is not ported to "
                f"repro_torch yet (ROADMAP A15); the port runs gqa + dense "
                f"blocks, full or windowed")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One gqa + dense block: ``ln1``, ``attn`` (wq, wk, wv, wo[, q_norm,
    k_norm]), ``ln2``, ``mlp`` (wi, wg, wo) — JAX ``block_init``'s pytree
    with the same names and shapes."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device) -> None:
        super().__init__()
        dt, d = cfg.torch_dtype, cfg.d_model
        self.ln1 = _frozen(torch.zeros(d, dtype=dt, device=device))
        self.attn = nn.ParameterDict({
            k: _frozen(v) for k, v in A.attn_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
                qk_norm=cfg.qk_norm, device=device).items()})
        self.ln2 = _frozen(torch.zeros(d, dtype=dt, device=device))
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in swiglu_init(
                gen, d, cfg.d_ff, dt, device=device).items()})


# --------------------------------------------------------------------------- #
# Block apply / cache / decode
# --------------------------------------------------------------------------- #
def block_apply(cfg: ModelConfig, spec: BlockSpec, bp: Block,
                x: torch.Tensor, positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) application.  Returns (x, aux)."""
    eps = cfg.norm_eps
    h = rms_norm(x, bp.ln1, eps)
    x = x + A.attention(bp.attn, h, positions, window=spec.window,
                        rope_theta=cfg.rope_theta, eps=eps,
                        chunk=cfg.attn_chunk)
    x = x + swiglu(bp.mlp, rms_norm(x, bp.ln2, eps))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     seq_len: int, device=None) -> Dict[str, torch.Tensor]:
    """Decode cache for one block: K and V for ``seq_len`` positions, or
    for a windowed block ``min(window, seq_len)`` slots used as a ring
    buffer (position p in slot p % slots)."""
    s = min(spec.window, seq_len) if spec.window else seq_len
    return A.init_cache(batch, s, cfg.n_kv_heads, cfg.hd, cfg.torch_dtype,
                        device=device)


def block_decode(cfg: ModelConfig, spec: BlockSpec, bp: Block,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    eps = cfg.norm_eps
    h = rms_norm(x, bp.ln1, eps)
    a, cache = A.decode_attention(bp.attn, h, cache, pos,
                                  window=spec.window,
                                  rope_theta=cfg.rope_theta, eps=eps)
    x = x + a
    x = x + swiglu(bp.mlp, rms_norm(x, bp.ln2, eps))
    return x, cache


# --------------------------------------------------------------------------- #
class DecoderLM(nn.Module):
    """The decoder LM with its weights.  ``seed`` seeds a
    ``torch.Generator`` on ``device`` from which every weight is drawn
    with the JAX initializers' scales; on the ``meta`` device nothing is
    drawn (shapes only)."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0
                 ) -> None:
        super().__init__()
        if cfg.encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder models (whisper) are not ported to "
                "repro_torch yet (ROADMAP A15)")
        self.cfg = cfg
        self.specs = layer_specs(cfg)
        for spec in self.specs:
            check_spec(spec)
        device = torch.device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        dt, d = cfg.torch_dtype, cfg.d_model
        self.embed = _frozen(dense_init(gen, cfg.vocab, d, dt, std=0.02,
                                        device=device))
        self.final_norm = _frozen(torch.zeros(d, dtype=dt, device=device))
        # JAX draws the untied head right after the embedding, with the
        # default d_model ** -0.5 scale.
        self.head = (None if cfg.tie_embeddings else
                     _frozen(dense_init(gen, d, cfg.vocab, dt,
                                        device=device)))
        self.layers = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in self.specs)

    # -- forward (prefill) ---------------------------------------------- #
    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-norm hidden states [B, T, D] of tokens [B, T]."""
        x = self.embed[tokens.long()]
        for spec, bp in zip(self.specs, self.layers):
            x, _ = block_apply(self.cfg, spec, bp, x, positions)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, T, vocab], aux) — aux is 0 for dense blocks."""
        x = self.hidden(tokens, positions)
        return self._logits(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.head is None:
            return torch.matmul(x, self.embed.t())      # tied head
        return torch.matmul(x, self.head)

    # -- decode --------------------------------------------------------- #
    def init_cache(self, batch: int, seq_len: int
                   ) -> List[Dict[str, torch.Tensor]]:
        """One zeroed cache dict per layer (JAX stacks them per segment)."""
        dev = self.embed.device
        return [block_cache_init(self.cfg, spec, batch, seq_len, device=dev)
                for spec in self.specs]

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """token [B,1] int; pos: int.  Returns (logits [B,1,vocab],
        cache), the caches written in place."""
        x = self.embed[token.long()]
        for spec, bp, lc in zip(self.specs, self.layers, cache):
            x, _ = block_decode(self.cfg, spec, bp, x, lc, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), cache
