"""Model configuration for the LM side of the port.

A copy of ``repro/models/config.py``'s ``ModelConfig`` (the same fields
and defaults, ``hd``, ``is_moe``, ``n_params``,
``n_active_params``), so that a config built here equals the JAX
package's field for field, and of the dry-run's cells (``ShapeCell``,
``SHAPES``).  One
dataclass covers every family (dense / moe / hybrid / vlm / audio / ssm);
``torch_dtype`` takes the place of ``jdtype``.  Configs are constructed by
``repro_torch.configs.<arch>`` modules.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention
    attn_pattern: str = "full"   # full | local_global (gemma3 5:1)
    local_window: int = 1024
    local_global_ratio: int = 6  # one global layer per this many layers
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_chunk: int = 1024       # query-chunked online-softmax threshold

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_moe: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    mtp: bool = False            # multi-token-prediction extra head

    # hybrid SSM (hymba) / ssm (xlstm)
    ssm_state: int = 0
    ssm_heads: int = 0           # hymba: parallel SSM heads per layer
    ssm_expand: float = 1.0
    ssm_impl: str = "ssd"        # ssd (mamba2 dual) | assoc (chunked scan)
    xlstm: bool = False          # alternate mLSTM/sLSTM blocks

    # vlm (llama-3.2-vision): cross-attn every k-th layer
    cross_attn_every: int = 0
    n_vision_tokens: int = 1601
    vision_dim: int = 1280

    # audio (whisper): encoder-decoder
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    decoder_target_len: int = 448

    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    remat: str = "full"          # full | dots | none

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.xlstm:
            # mLSTM: up(2d^2) + qkv at du=2d (12d^2) + down(2d^2) ~ 16d^2
            # sLSTM: z/o/r (3d^2) + up/down at pf 4/3 (~2.7d^2)  ~  6d^2
            per_pair = 16 * d * d + 6 * d * d
            return emb + (L // 2) * per_pair
        if self.mla:
            attn = (d * self.q_lora
                    + self.q_lora * self.n_heads * (self.qk_nope
                                                    + self.qk_rope)
                    + d * (self.kv_lora + self.qk_rope)
                    + self.kv_lora * self.n_heads * (self.qk_nope
                                                     + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        dense_mlp = 3 * d * f
        if self.is_moe:
            moe_mlp = 3 * d * self.d_ff_moe * (self.n_experts
                                               + self.n_shared_experts)
            router = d * self.n_experts
            n_dense = self.first_k_dense
            n_moe = L - n_dense
            ff_dense = f if f else self.d_ff_moe * (
                self.n_experts // 16)  # fallback
            body = (n_dense * (attn + 3 * d * ff_dense)
                    + n_moe * (attn + moe_mlp + router))
        else:
            body = L * (attn + dense_mlp)
        if self.ssm_heads:
            body += L * (3 * d * d)  # ssm in/out/dt projections (approx)
        if self.cross_attn_every:
            n_x = L // self.cross_attn_every
            body += n_x * (2 * self.d_model * self.n_kv_heads * hd
                           + d * self.n_heads * hd + self.n_heads * hd * d)
        if self.encoder_decoder:
            enc = self.n_encoder_layers * (attn + dense_mlp)
            body += enc + L * (attn)  # decoder cross-attn approx
        return emb + body

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        moe_all = 3 * d * self.d_ff_moe * self.n_experts
        moe_active = 3 * d * self.d_ff_moe * self.top_k
        n_moe = self.n_layers - self.first_k_dense
        return full - n_moe * (moe_all - moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
