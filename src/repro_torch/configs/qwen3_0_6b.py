"""qwen3-0.6b [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1000000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, attn_chunk=0, remat="none")
