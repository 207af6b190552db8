"""gemma3-12b [dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global, 128k ctx [hf:google/gemma-3; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, d_ff=15360, vocab=262144,
        attn_pattern="local_global", local_window=1024,
        local_global_ratio=6, qk_norm=True, rope_theta=1000000.0,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, local_window=8, attn_chunk=0, remat="none")
