"""gemma3-27b [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global (62 = 2 local + 10 superblocks of 6)."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
        attn_pattern="local_global", local_window=1024,
        local_global_ratio=6, qk_norm=True, rope_theta=1000000.0,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, local_window=8, attn_chunk=0, remat="none")
