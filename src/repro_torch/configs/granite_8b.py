"""granite-8b [dense] 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152,
        rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, attn_chunk=0, remat="none")
