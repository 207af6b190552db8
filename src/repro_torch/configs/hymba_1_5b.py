"""hymba-1.5b [hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
        ssm_state=16, ssm_heads=25, local_window=2048,
        rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
        d_ff=128, vocab=256, ssm_heads=5, local_window=8, attn_chunk=0,
        remat="none")
