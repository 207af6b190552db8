"""kimi-k2-1t-a32b [moe] 61L d_model=7168 64H (GQA kv=8, per the assigned
pool line) d_ff(moe)=2048 vocab=163840, MoE 384 experts top-8 + 1 shared,
first layer dense [arXiv:2501.kimi2; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, head_dim=112, d_ff=18432, vocab=163840,
        n_experts=384, top_k=8, d_ff_moe=2048, n_shared_experts=1,
        first_k_dense=1, rope_theta=50000.0)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, n_experts=8, top_k=2,
        d_ff_moe=32, first_k_dense=1, attn_chunk=0, remat="none")
