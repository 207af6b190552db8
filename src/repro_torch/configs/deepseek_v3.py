"""deepseek-v3-671b [moe] 61L d_model=7168, MLA (128 heads), MoE 256
routed top-8 + 1 shared, first 3 dense, d_ff(moe)=2048, vocab=129280,
MTP head [arXiv:2412.19437; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
        n_experts=256, top_k=8, d_ff_moe=2048, n_shared_experts=1,
        first_k_dense=3, mla=True, q_lora=1536, kv_lora=512, qk_nope=128,
        qk_rope=64, v_head_dim=128, rope_theta=10000.0, mtp=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, n_experts=8, top_k=2, d_ff_moe=32,
        first_k_dense=2, q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8,
        v_head_dim=16, attn_chunk=0, remat="none")
