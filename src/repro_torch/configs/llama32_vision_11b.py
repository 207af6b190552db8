"""llama-3.2-vision-11b [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision frontend
STUB (input_specs provides projected patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40,
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
        cross_attn_every=5, n_vision_tokens=1601, vision_dim=1280,
        rope_theta=500000.0)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, cross_attn_every=2, n_vision_tokens=16,
        attn_chunk=0, remat="none")
