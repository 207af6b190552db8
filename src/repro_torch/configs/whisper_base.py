"""whisper-base [audio] 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec, conv frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
        encoder_decoder=True, n_encoder_layers=6, decoder_target_len=448,
        tie_embeddings=True, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, decoder_target_len=16,
        attn_chunk=0, remat="none")
