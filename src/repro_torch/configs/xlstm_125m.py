"""xlstm-125m [ssm] 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (block-internal up/down projections)
[arXiv:2405.04517; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, xlstm=True,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab=256, remat="none")
