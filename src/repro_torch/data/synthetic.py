"""Deterministic synthetic data pipeline (a numpy-only copy of
``repro/data/synthetic.py``, typed on the port's ``ModelConfig``).

Generates reproducible token streams (Zipf-distributed ids with local
correlations so the loss actually decreases) sharded by host.  The
real-data interface is the same iterator contract: ``{"tokens", "labels"}``
int32 [B, T] per step.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


def synthetic_batches(cfg: ModelConfig, batch: int, seq_len: int,
                      seed: int = 0, host_id: int = 0, n_hosts: int = 1
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens, labels[, vision/frames]} batches."""
    rng = np.random.default_rng(seed * 1000003 + host_id)
    v = cfg.vocab
    ranks = np.arange(1, min(v, 4096) + 1, dtype=np.float64)
    p = ranks ** -1.0
    p /= p.sum()
    while True:
        base = rng.choice(len(p), size=(batch, seq_len + 1), p=p)
        # local correlation: next token often echoes (t - 2)
        echo = rng.random((batch, seq_len + 1)) < 0.3
        base[:, 2:] = np.where(echo[:, 2:], base[:, :-2], base[:, 2:])
        toks = base.astype(np.int32) % v
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.cross_attn_every:
            out["vision"] = rng.normal(
                0, 0.1, (batch, cfg.n_vision_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.encoder_decoder:
            tl = cfg.decoder_target_len
            out = {
                "frames": rng.normal(
                    0, 0.1, (batch, seq_len, cfg.d_model)
                ).astype(np.float32),
                "targets": toks[:, :tl],
                "target_labels": toks[:, 1:tl + 1],
            }
        yield out
