"""Atomic checkpoints (a port of ``repro/checkpoint``)."""
from .ckpt import latest_step, restore, save  # noqa: F401
