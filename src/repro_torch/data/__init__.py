"""Synthetic token batches (a port of ``repro/data``)."""
from .synthetic import synthetic_batches  # noqa: F401
