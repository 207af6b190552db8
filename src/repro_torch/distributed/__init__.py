"""Distributed-training pieces the port runs (a port of part of
``repro/distributed``): int8 gradient compression with error feedback.
Sharding, pipelining and ZeRO are not ported yet (ROADMAP A15.5)."""
