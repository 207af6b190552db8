"""Distributed-training pieces of the port (a port of
``repro/distributed``): int8 gradient compression with error feedback
(``compression``), the sharding rules and their placement over a
``DeviceMesh`` (``sharding``), ZeRO-1 optimizer-state sharding (``zero``)
and the GPipe pipeline (``pipeline``)."""
