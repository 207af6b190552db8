"""Kernel launches made by CUDA-graph replays over every kernel launch in
the window, in % (``ops.REPLAYED`` / ``ops.launch_totals``; SpDMM counted
in launches of its kernel, not tile steps)."""


def read(ctx):
    total = sum(ctx.launches.values())
    return 100.0 * sum(ctx.replayed.values()) / total if total else None
