"""repro_torch — the GraphAGILE overlay on PyTorch and CUDA (H100).

A second package beside the JAX reference ``repro``.  It carries its own
copy of the compiler (byte-identical binaries, so a ``.gagi`` bundle from
either package runs here), and executes the decoded 128-bit binary with
PyTorch tensors: on a CUDA device every GEMM tile and every SUM/MEAN
SpDMM tile runs a hand-written kernel (``repro_torch.kernels``); on the
CPU, where the tests run, the same wrappers use their plain versions.

    from repro_torch.engine import Engine

    engine = Engine()                       # device="cuda" by default
    prog = engine.compile("b2", graph)
    y = engine.run(prog, x)

This package imports ``torch`` and numpy only, never ``jax`` or ``repro``.
"""
