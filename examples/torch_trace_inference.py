"""Traced end-to-end inference on the port: compile + host-streaming
execution + serving traffic, exported as Perfetto trace-event JSON.

  PYTHONPATH=src python examples/torch_trace_inference.py \\
      [--out trace.json] [--device cpu] [--quick]

The twin of ``examples/trace_inference.py`` over ``repro_torch.obs``.
Open the written file at https://ui.perfetto.dev: the ``compile`` track
shows the pass pipeline, ``h2d`` the shard staging, ``exec:host`` the
per-shard compute, and ``queue`` / ``overlay*`` the request lifecycle
through the serving loop.  The host-streamed output is held bit for bit
against the device-resident run.  It runs on the card unless ``--device
cpu`` is given; without a card it fails with the Engine's message.
``--quick`` (for the tests on the CPU, where the full size takes about
30 s, most of it encoding and decoding the ~190,000 instructions that
CI's 3,703 feature columns take at this tile shape) caps the features at
64 columns.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import Engine, InferenceRequest  # noqa: E402
from repro_torch.obs import enable_tracing  # noqa: E402
from repro_torch.runtime import OverlayPool, ServeLoop  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="features capped at 64 columns (tests on the CPU)")
    args = ap.parse_args(argv)

    engine = Engine(geometry=PartitionConfig(n1=32, n2=8),
                    device=args.device)
    tracer = enable_tracing()

    g = G.synthesize("CI", scale=0.1, seed=0).gcn_normalized()
    if args.quick:
        g.feat_dim = min(g.feat_dim, 64)
    x = G.random_features(g, seed=1)

    # Compile (per-pass spans on the `compile` track) and run the
    # partition-centric host-streaming path (stage / compute spans on
    # the `h2d` / `exec:host` tracks).
    prog = engine.compile("b3", g)
    y = engine.run(prog, x, residency="host")
    print(f"host-streaming run: output {tuple(y.shape)}, "
          f"{engine.exec_stats.shards_streamed} shards streamed, "
          f"{engine.exec_stats.h2d_bytes} h2d bytes")
    assert torch.equal(y, engine.run(prog, x))      # = device-resident

    # A little serving traffic: admission -> queue wait -> batch ->
    # execute spans through the ServeLoop (cache-hit instants on the
    # second wave).
    pool = OverlayPool(n_overlays=2, geometry=PartitionConfig(n1=32, n2=8),
                       device=args.device)
    loop = ServeLoop(pool, max_batch=4)
    reqs = [InferenceRequest(model="b1", graph=g, features=x,
                             request_id=f"req{i}") for i in range(8)]
    try:
        resps = loop.serve(reqs)
    finally:
        loop.shutdown()
    hits = sum(r.cache_hit for r in resps)
    print(f"served {len(resps)} requests ({hits} cache hits)")
    assert hits > 0

    path = tracer.save(args.out)
    with open(path) as fh:
        doc = json.load(fh)
    print(f"\nwrote {path} ({len(doc['traceEvents'])} events); open it "
          f"at https://ui.perfetto.dev")

    print("\nspan rollup (count / total ms):")
    summ = tracer.summary()
    for name, s in sorted(summ["spans"].items(),
                          key=lambda kv: -kv[1]["total_ms"])[:12]:
        print(f"  {name:<16} x{s['count']:<5} {s['total_ms']:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
