"""End-to-end driver on the port: a GNN inference service on the overlay
runtime, on a CUDA card.

  PYTHONPATH=src python examples/torch_serve_gnn.py [--device cpu] [--quick]

The twin of ``examples/serve_gnn.py`` over ``repro_torch``: a pool of two
overlays serves a stream of (model, graph) requests -- GCN, GAT, SAGE,
SGC on different graphs -- through ``repro_torch.runtime``, with dynamic
batching (requests that share a deployed pair run as one binary pass),
cache-affinity routing (a repeated pair goes to the overlay that compiled
it: T_LoC = 0 on a hit) and no kernel built per model or graph (the hand
kernels take any tile shape).  Every response is held against the plain
reference run in float64 on the same device.  It serves on the card
unless ``--device cpu`` is given; without a card it fails with the
Engine's message.  ``--quick`` (for the tests on the CPU) sends each pair
twice instead of six times.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import ack  # noqa: E402
from repro_torch.core import gnn_builders as B  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import reference as R  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import InferenceRequest  # noqa: E402
from repro_torch.runtime import OverlayPool, ServeLoop  # noqa: E402

# A traffic mix over 4 deployed (model, graph) pairs, each queried
# REPEATS times with fresh features.  Topologies are the paper's datasets
# (CI and PU scaled down as in the JAX twin), feature widths capped at 128.
PAIRS = [("b1", "CO"), ("b6", "CI"), ("b3", "CO"), ("b7", "PU")]
SCALE = {"CI": 0.5, "PU": 0.25}
FEAT_CAP = 128
REPEATS = 6
MAX_BATCH = 3


def build_requests(repeats: int):
    graphs = {}
    reqs = []
    i = 0
    for _ in range(repeats):
        for mname, gname in PAIRS:
            if gname not in graphs:   # one deployed graph per dataset
                g = G.synthesize(gname, scale=SCALE.get(gname, 1.0),
                                 seed=0).gcn_normalized()
                g.feat_dim = min(g.feat_dim, FEAT_CAP)
                graphs[gname] = g
            g = graphs[gname]
            x = G.random_features(g, seed=i)        # fresh features
            reqs.append(InferenceRequest(model=mname, graph=g, features=x,
                                         request_id=f"req{i}", seed=0))
            i += 1
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="each pair twice (tests on the CPU)")
    args = ap.parse_args(argv)

    # Fixed tile geometry = the overlay contract, stamped out twice.
    pool = OverlayPool(n_overlays=2, geometry=PartitionConfig(n1=256, n2=32),
                       device=args.device)
    loop = ServeLoop(pool, max_batch=MAX_BATCH, max_wait_us=50_000,
                     max_queue=64)
    requests = build_requests(2 if args.quick else REPEATS)

    print(f"serving {len(requests)} requests (mixed models x mixed "
          f"graphs) on {len(pool)} overlays ({pool.engines[0].device}), "
          f"dynamic batching max_batch={MAX_BATCH}...\n")
    t0 = time.perf_counter()
    try:
        responses = loop.serve(requests)
    finally:
        loop.shutdown()
    wall = time.perf_counter() - t0

    worst = 0.0
    for req, r in zip(requests, responses):
        m = B.build(req.model, req.graph, req.seed)
        x = torch.as_tensor(req.features, device=r.output.device)
        y64 = R.run_reference(m, req.graph, x, dtype=torch.float64)
        err = float((r.output.double() - y64).abs().max())
        worst = max(worst, err)
        tag = "HIT " if r.cache_hit else "miss"
        print(f"{r.request_id:5s}: {r.model_name:10s} on {r.graph_name:2s} "
              f"(|V|={req.graph.n_vertices:5d}) ov={r.overlay} "
              f"batch={r.batch_size} cache={tag} "
              f"T_LoC={r.t_loc * 1e3:6.1f}ms  "
              f"T_LoH={r.t_loh * 1e3:7.1f}ms  err={err:.1e}")
    assert worst < 1e-4, worst

    snap = pool.metrics.snapshot(max_batch=MAX_BATCH)
    g = snap["global"]
    print(f"\ntotals: {g['requests']} requests in {wall * 1e3:.0f} ms "
          f"wall: {g['throughput_rps']:.1f} req/s, "
          f"p50={g['p50_latency_ms']:.0f} ms, "
          f"p99={g['p99_latency_ms']:.0f} ms")
    print(f"batching: {g['batches']} binary passes for {g['requests']} "
          f"requests (mean batch {g['mean_batch_size']:.1f}, occupancy "
          f"{g['batch_occupancy']:.0%}); program-cache hit rate "
          f"{g['cache_hit_rate']:.0%}")
    print("per-overlay:", json.dumps(pool.stats_snapshot()["overlays"],
                                     indent=1))
    print(f"distinct tile-kernel keys across ALL requests: "
          f"{len(ack.counter_snapshot())}; worst max|err| vs float64 "
          f"{worst:.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
