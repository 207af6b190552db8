"""Per-user mini-batch serving on the port: sampled ego networks on the
pool, on a CUDA card.

  PYTHONPATH=src python examples/torch_minibatch_serve.py [--device cpu]

The twin of ``examples/minibatch_serve.py`` over ``repro_torch.sampling``:
every user asks for labels on a few target vertices of one deployed
power-law graph.  Each request is sampled (seeded k-hop fanout), padded
into a power-of-two geometry bucket and shipped as runtime graph data
over the bucket's compiled program, batched with the bucket's other users
into one binary pass on the overlay that compiled it, and un-padded back
to logits[targets, classes].  After warming, most users hit a compiled
program.  Every user's logits are checked for shape and finiteness.  It
serves on the card unless ``--device cpu`` is given; without a
card it fails with the Engine's message.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.sampling import SamplingService, TargetRequest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    # one deployed graph: RE-class power law, duplicate edges folded
    g = G.random_graph(466, 24000, seed=0, degree="powerlaw", alpha=1.1,
                       dedupe=True)
    g.feat_dim, g.n_classes = 16, 5
    g.name = "RE-class@466"
    X = G.random_features(g, seed=1)

    svc = SamplingService(
        g, X, n_overlays=2, geometry=PartitionConfig(n1=32, n2=8),
        n_pes=4, max_batch=4, max_wait_us=1e6, device=args.device)

    rng = np.random.default_rng(7)
    fanouts = [(6, 4), (4, 2), (6, 2)]

    def user(i: int) -> TargetRequest:
        targets = rng.choice(g.n_vertices,
                             size=int(rng.integers(1, 4)), replace=False)
        return TargetRequest(targets=[int(v) for v in targets],
                             model="b1", fanouts=fanouts[i % 3],
                             request_id=f"user{i}", seed=1000 + i)

    try:
        n_buckets = svc.warm([user(i) for i in range(16)])
        print(f"warmed {n_buckets} geometry buckets (programs compiled) on "
              f"{svc.pool.engines[0].device}\n")

        h0 = sum(e.stats.cache_hits for e in svc.pool.engines)
        n0 = sum(e.stats.requests for e in svc.pool.engines)
        t0 = time.perf_counter()
        resps = svc.serve([user(i) for i in range(16, 40)])
        wall = time.perf_counter() - t0
        h1 = sum(e.stats.cache_hits for e in svc.pool.engines)
        n1 = sum(e.stats.requests for e in svc.pool.engines)

        for r in resps:             # logits on the serving device
            assert tuple(r.logits.shape) == (len(r.targets), g.n_classes)
            assert bool(torch.isfinite(r.logits).all())
        for r in resps[:6]:
            pred = r.logits.argmax(dim=1)
            print(f"{r.request_id}: targets={r.targets.tolist()} -> "
                  f"classes {pred.tolist()}  [ego {r.n_vertices}V/"
                  f"{r.n_edges}E -> bucket {r.bucket}, "
                  f"batch={r.batch_size}, hit={r.cache_hit}]")
        print("...")

        snap = svc.stats_snapshot()
        rate = (h1 - h0) / (n1 - n0)
        print(f"\n{len(resps)} users in {wall * 1e3:.0f} ms "
              f"({len(resps) / wall:.0f} users/s); steady-state "
              f"program-cache hit rate {rate:.0%} "
              f"across {snap['distinct_buckets']} buckets")
        print("bucket census:", snap["buckets"])
    finally:
        svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
