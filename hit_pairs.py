#!/usr/bin/env python3
"""Cache-hit latency of two checkouts of the port, alternated on one GPU.

    python3 hit_pairs.py TREE_A TREE_B [--rounds 3] [--hits 8]
                         [--residency device|host] [--json-out PATH]
    python3 hit_pairs.py TREE --streams [--rounds 2] [--hits 12]

Each round runs TREE_A, TREE_B, TREE_B, TREE_A, each in a process of its
own (``python3 hit_pairs.py --one TREE``): the process builds that tree's
kernels, compiles b2 (GCN, hidden 128) on full-scale Flickr (FL, 89,250
vertices) in ``Engine(device="cuda")``, and serves one miss and ``--hits``
cache hits through ``Engine.submit``, with features from seeds 10, 11, ...
It records each request's T_LoH and the per-layer CUDA-event times of its
pass.  The summary gives, per tree, the median and range of the hits'
T_LoH and of their SpDMM layers' times.  The last line of the output is
the summary as JSON.

With ``--residency host`` the program is compiled with
``residency="host"`` and each request is one ``Engine.run`` of the
host-streaming path, timed by the host clock around the run and the
engine stream's synchronize (per-layer times are then synchronized wall
times); its miss also pins the graph's tiles in host memory.

With ``--streams`` one tree runs ``--rounds`` processes whose hits
alternate between the Engine's own CUDA stream and the caller's default
stream (the Engine's stream set to None for that hit), so the cost of
issuing on a side stream is read within one process.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def one(tree: str, hits: int, streams: bool = False,
        residency: str = "device") -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("hit_pairs: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import build

    import time
    build.build_all()
    fl = G.synthesize("FL").gcn_normalized()
    eng = Engine()
    own = getattr(eng, "stream", None)     # None: the default stream
    out = []
    for i in range(hits + 1):
        if streams:
            eng.stream = None if i % 2 == 0 else own
        x = G.random_features(fl, seed=10 + i)
        if residency == "host":
            prog = eng.compile("b2", fl, residency="host")
            t0 = time.perf_counter()
            eng.run(prog, x)
            eng._sync()
            t_loh, hit = time.perf_counter() - t0, i > 0
        else:
            resp = eng.submit(InferenceRequest(
                model="b2", graph=fl, features=x, request_id=f"b2@FL#{i}"))
            t_loh, hit = resp.t_loh, resp.cache_hit
        out.append({"t_loh_ms": t_loh * 1e3, "hit": hit,
                    "stream": ("default" if getattr(eng, "stream", None)
                               is None else "own"),
                    "layers": [(r["kernel"], r.get("tile_ops"),
                                r["wall_s"] * 1e3)
                               for r in eng.exec_stats.per_layer]})
    return {"tree": tree, "requests": out}


def _summary(runs) -> dict:
    by_tree = {}
    for run in runs:
        for r in run["requests"]:
            if not r["hit"]:
                continue
            s = by_tree.setdefault(f"{run['tree']} ({r['stream']} stream)",
                                   {"hit_t_loh_ms": [], "spdmm_layer_ms": []})
            s["hit_t_loh_ms"].append(r["t_loh_ms"])
            s["spdmm_layer_ms"] += [ms for k, _, ms in r["layers"]
                                    if k == "spdmm"]
    for s in by_tree.values():
        for key in ("hit_t_loh_ms", "spdmm_layer_ms"):
            v = s[key]
            s[key] = {"n": len(v), "median": statistics.median(v),
                      "min": min(v), "max": max(v)}
    return by_tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", default=None, help="run one tree (child mode)")
    ap.add_argument("--streams", action="store_true",
                    help="alternate the Engine's stream and the default "
                         "stream within each process of one tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--hits", type=int, default=8)
    ap.add_argument("--residency", choices=("device", "host"),
                    default="device")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.hits, args.streams,
                             args.residency)), flush=True)
        return 0
    if len(args.trees) != (1 if args.streams else 2):
        ap.error("give one tree with --streams, else two")
    order = args.trees if args.streams else args.trees + args.trees[::-1]
    runs = []
    for rnd in range(args.rounds):
        for tree in order:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--hits", str(args.hits), "--residency", args.residency]
                + (["--streams"] if args.streams else []),
                capture_output=True, text=True)
            if p.returncode != 0:
                sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
                raise SystemExit(f"hit_pairs: {tree} failed "
                                 f"(rc {p.returncode})")
            run = json.loads(p.stdout.strip().splitlines()[-1])
            runs.append(run)
            print(f"round {rnd} {tree}: hit T_LoH ms " + ", ".join(
                f"{r['t_loh_ms']:.2f}" + ("d" if r["stream"] == "default"
                                          else "")
                for r in run["requests"] if r["hit"]), flush=True)
    summary = _summary(runs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "runs": runs, "summary": summary}, fh,
                      indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
