"""Run one cell of the benchmark once and print its result line.

    python3 gnnbench/run.py --workload gcn-b2-flickr.resident --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell
asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
compared for ``correct`` are also the last lines of standard error.
Without a CUDA card, or with fewer cards than the cell asks for, it
exits non-zero and prints no result.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(msg: str) -> None:
    print(f"[gnnbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache the run may write stays inside the checkout, at fixed
    # paths; the port builds its kernels into its own src/.../_build.
    cache = os.path.join(ROOT, ".gnnbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch
    from gnnbench.harness import runner, spec

    # One intra-op thread: the runtime's worker and the clients' sending
    # thread, which pace a host-bound cell, share the host's few cores
    # with no pool of PyTorch's own threads beside them.
    torch.set_num_threads(1)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        _log("no CUDA device: nothing measured")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"the cell needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present: nothing measured")
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), T_PROC, log=_log)
    banned = runner.banned_modules()
    if banned:
        _log(f"modules of JAX or the JAX package loaded: {banned}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
