"""Quickstart on the port: compile and run a GCN with the GraphAGILE
Engine on a CUDA card.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` over ``repro_torch``: builds a
Cora-like synthetic graph, compiles a 2-layer GCN through the full
pipeline (order optimization -> fusion -> fiber-shard partitioning ->
kernel mapping/scheduling -> 128-bit binary), executes it by decoding that
binary with the hand-written CUDA kernels, holds the output against the
plain reference run in float64 on the same device, prints the cost
model's H100 prediction beside the measured time, and saves the
``.gagi`` bundle, which a fresh engine loads and replays bit for bit.
It runs on the card unless ``--device cpu`` is given; without a card it
fails with the Engine's message.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import gnn_builders as B  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import reference as R  # noqa: E402
from repro_torch.core.perfmodel import predict_loh  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.obs import build_report  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    engine = Engine(device=args.device)             # the overlay
    # Cora statistics, synthesized (no download).
    g = G.synthesize("CO").gcn_normalized()
    x = torch.as_tensor(G.random_features(g, seed=1), device=engine.device)
    print(f"graph: |V|={g.n_vertices} |E|={g.n_edges} f={g.feat_dim}")

    model = B.build_gcn(g, hidden=16, n_layers=2)   # the paper's b1
    print("IR:", model.dump())

    prog = engine.compile(model, g)
    cr = prog.source                                # pass reports
    print(f"\ncompiled in {prog.t_loc * 1e3:.1f} ms (the paper's T_LoC)")
    print(f"order opt: {len(cr.order_report.exchanges)} exchanges, "
          f"complexity -{cr.order_report.reduction:.1%}")
    print(f"fusion: {cr.fusion_report.layers_before} -> "
          f"{cr.fusion_report.layers_after} layers")
    print(f"binary: {len(prog.binary)} bytes "
          f"({prog.instruction_count()} instructions x 128 bit)")
    print(f"predicted T_LoH on an H100: "
          f"{predict_loh(cr.program) * 1e3:.3f} ms")

    y = engine.run(prog, x)                         # decodes the binary
    y_ref = R.run_reference(model, g, x, dtype=torch.float64)
    err = float((y.double() - y_ref).abs().max())
    print(f"\noverlay output {tuple(y.shape)} on {y.device}, max |err| vs "
          f"the float64 reference: {err:.2e}")
    assert err < 1e-4, err

    # Cost-model conformance: the analytic per-layer predictions joined
    # with the times the executor just measured for this run.
    rep = build_report(prog, engine.exec_stats, residency="device")
    print(f"T_LoH predicted {rep.predicted_s * 1e3:.3f} ms vs measured "
          f"{rep.measured_s * 1e3:.3f} ms "
          f"(model error {rep.model_error_overall:.2f} -> "
          f"{rep.model_error_overall_calibrated:.2f} after calibrating "
          f"effective machine constants)")

    # The overlay contract on disk: binary + weights/graph manifest.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gcn_cora.gagi")
        prog.save(path)
        fresh = Engine(device=args.device)          # a later session
        y2 = fresh.run(fresh.load(path), x)
        assert torch.equal(y, y2)
        print(f"saved {os.path.getsize(path)} B to "
              f"{os.path.basename(path)}; a fresh engine replayed it "
              f"bit-identically (T_LoC = 0)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
