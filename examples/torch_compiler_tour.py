"""A tour of the GraphAGILE compiler (paper §6) on the port, pass by pass.

  PYTHONPATH=src python examples/torch_compiler_tour.py [--device cpu]

The twin of ``examples/compiler_tour.py`` over ``repro_torch``.  The
passes run on the host; the last step compiles through an Engine on the
card (``--device cpu`` runs it on the CPU; without a card and without the
flag it fails with the Engine's message) and decodes the binary once to
check the program runs.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import gnn_builders as B  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.isa import Opcode, disassemble  # noqa: E402
from repro_torch.core.passes import fusion, order_opt  # noqa: E402
from repro_torch.core.passes.partition import (PartitionConfig,  # noqa: E402
                                               partition_graph)
from repro_torch.engine import Engine  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = PartitionConfig(n1=512, n2=32)
    engine = Engine(geometry=cfg, device=args.device)
    g = G.synthesize("CO").gcn_normalized()
    model = B.build("b7", g)   # SGC: the order optimizer's best case

    print("== IR (PyG-style decomposition, paper Table 2) ==")
    print(model.dump(), "\n")

    m1 = model.copy()
    rep = order_opt.run(m1)
    print("== Step 1: computation order optimization (Alg. 5) ==")
    print(f"exchanges: {rep.exchanges}")
    print(f"complexity: {rep.complexity_before:.3g} -> "
          f"{rep.complexity_after:.3g}  (-{rep.reduction:.1%})")
    print(m1.dump(), "\n")

    frep = fusion.run(m1)
    print("== Step 2: layer fusion ==")
    print(f"fused activations {frep.fused_activations}, "
          f"batchnorms {frep.fused_batchnorms}")
    print(m1.dump(), "\n")

    print("== Step 3: fiber-shard partitioning (Fig. 8) ==")
    pg = partition_graph(g, cfg)
    widths = [t.width for ts in pg.tiles.values() for t in ts]
    print(f"N1={cfg.n1} N2={cfg.n2}: {pg.n_blocks}x{pg.n_blocks} grid, "
          f"{sum(len(ts) for ts in pg.tiles.values())} non-empty ELL "
          f"tiles, widths {min(widths)}..{max(widths)}, "
          f"{pg.tile_bytes() / 1e6:.2f} MB of tiles\n")

    print("== Step 4 + codegen: 128-bit instruction stream ==")
    prog = engine.compile(model, g)
    instrs = disassemble(prog.binary)
    print(f"{len(instrs)} instructions, {len(prog.binary)} bytes; "
          f"first Layer Block:")
    shown = 0
    for ins in instrs:
        print("  ", ins)
        shown += 1
        if shown > 1 and ins.op == Opcode.CSI or shown > 14:
            break
    print(f"\nworst per-layer PE load imbalance: "
          f"{prog.source.schedule_report.worst_imbalance:.2f}x "
          f"(LPT over edge-count costs)")

    y = engine.run(prog, G.random_features(g, seed=1))
    assert tuple(y.shape) == (g.n_vertices, g.n_classes)
    assert bool(torch.isfinite(y).all())
    print(f"decoded and ran on {y.device}: output {tuple(y.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
