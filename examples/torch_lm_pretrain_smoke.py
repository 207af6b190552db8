"""LM-side smoke on the port: pretrain a reduced assigned-architecture
config with the full substrate (synthetic pipeline, AdamW, checkpoints,
resume) on a CUDA card.

  PYTHONPATH=src python examples/torch_lm_pretrain_smoke.py [arch] \\
      [--device cpu] [--quick]

The twin of ``examples/lm_pretrain_smoke.py``: it calls
``repro_torch.launch.train.main`` with the same arguments (60 steps of
batch 8 x 128 tokens, checkpoints every 30 steps into a temporary
directory, ``--resume auto``).  It trains on the card unless ``--device
cpu`` is given; without a card it fails with the model's device message.
``--quick`` (for the tests on the CPU) takes 4 steps of 2 x 32 tokens
with a checkpoint every 2.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="xlstm-125m")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="4 steps of 2 x 32 tokens (tests on the CPU)")
    args = ap.parse_args(argv)
    steps, batch, seq, every = ((4, 2, 32, 2) if args.quick
                                else (60, 8, 128, 30))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt:
        return train_main([
            "--arch", args.arch, "--smoke", "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--lr", "1e-3",
            "--log-every", str(min(10, every)), "--ckpt-dir", ckpt,
            "--ckpt-every", str(every), "--resume", "auto",
            "--device", args.device,
        ])


if __name__ == "__main__":
    sys.exit(main())
