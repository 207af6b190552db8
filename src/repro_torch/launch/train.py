"""Training launcher: data pipeline -> train loop -> checkpoints (torch; a
port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir CKPT --resume auto

It runs on the CUDA device unless ``--device`` says otherwise.  ``--smoke``
trains the reduced config in fp32, as in JAX; weights are random from seed
0, batches from ``synthetic_batches(seed=--data-seed)``.  Fault tolerance:
checkpoints are atomic (``repro_torch.checkpoint``); ``--resume auto``
restarts from the last complete step and fast-forwards the data stream to
it; ``--crash-at N`` simulates a failure after step N (exit code 42).
``--compress-grads`` sends the gradients through the int8 error-feedback
path (``repro_torch.distributed.compression``) before the optimizer.  Its
loss is the plain step's (``steps.value_and_grad``): a cross-attention
decoder reads its ``vision`` batch and an encoder-decoder its frames and
targets.  JAX's path reads ``batch["tokens"]`` alone, so there the cross
blocks attend to their own input and an encoder-decoder raises KeyError;
the port departs from it on purpose.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import synthetic_batches
from repro_torch.distributed.compression import (ef_transform,
                                                 init_error_feedback)
from repro_torch.models.steps import (build_model, init_train_state,
                                      make_train_step, value_and_grad)
from repro_torch.optim import adamw_update, cosine_schedule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a failure after this step (testing)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32") if args.smoke else cfg
    model = build_model(cfg, device=args.device, seed=0)
    dev = model.embed.device
    train_step = make_train_step(model, cfg, base_lr=args.lr)

    def train_step_compressed(params, opt_state, ef, batch):
        # error-feedback int8 gradient path (see compression.py); its loss
        # is the total (cross-entropy plus the router's aux term), as JAX's
        loss, _, _, grads = value_and_grad(params, cfg, batch)
        grads, ef = ef_transform(grads, ef)
        lr = cosine_schedule(opt_state.step, args.lr)
        _, opt_state = adamw_update(dict(params.named_parameters()), grads,
                                    opt_state, lr)
        return params, opt_state, ef, {"loss": loss, "lr": lr,
                                       "aux": torch.zeros(())}

    params, opt_state = init_train_state(model)
    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), start, meta = restore(
                args.ckpt_dir, (params, opt_state))
            print(f"[resume] restored step {start} "
                  f"(loss was {meta.get('loss')})", flush=True)

    it = synthetic_batches(cfg, args.batch, args.seq, seed=args.data_seed)
    ef = (init_error_feedback(dict(params.named_parameters()))
          if args.compress_grads else None)

    # fast-forward the data stream for determinism across restarts
    for _ in range(start):
        next(it)

    t0 = time.time()
    loss_val = float("nan")
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(it).items()}
        if args.compress_grads:
            params, opt_state, ef, metrics = train_step_compressed(
                params, opt_state, ef, batch)
        else:
            params, opt_state, metrics = train_step(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss_val = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step + 1:5d} loss {loss_val:8.4f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, (params, opt_state),
                 meta={"loss": float(metrics["loss"]),
                       "arch": args.arch})
        if args.crash_at == step + 1:
            print(f"[crash] simulated failure at step {step + 1}",
                  flush=True)
            os._exit(42)
    print(f"done: {args.steps} steps, final loss {loss_val:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
