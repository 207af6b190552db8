"""Serving loop: batched requests with prefill + decode (torch; a port
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --prompt-len 32 --gen 16 [--smoke] [--device cpu]

As in the JAX version, the prompt is prefilled by decode steps (exact with
respect to the cache), then ``--gen - 1`` more tokens are decoded greedily
for every request at once.  Weights are random from seed 1, prompts from
``--seed`` (numpy).  It runs on the CUDA device unless ``--device`` says
otherwise; both timings synchronize the device before reading the clock.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.steps import build_model, make_serve_step


def _prefill_with_cache(model, cfg, params, tokens, cache):
    """Prefill by running decode steps over the prompt (cache-exact; the
    flash kernel serves the cache-free prefill step instead)."""
    serve = make_serve_step(model, cfg)
    last = None
    for t in range(tokens.shape[1]):
        last, cache = serve(params, cache, tokens[:, t:t + 1], t)
    return last, cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=1)
    params = model
    dev = model.embed.device
    rng = np.random.default_rng(args.seed)

    b = args.requests
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (b, args.prompt_len)).astype(np.int32),
        device=dev)
    cap = args.prompt_len + args.gen
    cache = model.init_cache(b, cap)

    _sync(dev)
    t0 = time.perf_counter()
    last, cache = _prefill_with_cache(model, cfg, params, prompts, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve = make_serve_step(model, cfg)
    tok = last
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, cache = serve(params, cache, tok, args.prompt_len + i)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    print(f"arch={cfg.name} requests={b} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms   decode: "
          f"{t_decode * 1e3:.1f} ms "
          f"({t_decode / max(args.gen - 1, 1) * 1e3:.2f} ms/token)")
    print("sample generations (first 3 requests):")
    for r in range(min(3, b)):
        print("  ", gen[r].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
