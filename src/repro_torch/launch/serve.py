"""Serving loop: batched requests with prefill + decode (torch; a port
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --prompt-len 32 --gen 16 [--smoke] [--device cpu]

As in the JAX version, the prompt is prefilled by decode steps (exact with
respect to the cache), then ``--gen - 1`` more tokens are decoded greedily
for every request at once.  Weights are random from seed 1, prompts from
``--seed`` (numpy).  It runs on the CUDA device unless ``--device`` says
otherwise; both timings synchronize the device before reading the clock.
A cross-attention decoder (``--arch llama-3.2-vision-11b``) and an
encoder-decoder (``--arch whisper-base``) decode over zeroed cross caches
of ``cfg.n_vision_tokens`` slots, as JAX's launch.serve does (it passes no
image or audio).

Where JAX jits the serve step once per (batch, capacity), the step here
is captured once as a CUDA graph (:class:`Step`) and replayed for every
prompt position and every generated token.  On the CPU the step is
called eagerly; ``generate(capture=False)`` does so on the card too, the
route the captured one is held against, token for token.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ops import CudaGraph
from repro_torch.models.steps import build_model, make_serve_step


class Step:
    """The greedy serve step at one (batch, capacity): ``step(token,
    pos)`` takes token [B, 1] on the model's device and an int position
    and returns the next [B, 1] int32, the caches written in place.

    With ``capture`` on a CUDA device the step reads its token and
    position from static device buffers (the position as a 0-d tensor, so
    the ring slot is computed on the device): the first call runs it
    eagerly, the second captures it (:class:`CudaGraph`), and every call
    from then on fills the buffers and replays the graph.  A call returns
    a copy of the step's argmax, which the next replay would overwrite.
    Without ``capture`` (or on the CPU) the step is called eagerly with
    an int position; both give the same tokens."""

    def __init__(self, model, cfg, params, cache, batch: int,
                 capture: bool = True) -> None:
        self.serve = make_serve_step(model, cfg)
        self.params, self.cache = params, cache
        self.device = model.embed.device
        self.capture = capture and CudaGraph.supports(self.device)
        self.graph = None
        self.warm = False
        if self.capture:
            self.tok = torch.zeros((batch, 1), dtype=torch.int32,
                                   device=self.device)
            self.pos = torch.zeros((), dtype=torch.int64, device=self.device)

    def __call__(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        if not self.capture:
            nxt, self.cache = self.serve(self.params, self.cache, token, pos)
            return nxt
        self.tok.copy_(token)
        self.pos.fill_(pos)
        if not self.warm:
            self.warm = True
            return self.serve(self.params, self.cache, self.tok, self.pos)[0]
        if self.graph is None:
            self.graph = CudaGraph(self.device)
            self.out = self.graph.capture(lambda: self.serve(
                self.params, self.cache, self.tok, self.pos)[0])
        self.graph.replay()
        return self.out.clone()


def _prefill_with_cache(step: Step, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill by running decode steps over the prompt (cache-exact; the
    flash kernel serves the cache-free prefill step instead); returns the
    last step's token."""
    last = None
    for t in range(tokens.shape[1]):
        last = step(tokens[:, t:t + 1], t)
    return last


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, prompts: torch.Tensor, gen: int,
             capture: bool = True):
    """Greedy generation for every prompt of ``prompts`` [B, P] at once:
    prefill by decode steps, then ``gen - 1`` more tokens, through one
    :class:`Step` at capacity P + gen.  Returns (tokens [B, gen] int32 on
    the device, prefill s, decode s), each time read after a device
    synchronize."""
    b, plen = prompts.shape
    dev = model.embed.device
    step = Step(model, cfg, model, model.init_cache(b, plen + gen), b,
                capture=capture)
    _sync(dev)
    t0 = time.perf_counter()
    tok = _prefill_with_cache(step, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok = step(tok, plen + i)
        out.append(tok)
    _sync(dev)
    return torch.cat(out, dim=1), t_prefill, time.perf_counter() - t0


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
    dev = model.embed.device
    rng = np.random.default_rng(args.seed)

    b = args.requests
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (b, args.prompt_len)).astype(np.int32),
        device=dev)
    toks, t_prefill, t_decode = generate(model, cfg, prompts, args.gen)
    gen = toks.cpu().numpy()
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
