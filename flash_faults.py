#!/usr/bin/env python3
"""Planted faults in the flash kernel, read by the checks that hold it.

    python3 flash_faults.py [--json-out PATH]

Builds the flash kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``)
and one copy of it per entry of ``FAULTS``, each with one planted fault,
one ``nvcc`` per source, all at once.  The copies are written and built
under the git-ignored ``src/repro_torch/kernels/_build/faults/``; the
source in the checkout is not touched.  For the real kernel and each
fault, called through the unchanged ``ops.flash_attention`` wrapper, it
reads:

* the path-shape output (BH=64, T=2048, d=128, bf16, causal) against
  ``flash_attention_plain``: the JAX bf16 case's elementwise rtol / atol
  3e-2, and ``chip_smoke.check_rows``'s relative L2 over the whole
  output and over each query row;
* the same two readings at gemma3-12b's prefill shape (BH=64 over 32 KV
  heads, T=2048, d=240, bf16, causal), which the warp-specialised body
  past d = 128 runs;
* the last-position logits of a qwen3-0.6b prefill (bf16, B=4, T=2048,
  weights from seed 0, as in ``chip_smoke.py``) against the same model
  with plain attention, beside ``chip_smoke.py``'s 2e-2 limit.

It exits non-zero if the real kernel fails a check or a fault passes
``check_rows`` at both shapes.  The last line of the output is the readings as JSON.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (what the fault does, text of flash_attention.cu, its replacement)
FAULTS = {
    "causal_skip_early": (
        "bf16 body: the causal skip one query tile early: the diagonal KV "
        "tiles are skipped",
        "const int end = causal ? min(tk, q0 + BQ_) : tk;",
        "const int end = causal ? min(tk, q0) : tk;"),
    "drop_mid_tile_late": (
        "bf16 body: query tiles from row 1024 on skip their middle KV tile",
        "    mbar_wait(full + 8 * st, (step / WG_STAGES) & 1);\n",
        "    mbar_wait(full + 8 * st, (step / WG_STAGES) & 1);\n"
        "    if (q0 >= 1024 && kt == n_kt / 2) {\n"
        "      __syncwarp();\n"
        "      if (lane == 0) mbar_arrive(empty + 8 * st);\n"
        "      continue;\n"
        "    }\n"),
    "scale_1pct": (
        "bf16 body: scores scaled by 1.01 d^-1/2",
        "const float sl2 = scale * LOG2E;",
        "const float sl2 = scale * 1.01f * LOG2E;"),
    "pingpong_pv_slot": (
        "warp-specialised body (d > 128): a turn's deferred P.V reads the "
        "V slot of this turn's tile, not the last tile's",
        "    ws_pv<DQK, DV>(o, pa, v_s + prev * L::V_SLOT);",
        "    ws_pv<DQK, DV>(o, pa, v_s + slot * L::V_SLOT);"),
}
# The wide reading: gemma3-12b's prefill heads at B=4 (query heads, KV
# heads, d).
WIDE_SHAPE = (64, 32, 240)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.steps import build_model, make_prefill_step

    cs.log(cs.card_line())
    built = build.build_copies(
        {f"flash_{n}": ("flash_attention",
                        build.edited("flash_attention", [(old, new)]))
         for n, (_, old, new) in FAULTS.items()},
        os.path.join(build.BUILD_DIR, "faults"))
    real_entry = ops.entry
    variants = {"kernel": real_entry("flash_attention")}
    variants.update({n: built[f"flash_{n}"][0] for n in FAULTS})

    gen = torch.Generator(device="cuda").manual_seed(3)
    bh, t, d = cs.LM_B * 16, cs.LM_T, 128
    q, k, v = (torch.randn(bh, t, d, generator=gen, device="cuda"
                           ).bfloat16() for _ in range(3))
    want = ref.flash_attention_plain(q, k, v, True).float()
    wbh, wkv, wd = WIDE_SHAPE
    wq = torch.randn(wbh, t, wd, generator=gen, device="cuda").bfloat16()
    wk, wv = (torch.randn(wkv, t, wd, generator=gen, device="cuda"
                          ).bfloat16() for _ in range(2))
    wwant = ref.flash_attention_plain(wq, wk, wv, True).float()

    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg, seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (cs.LM_B, cs.LM_T)).astype(np.int32), device="cuda")
    prefill = make_prefill_step(model, cfg)
    batch = {"tokens": tokens}
    with cs.attention_as(ops, ref.flash_attention_plain):
        plain = prefill(model, batch).float()

    readings, bad = {}, []
    for name, fn in variants.items():
        ops.entry = lambda n, fn=fn: fn if n == "flash_attention" \
            else real_entry(n)
        try:
            got = ops.flash_attention(q, k, v, True).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            elem_ok = bool((err <= cs.FLASH_BF16_TOL * (1 + want.abs()))
                           .all())
            r_whole, r_row = cs.rows_rel(got, want)
            rows_ok = (r_whole <= cs.FLASH_BF16_WHOLE
                       and r_row <= cs.FLASH_BF16_ROW)
            wgot = ops.flash_attention(wq, wk, wv, True).float()
            w_whole, w_row = cs.rows_rel(wgot, wwant)
            w_elem = bool(((wgot - wwant).abs()
                           <= cs.FLASH_BF16_TOL * (1 + wwant.abs())).all())
            w_ok = (w_whole <= cs.FLASH_BF16_WHOLE
                    and w_row <= cs.FLASH_BF16_ROW)
            logits = prefill(model, batch).float()
            rel = float((logits - plain).norm() / plain.norm())
        finally:
            ops.entry = real_entry
        readings[name] = {"max_abs_err": float(err.max()),
                          "elementwise_3e-2_passes": elem_ok,
                          "rel_l2_whole": r_whole, "rel_l2_worst_row": r_row,
                          "check_rows_passes": rows_ok,
                          "prefill_rel_l2": rel,
                          "d240": {"elementwise_3e-2_passes": w_elem,
                                   "rel_l2_whole": w_whole,
                                   "rel_l2_worst_row": w_row,
                                   "check_rows_passes": w_ok}}
        what = "the kernel" if name == "kernel" else FAULTS[name][0]
        cs.log(f"{name} ({what}): max|err| {float(err.max()):.3e}, "
               f"elementwise 3e-2 {'passes' if elem_ok else 'fails'}; "
               f"relative L2 {r_whole:.3e} whole, {r_row:.3e} worst row: "
               f"check_rows {'passes' if rows_ok else 'fails'}; prefill "
               f"logits relative L2 {rel:.3e} (limit {cs.LM_REL_L2}); at "
               f"d = 240: elementwise 3e-2 "
               f"{'passes' if w_elem else 'fails'}, relative L2 "
               f"{w_whole:.3e} whole, {w_row:.3e} worst row: check_rows "
               f"{'passes' if w_ok else 'fails'}")
        if name == "kernel":
            if not (elem_ok and rows_ok and w_elem and w_ok
                    and rel <= cs.LM_REL_L2):
                bad.append(name)
        elif rows_ok and w_ok:
            bad.append(name)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(readings, fh, indent=1)
    cs.log(json.dumps(readings))
    if bad:
        print(f"flash_faults: FAILED: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
