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
  runs at DQK 256 (at d = 128 it runs DQK 128), at d = 512 (BH=8 over 4
  KV heads, T=2048, bf16, causal), which the single-pass body past d =
  256 runs, at d = 64 (BH=20 over 4 KV heads, T=2048, bf16, causal),
  the warp-specialised body's DQK 64, and at d = 1024 (BH=8 over 4),
  which the single-pass body runs in clusters of two;
* fp32 at d = 128 (BH=16 over 8 KV heads, T=2048, causal), which the
  fp32 body runs, at d = 512 (BH=8 over 4), which the fp32 single-pass
  body runs, at d = 1024 (BH=8 over 4, clusters of two) and at d = 520
  (BH=8 over 4, clusters of two whose rank 1 holds 4 of the 9 panels to
  rank 0's 5, so it runs ahead of its peer):
  ``chip_smoke.check_close``'s rtol 1e-5 / atol 1e-4 against the plain
  version;
* the last-position logits of a qwen3-0.6b prefill (bf16, B=4, T=2048,
  weights from seed 0, as in ``chip_smoke.py``) against the same model
  with plain attention, beside ``chip_smoke.py``'s 2e-2 limit.

It exits non-zero if the real kernel fails a check, a fault passes
``check_rows`` at all five bf16 shapes and the fp32 check at all four
fp32 shapes, a fault of ``PATH_FAULTS`` (the bf16 body at d <= 128)
passes ``check_rows`` at the d = 128 path shape, or one of
``CLUSTER_FAULTS`` (the clusters' exchange) passes a check it names
(clusters of two).  The last line of the output is the readings as JSON.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# The single-pass body's turn for tile kt > kt0, from its wait for the
# last tile's V to that V slot's release (with `late`; `early` releases it
# before its P.V is issued).
_SP_TILE = (
    "      mbar_wait(full_v + 8 * prev, ((step - 1) / SL) & 1);\n"
    "{early}"
    "      wgmma_fence();\n"
    "      sp_qk<DQK, DV, MODE, NKQ>(s, q_s, k_s + slot * L::K_SLOT, kq0,\n"
    "                                rounds > 1);\n"
    "      wgmma_commit();\n"
    "      sp_pv<DQK, DV, MODE>(o, pa, v_s + prev * L::V_SLOT);\n"
    "      wgmma_commit();\n"
    "      wgmma_wait_one();                  // Q.K^T of tile kt done\n"
    "      fence_regs(s);\n"
    "      __syncwarp();\n"
    "      if (lane == 0) {{\n"
    "        mbar_arrive(empty_k + 8 * slot);\n"
    "        if constexpr (MODE == 2) mbar_arrive(q_empty);\n"
    "      }}\n"
    "      sp_complete<DQK, DV, MODE>(s, x_mine, x_other, x_s, bars, wg,\n"
    "                                 sl.rank, sl.nc, step, lane, false,\n"
    "                                 kt + 1 == n_kt);\n"
    "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, q0,\n"
    "                    row_lo, row_hi, t4, tk, causal, window, sl2);\n"
    "      wgmma_wait_all();                  // P.V of tile kt - 1 done\n"
    "      fence_regs(o);\n"
    "{late}")
# The clusters' gather (cl_gather, both bodies' exchange): the wait for
# every CTA's S_r in a slot, then each half's sums over the cluster.
_CL_WAIT = "  mbar_wait_cluster(x_full + 8 * slot, use & 1);\n"
_CL_SUMS = ("  const uint32_t at = smem_u32(pub);\n"
            "  if (hf == 0)\n"
            "    cl_sum_half<N, 0>(s, at, rank, nc);\n"
            "  else\n"
            "    cl_sum_half<N, 1>(s, at, rank, nc);\n")
_SP_RELEASE_V = ("      __syncwarp();\n"
                 "      if (lane == 0) mbar_arrive(empty_v + 8 * prev);\n")

# name -> (what the fault does, text of flash_attention.cu, its replacement)
FAULTS = {
    "causal_skip_early": (
        "bf16 tensor-core bodies (wg_kv_tiles): the causal skip one query "
        "tile early: the diagonal KV tiles are skipped",
        "const int end = causal ? min(tk, q0 + BQ_) : tk;",
        "const int end = causal ? min(tk, q0) : tk;"),
    "drop_mid_tile_late": (
        "warp-specialised body (d <= 256): query tiles from row 1024 on "
        "skip their middle KV tile (its P zero, m and l kept; the rings "
        "still fill and release it)",
        "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, "
        "wq0,\n",
        "      if (q0 >= 1024 && kt == n_kt / 2) {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;\n"
        "        a_lo = a_hi = 1.0f;\n"
        "      } else\n"
        "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, "
        "wq0,\n"),
    "scale_1pct": (
        "warp-specialised body (d <= 256): scores scaled by 1.01 d^-1/2",
        "  const int row_lo = wq0 + 16 * warp + g, row_hi = row_lo + 8;\n"
        "  const float sl2 = LOG2E * scale;",
        "  const int row_lo = wq0 + 16 * warp + g, row_hi = row_lo + 8;\n"
        "  const float sl2 = LOG2E * 1.01f * scale;"),
    "pingpong_pv_slot": (
        "warp-specialised body (d <= 256): a turn's deferred P.V reads the "
        "V slot of this turn's tile, not the last tile's",
        "    ws_pv<DQK, DV>(o, pa, v_s + prev * L::V_SLOT);",
        "    ws_pv<DQK, DV>(o, pa, v_s + slot * L::V_SLOT);"),
    "sp_exchange_early": (
        "single-pass body (d > 256): a warpgroup reads the other's partial "
        "S before the named barrier that says it is written",
        "  turn_wait(SP_BAR_WRITTEN);\n"
        "#pragma unroll\n"
        "  for (int i = 0; i < BK / 8; ++i) {\n"
        "    const float4 x = other[128 * i];\n"
        "    s[4 * i] += x.x;\n"
        "    s[4 * i + 1] += x.y;\n"
        "    s[4 * i + 2] += x.z;\n"
        "    s[4 * i + 3] += x.w;\n"
        "  }\n",
        "#pragma unroll\n"
        "  for (int i = 0; i < BK / 8; ++i) {\n"
        "    const float4 x = other[128 * i];\n"
        "    s[4 * i] += x.x;\n"
        "    s[4 * i + 1] += x.y;\n"
        "    s[4 * i + 2] += x.z;\n"
        "    s[4 * i + 3] += x.w;\n"
        "  }\n"
        "  turn_wait(SP_BAR_WRITTEN);\n"),
    "sp_v_release_early": (
        "single-pass body (d > 256): a V slot released once it is full, "
        "before the P.V that reads it is issued",
        _SP_TILE.format(early="", late=_SP_RELEASE_V),
        _SP_TILE.format(early=_SP_RELEASE_V, late="")),
    "sp_stale_max": (
        "single-pass body (d > 256): warpgroup 1's running max is not "
        "updated past the first tile",
        "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, "
        "q0,\n",
        "      float mf_lo = m_lo, mf_hi = m_hi;\n"
        "      ws_scores<BK>(s, wg ? mf_lo : m_lo, wg ? mf_hi : m_hi, l_lo, "
        "l_hi, a_lo, a_hi, kt * BK, q0,\n"),
    "f32_slot_reused_early": (
        "fp32 body (d <= 256): the next tile's K and V are copied into the "
        "slot this tile's products are still reading",
        "        f32_stage_kv<DQK, DV>(k_s, v_s, (it + SL - 1) % SL, kb, vb,",
        "        f32_stage_kv<DQK, DV>(k_s, v_s, it % SL, kb, vb,"),
    "f32_stale_max": (
        "fp32 body (d <= 256): the running max is not updated past the "
        "first tile",
        "        const float alpha = exp2f(m[i] - mn);   // 1 where the max "
        "held\n        m[i] = mn;\n",
        "        const float alpha = exp2f(m[i] - mn);   // 1 where the max "
        "held\n        if (kt == kt0) m[i] = mn;\n"),
    "f32_diagonal_unmasked": (
        "fp32 body (d <= 256): the mask skipped on the causal diagonal "
        "tiles (applied only at the ragged end of Tk and the window's "
        "edge)",
        "      if ((causal && k0 + KB - 1 > wq0) || k0 + KB > tk ||\n"
        "          (window > 0 && wq0 + WR - 1 - k0 >= window)) {",
        "      if (k0 + KB > tk ||\n"
        "          (window > 0 && wq0 + WR - 1 - k0 >= window)) {"),
    "f32sp_stale_max": (
        "fp32 single-pass body (d > 256): the running max is not updated "
        "past the first tile",
        "          const float alpha = exp2f(m[i] - mn);   // 1 where the max "
        "held\n          m[i] = mn;\n",
        "          const float alpha = exp2f(m[i] - mn);   // 1 where the max "
        "held\n          if (pc < ppt) m[i] = mn;\n"),
    "cl_skip_peer": (
        "clusters (d > 576 or dv > 512), both bodies' shared gather: rank "
        "0 leaves the last rank's S_r out of its sums (its S, m and l then "
        "differ from its peers')",
        "  for (int r = 0; r < nc; ++r) {\n"
        "    if (r == rank) {\n"
        "      if (r > 0) {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < N; ++i)",
        "  for (int r = 0; r < nc - (rank == 0); ++r) {\n"
        "    if (r == rank) {\n"
        "      if (r > 0) {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < N; ++i)"),
    "cl_read_before_written": (
        "clusters, both bodies' shared gather: a thread reads its peers' "
        "S_r before the barrier that says they are written, and waits on "
        "it only afterwards",
        _CL_WAIT + _CL_SUMS,
        _CL_SUMS + _CL_WAIT),
    "cl_dv_offset": (
        "clusters, both bodies: ranks past 0 take their slice of v / out "
        "one 64-column panel late (the panel before it is never stored)",
        "  s.v0 = vs0 + rank * per_v * 64;",
        "  s.v0 = vs0 + (rank * per_v + (rank > 0)) * 64;"),
    "f32sp_diagonal_unmasked": (
        "fp32 single-pass body (d > 256): the mask skipped on the causal "
        "diagonal tiles",
        "        if ((causal && k0 + KB - 1 > q0) || k0 + KB > tk ||",
        "        if (k0 + KB > tk ||"),
}
# The other bf16 readings: gemma3-12b's prefill heads at B=4, d = 512,
# and hymba-1.5b's d = 64 with G = 5 at one sequence (query heads, KV
# heads, d).
WIDE_SHAPES = ((64, 32, 240), (8, 4, 512), (20, 4, 64), (8, 4, 1024))
# Faults in the bf16 body at d <= 128 (the warp-specialised body): each
# must fail check_rows at the d = 128 path shape itself.
PATH_FAULTS = ("causal_skip_early", "drop_mid_tile_late", "scale_1pct",
               "pingpong_pv_slot")
# The fp32 readings (query heads, KV heads, d; T = 2048, causal): the fp32
# body at qwen3-0.6b's head dim, the fp32 single-pass body at d = 512, in
# clusters of two at d = 1024 (the ranks' work equal) and at d = 520 (rank
# 1 a fifth lighter), each within rtol 1e-5 / atol 1e-4 of the plain
# version or not.
F32_SHAPES = ((16, 8, 128), (8, 4, 512), (8, 4, 1024), (8, 4, 520))
# Faults in the clusters' exchange, all in code both bodies share (the
# gather, the slices): each must fail its checks named here, bf16 at d =
# 1024 and fp32 in a cluster of two.  An early read shows only where a
# reader runs ahead of the writer: the fp32 ranks at d = 1024 keep step
# (it passed there on the card), so fp32 holds it at d = 520, where rank 1
# has less work a tile than rank 0.  A v slice a panel late needs a rank
# past 0 that stores columns (both fp32 shapes have one).
CLUSTER_FAULTS = {"cl_skip_peer": ("d1024", "fp32_d1024", "fp32_d520"),
                  "cl_read_before_written": ("d1024", "fp32_d520"),
                  "cl_dv_offset": ("d1024", "fp32_d1024", "fp32_d520")}


def f32_reading(torch, cs, got, want):
    """``chip_smoke.check_close``'s fp32 test (rtol 1e-5 / atol 1e-4)
    as a reading: whether it passes, and the largest excess over the
    limit."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    lim = cs.KERNEL_ATOL + cs.KERNEL_RTOL * want.abs()
    ok = bool(torch.isfinite(got).all()) and not bool((err > lim).any())
    return {"check_close_passes": ok, "max_abs_err": float(err.max())}


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
    wide = []
    for wbh, wkv, wd in WIDE_SHAPES:
        wq = torch.randn(wbh, t, wd, generator=gen, device="cuda").bfloat16()
        wk, wv = (torch.randn(wkv, t, wd, generator=gen, device="cuda"
                              ).bfloat16() for _ in range(2))
        wide.append((wd, wq, wk, wv,
                     ref.flash_attention_plain(wq, wk, wv, True).float()))

    f32 = []
    for fbh, fkv, fd in F32_SHAPES:
        fq = torch.randn(fbh, t, fd, generator=gen, device="cuda")
        fk, fv = (torch.randn(fkv, t, fd, generator=gen, device="cuda")
                  for _ in range(2))
        f32.append((fd, fq, fk, fv,
                    ref.flash_attention_plain(fq, fk, fv, True)))

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
            at_d = {}
            for wd, wq, wk, wv, wwant in wide:
                wgot = ops.flash_attention(wq, wk, wv, True).float()
                w_whole, w_row = cs.rows_rel(wgot, wwant)
                at_d[wd] = {
                    "elementwise_3e-2_passes": bool(
                        ((wgot - wwant).abs() <= cs.FLASH_BF16_TOL
                         * (1 + wwant.abs())).all()),
                    "rel_l2_whole": w_whole, "rel_l2_worst_row": w_row,
                    "check_rows_passes": (w_whole <= cs.FLASH_BF16_WHOLE
                                          and w_row <= cs.FLASH_BF16_ROW)}
                del wgot
            at_f32 = {}
            for fd, fq, fk, fv, fwant in f32:
                at_f32[fd] = f32_reading(
                    torch, cs, ops.flash_attention(fq, fk, fv, True), fwant)
            logits = prefill(model, batch).float()
            rel = float((logits - plain).norm() / plain.norm())
        finally:
            ops.entry = real_entry
        readings[name] = {"max_abs_err": float(err.max()),
                          "elementwise_3e-2_passes": elem_ok,
                          "rel_l2_whole": r_whole, "rel_l2_worst_row": r_row,
                          "check_rows_passes": rows_ok,
                          "prefill_rel_l2": rel,
                          **{f"d{wd}": r for wd, r in at_d.items()},
                          **{f"fp32_d{fd}": r for fd, r in at_f32.items()}}
        what = "the kernel" if name == "kernel" else FAULTS[name][0]
        cs.log(f"{name} ({what}): max|err| {float(err.max()):.3e}, "
               f"elementwise 3e-2 {'passes' if elem_ok else 'fails'}; "
               f"relative L2 {r_whole:.3e} whole, {r_row:.3e} worst row: "
               f"check_rows {'passes' if rows_ok else 'fails'}; prefill "
               f"logits relative L2 {rel:.3e} (limit {cs.LM_REL_L2})" + "".join(
                   f"; at d = {wd}: elementwise 3e-2 "
                   f"{'passes' if r['elementwise_3e-2_passes'] else 'fails'}"
                   f", relative L2 {r['rel_l2_whole']:.3e} whole, "
                   f"{r['rel_l2_worst_row']:.3e} worst row: check_rows "
                   f"{'passes' if r['check_rows_passes'] else 'fails'}"
                   for wd, r in at_d.items()) + "".join(
                   f"; fp32 at d = {fd}: max|err| {r['max_abs_err']:.3e}, "
                   f"rtol 1e-5 / atol 1e-4 "
                   f"{'passes' if r['check_close_passes'] else 'fails'}"
                   for fd, r in at_f32.items()))
        wide_ok = all(r["check_rows_passes"] for r in at_d.values())
        f32_ok = all(r["check_close_passes"] for r in at_f32.values())
        if name == "kernel":
            if not (elem_ok and rows_ok and wide_ok and f32_ok
                    and rel <= cs.LM_REL_L2
                    and all(r["elementwise_3e-2_passes"]
                            for r in at_d.values())):
                bad.append(name)
        elif (rows_ok and wide_ok and f32_ok) or (name in PATH_FAULTS
                                                  and rows_ok):
            bad.append(name)
        elif name in CLUSTER_FAULTS and any(
                readings[name][key].get("check_rows_passes",
                                        readings[name][key].get(
                                            "check_close_passes"))
                for key in CLUSTER_FAULTS[name]):
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
