"""Flash attention past d = 256 in the port, where the card runs the bf16
single-pass body (in one CTA a query tile up to d = 576 with dv <= 512,
in a thread-block cluster past it), against the JAX package on the CPU,
in fp32.

Here the port's ``ops.flash_attention`` runs its plain version (the
tensors lie on the CPU) or, on ``meta``, reports its cost; the kernel
itself is held to the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  JAX's Pallas flash
kernel does not run in interpret mode in this JAX, so its plain reference
``flash_attention_ref`` stands for it, on V zero-padded to d (the Pallas
contract is dv = d), as in ``tests/test_torch_flash_wide.py``.

* ``ops.flash_attention`` at the single-pass body's instantiation edges (d
  257, 264, 320, 384, 385, 512, 513, 576 with dv in {d, 512, 256, 100}
  where dv <= d) and at the clusters' (640, 1,024 at ragged Tq != Tk,
  1,100 with dv = 64 under a window at G = 4, 600 with dv = 513, and
  4,160 past the 8-CTA reach at T <= 16): causal, non-causal at ragged Tq
  != Tk, windowed, G = 4,
  both output types, against ``flash_attention_ref`` (windowed: JAX's
  ``_sdpa`` under ``_mask_bias``, since the reference takes no window;
  rtol 1e-5 / atol 1e-4, ``tests/test_kernels.py``'s fp32 tolerance).
* ``ops.flash_body``: which body the card runs for each (dtype, d, dv).
* The meta route's flops and bytes at the absorbed-MLA shape (BH = 128
  over one KV head, d = 576, dv = 512).

About 22 s alone, JAX's start included (the five cluster cases add about
1 s).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4          # tests/test_kernels.py's fp32 flash


def _qkv(tq, tk, h, grp, d, dv, seed):
    """q [h, tq, d], k [h / G, tk, d], v [h / G, tk, dv] from numpy."""
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (h, tq, d)).astype(np.float32),
            r.normal(0, 1, (h // grp, tk, d)).astype(np.float32),
            r.normal(0, 1, (h // grp, tk, dv)).astype(np.float32))


def _jax_flash(q, k, v, causal, grp, window):
    """JAX's attention on V zero-padded to d: ``flash_attention_ref`` ([T,
    H, D], one KV head per query head), or with a sliding window, which it
    does not take, ``_sdpa`` under ``_mask_bias`` (the model path's mask,
    grouped heads adjacent as in the port): [h, tq, d]."""
    d, dv = q.shape[-1], v.shape[-1]
    vp = np.pad(v, ((0, 0), (0, 0), (0, d - dv)))
    if window:
        tq, tk = q.shape[1], k.shape[1]
        bias = JA._mask_bias(jnp.arange(tq), jnp.arange(tk), causal, window)
        out = JA._sdpa(*(jnp.asarray(a.transpose(1, 0, 2))[None]
                         for a in (q, k, vp)), bias, d ** -0.5)
        return np.asarray(out[0]).transpose(1, 0, 2)
    k, vp = (np.repeat(a, grp, axis=0) for a in (k, vp))
    out = jref.flash_attention_ref(*(jnp.asarray(a.transpose(1, 0, 2))
                                     for a in (q, k, vp)), causal=causal)
    return np.asarray(out).transpose(1, 0, 2)


# (tq, tk, heads, G, d, dv, causal, window): each instantiation's edges
# (DQK 512 / 576, DV 256 / 512), the plain-load widths (257, 385, 513, dv =
# 100), dv > 512 and d > 576 (clusters on the card: C = 2, 2, 3 with two
# ranks holding no column of v, 2, and 8 with Q in rounds).
CASES = [(40, 40, 2, 1, 257, 257, True, 0),
         (33, 50, 4, 2, 264, 256, False, 0),
         (30, 30, 4, 4, 320, 320, True, 0),
         (25, 25, 2, 1, 320, 100, True, 7),
         (36, 36, 4, 2, 384, 384, True, 0),
         (20, 31, 4, 4, 385, 256, False, 0),
         (40, 40, 2, 1, 512, 512, True, 0),
         (17, 29, 4, 4, 512, 100, False, 0),
         (30, 30, 2, 2, 512, 256, True, 12),
         (24, 24, 2, 1, 513, 513, True, 0),
         (24, 24, 2, 2, 513, 512, True, 0),
         (32, 32, 8, 8, 576, 512, True, 0),
         (21, 40, 4, 2, 576, 256, False, 0),
         (28, 28, 4, 4, 576, 100, True, 5),
         (20, 20, 2, 1, 576, 576, True, 0),
         (24, 24, 2, 1, 640, 640, True, 0),
         (19, 27, 2, 1, 1024, 1024, False, 0),
         (26, 26, 8, 4, 1100, 64, True, 9),
         (22, 22, 2, 1, 600, 513, True, 0),
         (12, 12, 2, 1, 4160, 4160, True, 0)]


@pytest.mark.parametrize("tq,tk,h,grp,d,dv,causal,window", CASES)
def test_flash_past_d_256_matches_jax(tq, tk, h, grp, d, dv, causal,
                                      window):
    q, k, v = _qkv(tq, tk, h, grp, d, dv, seed=tq + tk + d + dv)
    want = _jax_flash(q, k, v, causal, grp, window)
    assert float(np.abs(want[..., dv:]).max(initial=0.0)) == 0.0
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq_, tk_, tv_, causal, window)
    assert tuple(got.shape) == (h, tq, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[..., :dv], rtol=RTOL,
                               atol=ATOL)
    # out_dtype: the fp32 result rounded once
    low = ops.flash_attention(tq_, tk_, tv_, causal, window,
                              out_dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and torch.equal(low,
                                                       got.bfloat16())


@pytest.mark.parametrize("d,dv,body", [
    (256, 256, "bf16 warp-specialised"), (257, 257, "bf16 single-pass"),
    (257, 1, "bf16 single-pass"), (512, 512, "bf16 single-pass"),
    (513, 512, "bf16 single-pass"), (576, 512, "bf16 single-pass"),
    (576, 576, "bf16 single-pass"), (577, 100, "bf16 single-pass"),
    (1024, 512, "bf16 single-pass"), (128, 128, "bf16"), (64, 1, "bf16")])
def test_flash_body_names_the_body_the_card_runs(d, dv, body):
    assert ops.flash_body(torch.bfloat16, d, dv) == body
    assert ops.flash_body(torch.float32, d, dv) == (
        "fp32" if d <= 256 else body.replace("bf16", "fp32"))


def test_flash_body_refuses_what_the_kernel_refuses():
    with pytest.raises(TypeError):
        ops.flash_body(torch.float16, 64, 64)
    for d, dv in ((64, 65), (64, 0)):
        with pytest.raises(ValueError):
            ops.flash_body(torch.bfloat16, d, dv)


@pytest.mark.parametrize("dt,ot", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_meta_cost_at_the_absorbed_mla_shape(dt, ot):
    bh, bkv, t, d, dv = 128, 1, 2048, 576, 512
    q = torch.empty(bh, t, d, dtype=dt, device="meta")
    k = torch.empty(bkv, t, d, dtype=dt, device="meta")
    v = torch.empty(bkv, t, dv, dtype=dt, device="meta")
    seen = []
    with ops.meta_costs(lambda *a: seen.append(a)):
        out = ops.flash_attention(q, k, v, True, out_dtype=ot)
    assert out.device.type == "meta" and out.dtype == ot
    assert tuple(out.shape) == (bh, t, dv)
    (name, flops, nbytes), = seen
    assert name == "flash_attention"
    pairs = t * (t + 1) // 2
    assert ops.flash_pairs(t, t, True) == pairs
    assert flops == 2.0 * (d + dv) * bh * pairs == 584400764928.0
    eo = torch.empty(0, dtype=ot).element_size()
    assert nbytes == 2 * (d * (bh * t + t) + dv * t) + eo * dv * bh * t


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Mangled entry names of the single-pass bodies as nvcc's -Xptxas -v
# report prints them: bf16 (DQK, DV, MODE), fp32 (out type, in a cluster).
_SP = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897920"
       "flash_bf16_sp_kernelILi{0}ELi{1}ELi{2}EEEvPK13__nv_bfloat16")
_F32SP = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897919"
          "flash_f32_sp_kernelI{0}Lb{1}EEEvPKfS2_S2_PT_i")


def _entry_lines(name, regs, spill):
    return [f"ptxas info    : Compiling entry function '{name}' for "
            "'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            "bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers"]


@pytest.mark.parametrize("spill", [0, 8])
def test_chip_smoke_reads_the_cluster_instantiations(spill):
    # chip_smoke.py's nvcc checks key the bf16 single pass by (DQK, DV,
    # MODE) and the fp32 one by its output type and cluster flag, so the
    # clusters' instantiations count apart and a spill in one fails.
    cs = _chip_smoke()
    lines = []
    for dqk, dv, mode in ((512, 256, 0), (512, 512, 0), (576, 512, 0),
                          (512, 256, 1), (512, 512, 1), (512, 512, 2)):
        lines += _entry_lines(_SP.format(dqk, dv, mode), 168,
                              spill if mode == 2 else 0)
    report = "\n".join(lines)
    got = cs.ws_nvcc_report(report, cs.SP_KERNEL)["instantiations"]
    assert sorted(got) == sorted(
        ["DQK=512 DV=256 MODE=0", "DQK=512 DV=512 MODE=0",
         "DQK=576 DV=512 MODE=0", "DQK=512 DV=256 MODE=1",
         "DQK=512 DV=512 MODE=1", "DQK=512 DV=512 MODE=2"])
    assert len(got) == cs.SP_INSTANTIATIONS
    if spill:
        with pytest.raises(SystemExit, match="spills"):
            cs.ws_nvcc_check(report, cs.SP_KERNEL, cs.SP_INSTANTIATIONS)
    else:
        assert cs.ws_nvcc_check(report, cs.SP_KERNEL,
                                cs.SP_INSTANTIATIONS)["instantiations"] == got
    keys = {cs.F32_KERNEL.search(_F32SP.format(t, b)).group(2)
            for t in ("f", "13__nv_bfloat16") for b in (0, 1)}
    assert len(keys) == 4
