"""The port's fp32 flash attention, where the card runs the fp32 body (d <=
256) or the fp32 single-pass body past it (in one CTA a query tile up to
d = 576 with dv <= 512, in a thread-block cluster beyond), against the
JAX package on the CPU.

Here the port's ``ops.flash_attention`` runs its plain version (the
tensors lie on the CPU) or, on ``meta``, reports its cost; the kernels
themselves are held to the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  JAX's Pallas flash
kernel does not run in interpret mode in this JAX, so its plain reference
``flash_attention_ref`` stands for it, on V zero-padded to d, or, with a
window, ``_sdpa`` under ``_mask_bias`` (``tests/test_torch_flash_single_
pass.py``'s ``_jax_flash``).

* ``ops.flash_attention`` in fp32 at the bodies' instantiation edges (d
  in {1, 31, 32, 33, 64, 127, 128, 129, 192 with dv = 128, 255, 256, 257,
  512, 513, 576 with dv = 512, 577}) and the clusters' (640, 1,024, 1,100
  with dv = 64, 600 with dv = 513, 4,160) in each mode (causal, non-causal at
  ragged Tq != Tk, windowed, G = 4) against JAX at rtol 1e-5 / atol 1e-4
  (``tests/test_kernels.py``'s fp32 tolerance), and ``out_dtype`` bf16 as
  the fp32 result rounded once.
* ``ops.flash_body(torch.float32, d, dv)`` at every edge.
* The meta route's flops and bytes in fp32 at d = 128 and 512, unchanged.

About 25 s alone (24.3-25.5 s measured before the cluster edges, which
add about 2 s), JAX's start included.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.kernels import ops  # noqa: E402
from test_torch_flash_single_pass import _jax_flash, _qkv  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4          # tests/test_kernels.py's fp32 flash

# (d, dv): the fp32 body's instantiation edges (DQK 32 / 64 / 128 / 256,
# DV 128 at DQK 256 for dv <= 128; d or dv not a multiple of 4 takes its
# 4-byte copies), the single-pass body's in one CTA (d 257-576, dv <= 512)
# and in clusters past it (C = 2, 2, 2, 3 with ranks holding no column of
# v, 2, and 8 past the 8-CTA reach at 4,160).
EDGES = [(1, 1), (31, 31), (32, 32), (33, 33), (64, 64), (127, 127),
         (128, 128), (129, 129), (192, 128), (255, 255), (256, 256),
         (257, 257), (512, 512), (513, 513), (576, 512), (577, 577),
         (640, 640), (1024, 1024), (1100, 64), (600, 513), (4160, 4160)]
# (label, tq, tk, heads, G, causal, window): Tq / Tk ragged against every
# body's tiles, Tq < Tk in the non-causal mode.
MODES = [("causal", 37, 37, 2, 1, True, 0),
         ("non-causal", 21, 34, 2, 1, False, 0),
         ("windowed", 30, 30, 2, 2, True, 7),
         ("grouped", 26, 26, 8, 4, True, 0)]


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("d,dv", EDGES)
def test_flash_f32_matches_jax(d, dv, mode):
    _, tq, tk, h, grp, causal, window = mode
    q, k, v = _qkv(tq, tk, h, grp, d, dv, seed=tq + tk + d + dv)
    want = _jax_flash(q, k, v, causal, grp, window)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq_, tk_, tv_, causal, window)
    assert tuple(got.shape) == (h, tq, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[..., :dv], rtol=RTOL,
                               atol=ATOL)
    low = ops.flash_attention(tq_, tk_, tv_, causal, window,
                              out_dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and torch.equal(low, got.bfloat16())


@pytest.mark.parametrize("d,dv", EDGES + [(576, 513), (320, 1), (1024, 512)])
def test_flash_body_names_the_fp32_body(d, dv):
    want = "fp32" if d <= 256 else "fp32 single-pass"
    assert ops.flash_body(torch.float32, d, dv) == want
    assert want in ops.FLASH_BODIES.values()


@pytest.mark.parametrize("bh,bkv,t,d", [(64, 32, 2048, 128),
                                        (32, 32, 2048, 512)])
@pytest.mark.parametrize("ot", [torch.float32, torch.bfloat16])
def test_meta_cost_of_the_fp32_rows(bh, bkv, t, d, ot):
    q = torch.empty(bh, t, d, device="meta")
    k = torch.empty(bkv, t, d, device="meta")
    seen = []
    with ops.meta_costs(lambda *a: seen.append(a)):
        out = ops.flash_attention(q, k, k, True, out_dtype=ot)
    assert out.device.type == "meta" and out.dtype == ot
    assert tuple(out.shape) == (bh, t, d)
    (name, flops, nbytes), = seen
    pairs = t * (t + 1) // 2
    assert name == "flash_attention"
    assert flops == 4.0 * d * bh * pairs
    eo = torch.empty(0, dtype=ot).element_size()
    assert nbytes == 4 * (d * (bh * t + bkv * t) + d * bkv * t) \
        + eo * d * bh * t
