"""Flash attention past d = 256 in the port, where the card runs the bf16
single-pass body (d <= 576, dv <= 512) or the d-sliced bodies, against the
JAX package on the CPU, in fp32.

Here the port's ``ops.flash_attention`` runs its plain version (the
tensors lie on the CPU) or, on ``meta``, reports its cost; the kernel
itself is held to the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  JAX's Pallas flash
kernel does not run in interpret mode in this JAX, so its plain reference
``flash_attention_ref`` stands for it, on V zero-padded to d (the Pallas
contract is dv = d), as in ``tests/test_torch_flash_wide.py``.

* ``ops.flash_attention`` at the single-pass body's instantiation edges (d
  257, 264, 320, 384, 385, 512, 513, 576 with dv in {d, 512, 256, 100}
  where dv <= d): causal, non-causal at ragged Tq != Tk, windowed, G = 4,
  both output types, against ``flash_attention_ref`` (windowed: JAX's
  ``_sdpa`` under ``_mask_bias``, since the reference takes no window;
  rtol 1e-5 / atol 1e-4, ``tests/test_kernels.py``'s fp32 tolerance).
* ``ops.flash_body``: which body the card runs for each (dtype, d, dv).
* The meta route's flops and bytes at the absorbed-MLA shape (BH = 128
  over one KV head, d = 576, dv = 512).

About 22 s alone, JAX's start included.
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
# 100), dv > 512 (the d-sliced body on the card).
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
         (20, 20, 2, 1, 576, 576, True, 0)]


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
    (576, 576, "bf16 d-sliced"), (577, 100, "bf16 d-sliced"),
    (1024, 512, "bf16 d-sliced"), (128, 128, "bf16"), (64, 1, "bf16")])
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
