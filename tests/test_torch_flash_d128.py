"""Flash attention at d <= 128 in the port, where the card runs the bf16
warp-specialised body at its DQK = 64 (d <= 64) and DQK = 128 (64 < d <=
128) instantiations, against the JAX package on the CPU, in fp32.

Here the port's ``ops.flash_attention`` runs its plain version (the
tensors lie on the CPU); the kernel itself is held to the same plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
JAX's Pallas flash kernel does not run in interpret mode in this JAX, so
its plain reference ``flash_attention_ref`` stands for it, on V
zero-padded to d (the Pallas contract is dv = d), as in
``tests/test_torch_flash_single_pass.py``.

* ``ops.flash_attention`` at the instantiations' edges (d in {1, 8, 32,
  40, 63, 64, 65, 112, 120, 128} with dv in {d, 64, 1} where dv <= d):
  causal, non-causal at ragged Tq != Tk, windows of 1, 5 and 64, G in
  {1, 2, 5, 8}, both output types, against ``flash_attention_ref``
  (windowed: JAX's ``_sdpa`` under ``_mask_bias``, since the reference
  takes no window; rtol 1e-5 / atol 1e-4, ``tests/test_kernels.py``'s
  fp32 tolerance).
* ``ops.flash_body``: "bf16" (code 3) for every bf16 d <= 128.
* ``chip_smoke.ws_nvcc_check`` on a ptxas report: each instantiation's
  registers and spills read, and a report that says the body's wgmma are
  serialized refused.

About 30 s alone, JAX's start included.
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


# (d, dv): DQK 64's edges (1, 8, 32, 40, 63, 64; 40 and 63 not multiples
# of 8, which TMA cannot take on the card) and DQK 128's (65, 112: kimi-k2,
# 120, 128), V d, 64 or 1 wide.
WIDTHS = [(d, dv) for d in (1, 8, 32, 40, 63, 64, 65, 112, 120, 128)
          for dv in sorted({d, 64, 1}, reverse=True) if dv <= d]
# (tq, tk, heads, G, causal, window): causal, non-causal at ragged Tq !=
# Tk, windows ending inside and beyond a key tile, G = 1 / 2 / 5 / 8.
MODES = [(70, 70, 2, 1, True, 0),
         (50, 83, 4, 2, False, 0),
         (60, 60, 5, 5, True, 1),
         (40, 40, 8, 8, True, 5),
         (150, 150, 4, 2, True, 64),
         (77, 30, 8, 8, False, 0),
         (130, 130, 5, 5, True, 0)]
# Each width in two modes, cycling through them.
CASES = [(*MODES[(i + j) % len(MODES)], d, dv)
         for i, (d, dv) in enumerate(WIDTHS) for j in (0, 3)]


@pytest.mark.parametrize("tq,tk,h,grp,causal,window,d,dv", CASES)
def test_flash_at_d_up_to_128_matches_jax(tq, tk, h, grp, causal, window,
                                          d, dv):
    q, k, v = _qkv(tq, tk, h, grp, d, dv, seed=7 * tq + tk + 3 * d + dv)
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


def test_flash_body_is_the_bf16_body_up_to_d_128():
    for d in range(1, 129):
        for dv in sorted({1, min(64, d), d}):
            assert ops.flash_body(torch.bfloat16, d, dv) == "bf16", (d, dv)
            assert ops.flash_body(torch.float32, d, dv) == "fp32", (d, dv)
    assert ops.FLASH_BODIES[3] == "bf16"
    assert ops.flash_body(torch.bfloat16, 129, 129) == \
        "bf16 warp-specialised"


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_KERNEL = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897920"
           "flash_bf16_ws_kernelILi{0}ELi{1}EEEvPK13__nv_bfloat16")


def _report(serialized):
    lines = []
    for dqk, dv, regs in ((64, 64, 128), (128, 128, 168)):
        name = _KERNEL.format(dqk, dv)
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads",
                  f"ptxas info    : Used {regs} registers, used 16 barriers"]
    if serialized:
        lines.append("ptxas info    : (C7520) Potential Performance Loss: "
                     "wgmma.mma_async instructions are serialized due to "
                     "program dependence on compiler-inserted WG.AR in "
                     f"divergent path in the function '{_KERNEL.format(128, 128)}'")
    return "\n".join(lines)


@pytest.mark.parametrize("serialized", [False, True])
def test_ws_nvcc_check_reads_registers_and_refuses_serialized_wgmma(
        serialized):
    cs = _chip_smoke()
    got = cs.ws_nvcc_report(_report(serialized))
    assert got["instantiations"] == {
        "DQK=64 DV=64": {"spill_stores": 0, "spill_loads": 0,
                         "registers": 128},
        "DQK=128 DV=128": {"spill_stores": 0, "spill_loads": 0,
                           "registers": 168}}
    assert len(got["warnings"]) == int(serialized)
    if serialized:
        with pytest.raises(SystemExit, match="serialized"):
            cs.ws_nvcc_check(_report(True), count=2)
    else:
        assert cs.ws_nvcc_check(_report(False), count=2) == got
