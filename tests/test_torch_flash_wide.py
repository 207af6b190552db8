"""Flash attention with V at its own width (dv <= d) in the port, against
the JAX package on the CPU, in fp32.

The port's ``ops.flash_attention`` takes v of ``[BH / G, Tk, dv]`` and
returns ``[BH, Tq, dv]``; deepseek-v3's MLA calls it with dqk = 192 and
dv = 128 instead of zero-padding V to dqk.  The Pallas function's contract
is dv = d, so JAX is run on V zero-padded to d and its first dv columns
compared.  JAX's Pallas flash kernel does not run in interpret mode in
this JAX (``tests/test_kernels.py`` marks its sweep xfail), so its plain
reference ``flash_attention_ref`` stands for it, as in
``tests/test_torch_contracts.py``.  Here the port's wrapper runs its plain
version (the tensors lie on the CPU) or, on ``meta``, reports its cost.

* ``ref.flash_attention_plain`` / ``ops.flash_attention`` with dv < d
  against ``flash_attention_ref`` on padded V (rtol 1e-5 / atol 1e-4,
  ``tests/test_kernels.py``'s fp32 tolerance); the padded columns of
  JAX's output are zero.
* deepseek-v3's MLA flash route (V unpadded) against JAX's
  ``mla_attention`` at smoke size (2e-4 / 2e-5); its gradients against
  ``jax.grad`` are ``tests/test_torch_mla.py``'s
  ``test_flash_backward_chunks_match_jax_gradients``, which now runs the
  unpadded route.
* The gradient of ``attention._FlashAttention`` (the kernel forward, the
  chunked plain recompute backward) with dv < d against ``jax.grad``.
* The meta route's flops and bytes at dv < d and dv = d.
* The wrapper refusing dv > d and dv < 1 on the CPU and meta routes
  (the CUDA route's refusal is in ``tests/test_torch_gpu.py``).

About 20 s alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4          # tests/test_kernels.py's fp32 flash
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(tq, tk, h, grp, d, dv, seed):
    """q [h, tq, d], k [h / G, tk, d], v [h / G, tk, dv] from numpy."""
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (h, tq, d)).astype(np.float32),
            r.normal(0, 1, (h // grp, tk, d)).astype(np.float32),
            r.normal(0, 1, (h // grp, tk, dv)).astype(np.float32))


def _jax_flash(q, k, v, causal, grp):
    """JAX's ``flash_attention_ref`` (its [T, H, D] layout, one KV head
    per query head, dv = d) on V zero-padded to q's head dim: [h, tq,
    d]."""
    d, dv = q.shape[-1], v.shape[-1]
    vp = np.pad(v, ((0, 0), (0, 0), (0, d - dv)))
    k, vp = (np.repeat(a, grp, axis=0) for a in (k, vp))
    out = jref.flash_attention_ref(*(jnp.asarray(a.transpose(1, 0, 2))
                                     for a in (q, k, vp)), causal=causal)
    return np.asarray(out).transpose(1, 0, 2)


# (tq, tk, heads, G, d, dv, causal): MLA's 192 / 128, gemma3's 240 and 168
# at V 128 wide, a narrow head, ragged Tk non-causal, grouped KV heads.
CASES = [(40, 40, 2, 1, 192, 128, True),
         (33, 33, 4, 2, 240, 128, True),
         (25, 25, 2, 2, 168, 100, True),
         (17, 29, 4, 4, 64, 40, False),
         (30, 50, 2, 1, 192, 1, False),
         (20, 20, 3, 1, 24, 16, True)]


@pytest.mark.parametrize("tq,tk,h,grp,d,dv,causal", CASES)
def test_plain_flash_with_narrow_v_matches_jax_on_padded_v(tq, tk, h, grp,
                                                           d, dv, causal):
    q, k, v = _qkv(tq, tk, h, grp, d, dv, seed=tq + d + dv)
    want = _jax_flash(q, k, v, causal, grp)
    assert float(np.abs(want[..., dv:]).max(initial=0.0)) == 0.0
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_plain(tq_, tk_, tv_, causal)
    assert tuple(got.shape) == (h, tq, dv)
    np.testing.assert_allclose(_np(got), want[..., :dv], rtol=RTOL,
                               atol=ATOL)
    wrapped = ops.flash_attention(tq_, tk_, tv_, causal)
    assert torch.equal(wrapped, got)
    # the same function as V zero-padded to d, its first dv columns
    padded = ops.flash_attention(tq_, tk_, torch.nn.functional.pad(
        tv_, (0, d - dv)), causal)
    np.testing.assert_allclose(_np(padded[..., :dv]), _np(got), rtol=RTOL,
                               atol=ATOL)


def test_plain_flash_with_narrow_v_out_dtype_and_window():
    q, k, v = _qkv(48, 48, 2, 2, 192, 128, seed=5)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq_, tk_, tv_, True, window=7,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 48, 128)
    full = ops.flash_attention(tq_, tk_, torch.nn.functional.pad(
        tv_, (0, 64)), True, window=7)
    assert torch.equal(got, full[..., :128].bfloat16())


# --------------------------------------------------------------------------- #
# deepseek-v3's MLA flash route
# --------------------------------------------------------------------------- #
def _mla(seed):
    jcfg = dataclasses.replace(jget_smoke("deepseek-v3-671b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"),
                               dtype="float32")
    jp = JMLA.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    r = np.random.default_rng(seed)
    for name, n in (("q_norm", jcfg.q_lora), ("kv_norm", jcfg.kv_lora)):
        jp[name] = jnp.asarray(r.normal(0, 0.3, n), jnp.float32)
    return jcfg, tcfg, jp, {k: torch.from_numpy(np.array(v))
                            for k, v in jp.items()}


@pytest.fixture
def flash_widths(monkeypatch):
    """Records (q's head dim, v's head dim) of every flash call."""
    calls = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        calls.append((q.shape[-1], v.shape[-1]))
        return real(q, k, v, causal, window)
    monkeypatch.setattr(ops, "flash_attention", rec)
    return calls


def test_mla_flash_route_passes_v_unpadded_and_matches_jax(flash_widths):
    jcfg, tcfg, jp, tp = _mla(3)
    dqk, dv = tcfg.qk_nope + tcfg.qk_rope, tcfg.v_head_dim
    assert dv < dqk
    t = 24
    x = np.random.default_rng(4).normal(0, 1, (2, t, tcfg.d_model)).astype(
        np.float32)
    want = JMLA.mla_attention(jp, jcfg, jnp.asarray(x),
                              jnp.arange(t, dtype=jnp.int32))
    got = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x))
    assert flash_widths == [(dqk, dv)]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)


# --------------------------------------------------------------------------- #
# The gradient of _FlashAttention with dv < d
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tq,tk,grp,causal", [(20, 20, 1, True),
                                              (20, 20, 2, True),
                                              (12, 27, 2, False)])
def test_flash_function_gradient_with_narrow_v_matches_jax(
        monkeypatch, tq, tk, grp, causal):
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    h, d, dv = 4, 48, 24
    q, k, v = _qkv(tq, tk, h, grp, d, dv, seed=tq + tk + grp)
    do = np.random.default_rng(1).normal(0, 1, (h, tq, dv)).astype(
        np.float32)

    def jf(qq, kk, vv):
        kr, vr = (jnp.repeat(a, grp, axis=0) for a in (kk, vv))
        vp = jnp.pad(vr, ((0, 0), (0, 0), (0, d - dv)))
        o = jref.flash_attention_ref(*(a.transpose(1, 0, 2)
                                       for a in (qq, kr, vp)), causal=causal)
        return jnp.sum(o.transpose(1, 0, 2)[..., :dv] * jnp.asarray(do))
    jg = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = TA._FlashAttention.apply(*tt, causal, 0)
    assert tuple(o.shape) == (h, tq, dv)
    (o * torch.from_numpy(do)).sum().backward()
    for name, t_, j in zip("qkv", tt, jg):
        np.testing.assert_allclose(_np(t_.grad), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# --------------------------------------------------------------------------- #
# The meta route's cost and the wrapper's refusals
# --------------------------------------------------------------------------- #
def _meta_cost(bh, bkv, tq, tk, d, dv, causal, window, dtype, out_dtype):
    seen = []
    q = torch.empty(bh, tq, d, dtype=dtype, device="meta")
    k = torch.empty(bkv, tk, d, dtype=dtype, device="meta")
    v = torch.empty(bkv, tk, dv, dtype=dtype, device="meta")
    with ops.meta_costs(lambda *a: seen.append(a)):
        out = ops.flash_attention(q, k, v, causal, window,
                                  out_dtype=out_dtype)
    assert out.device.type == "meta" and out.dtype == out_dtype
    assert tuple(out.shape) == (bh, tq, dv)
    (name, flops, nbytes), = seen
    assert name == "flash_attention"
    return flops, nbytes


@pytest.mark.parametrize("bh,bkv,tq,tk,d,dv,causal,window", [
    (512, 512, 2048, 2048, 192, 128, True, 0),
    (64, 32, 2048, 2048, 240, 128, True, 1024),
    (8, 4, 100, 300, 96, 32, False, 0)])
def test_meta_cost_counts_v_at_its_own_width(bh, bkv, tq, tk, d, dv, causal,
                                             window):
    pairs = ops.flash_pairs(tq, tk, causal, window)
    for dt, ot in ((torch.bfloat16, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        e, eo = torch.empty(0, dtype=dt).element_size(), \
            torch.empty(0, dtype=ot).element_size()
        flops, nbytes = _meta_cost(bh, bkv, tq, tk, d, dv, causal, window,
                                   dt, ot)
        assert flops == 2.0 * (d + dv) * bh * pairs
        assert nbytes == e * (d * (bh * tq + bkv * tk) + dv * bkv * tk) \
            + eo * dv * bh * tq
        # dv = d: the figures every config's dry-run had before dv
        flops, nbytes = _meta_cost(bh, bkv, tq, tk, d, d, causal, window,
                                   dt, ot)
        assert flops == 4.0 * d * bh * pairs
        assert nbytes == e * d * (bh * tq + 2 * bkv * tk) + eo * d * bh * tq


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dv", [0, 65])
def test_wrapper_refuses_v_wider_than_d_or_empty(device, dv):
    q = torch.zeros(2, 8, 64, device=device)
    k = torch.zeros(2, 8, 64, device=device)
    v = torch.zeros(2, 8, dv, device=device)
    with pytest.raises(ValueError, match="v's head dim"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="k / v"):
        ops.flash_attention(q, k, torch.zeros(2, 9, 32, device=device))
