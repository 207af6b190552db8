"""llama-3.2-vision in the port (cross-attention blocks, the flash kernel's
non-causal mode with Tq != Tk, cross caches) against the JAX package on
the CPU, at smoke size in fp32.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``.  JAX runs cross-attention
in XLA (``_sdpa`` with no mask); the port sends it through
``ops.flash_attention(causal=False)``, here its plain version, and its
backward recomputes the plain function by query chunks.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import synthetic_batches as jbatches  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "llama-3.2-vision-11b"


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _cfg32(**kw):
    return (dataclasses.replace(jget_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                                **kw))


def _carried(jcfg, tcfg, seed=0):
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _vision(cfg, b, seed, s=None):
    return np.random.default_rng(seed).normal(
        0, 0.1, (b, s or cfg.n_vision_tokens, cfg.d_model)).astype(
            np.float32)


def _attn_params(r, d, h, kh, hd, kvd=None):
    p = {"wq": r.normal(0, d ** -0.5, (d, h, hd)),
         "wk": r.normal(0, d ** -0.5, (kvd or d, kh, hd)),
         "wv": r.normal(0, d ** -0.5, (kvd or d, kh, hd)),
         "wo": r.normal(0, (h * hd) ** -0.5, (h * hd, d))}
    return {n: a.astype(np.float32) for n, a in p.items()}


@contextlib.contextmanager
def _flash_calls():
    """Record each ``ops.flash_attention`` call's (causal, Tq, Tk)."""
    calls = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal, window)
    ops.flash_attention = rec
    try:
        yield calls
    finally:
        ops.flash_attention = real


# --------------------------------------------------------------------------- #
# Attention: cross and non-causal self through the flash route
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [4, 8, 1024])
def test_flash_noncausal_backward_matches_jax_grad(monkeypatch, chunk):
    # _FlashAttention with causal off and Tq != Tk (13 queries, 21 keys,
    # G = 2): its backward over query chunks of 4 and 8 (several chunks,
    # the last one ragged) and 1024 (one) against jax.grad of _sdpa with
    # nothing masked.
    monkeypatch.setattr(TA, "BWD_CHUNK", chunk)
    b, t, s, h, kh, hd = 2, 13, 21, 4, 2, 16
    r = np.random.default_rng(40 + chunk)
    q = r.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k, v = (r.normal(0, 1, (b, s, kh, hd)).astype(np.float32)
            for _ in range(2))
    w = r.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TA._flash(tq, tk, tv, causal=False)
    (o * torch.from_numpy(w)).sum().backward()

    def f(q, k, v):
        bias = jnp.zeros((t, s), jnp.float32)
        return jnp.sum(JA._sdpa(q, k, v, bias, hd ** -0.5) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    _close(o, JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.zeros((t, s)), hd ** -0.5))
    for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, exp)


@pytest.mark.parametrize("t,s", [(12, 16), (7, 30), (24, 5)])
def test_cross_attention_and_its_grads_match_jax(monkeypatch, t, s):
    # attention(kv_x=) with the xattn layout (no RoPE, no qk_norm, G = 2)
    # goes to the kernel once, non-causal, with Tq = T and Tk = S; output
    # and gradients in x, kv_x and every weight against jax.grad.
    monkeypatch.setattr(TA, "BWD_CHUNK", 5)
    d, h, kh, hd = 32, 4, 2, 8
    r = np.random.default_rng(t * 31 + s)
    p = _attn_params(r, d, h, kh, hd)
    x = r.normal(0, 1, (2, t, d)).astype(np.float32)
    src = r.normal(0, 1, (2, s, d)).astype(np.float32)
    w = r.normal(0, 1, (2, t, d)).astype(np.float32)
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    tx, tsrc = (torch.from_numpy(a).requires_grad_() for a in (x, src))
    with _flash_calls() as calls:
        out = TA.attention(tp, tx, kv_x=tsrc, causal=False, use_rope=False)
    assert calls == [(False, t, s)]
    (out * torch.from_numpy(w)).sum().backward()

    def f(p, x, src):
        o = JA.attention(p, x, jnp.arange(t, dtype=jnp.int32), kv_x=src,
                         causal=False, use_rope=False)
        return jnp.sum(o * w), o
    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        {n: jnp.asarray(a) for n, a in p.items()}, x, src)
    _close(out, want)
    _close(tx.grad, grads[1], err_msg="x")
    _close(tsrc.grad, grads[2], err_msg="kv_x")
    for n in p:
        _close(tp[n].grad, grads[0][n], err_msg=n)


def test_cross_attention_with_default_causal_is_not_masked():
    # JAX masks cross-attention by ``causal and kv_x is None``: a cross
    # call left at causal=True is still unmasked, in both packages.
    d, h, kh, hd, t, s = 16, 2, 1, 8, 6, 9
    r = np.random.default_rng(2)
    p = _attn_params(r, d, h, kh, hd)
    x = r.normal(0, 1, (1, t, d)).astype(np.float32)
    src = r.normal(0, 1, (1, s, d)).astype(np.float32)
    with _flash_calls() as calls:
        got = TA.attention({n: torch.from_numpy(a) for n, a in p.items()},
                           torch.from_numpy(x), kv_x=torch.from_numpy(src),
                           use_rope=False)
    assert calls == [(False, t, s)]
    want = JA.attention({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), jnp.arange(t, dtype=jnp.int32),
                        kv_x=jnp.asarray(src), use_rope=False)
    _close(got, want)


@pytest.mark.parametrize("g", [1, 2])
def test_noncausal_self_attention_and_its_grads_match_jax(monkeypatch, g):
    # whisper's encoder attention: non-causal, with RoPE; flash once.
    monkeypatch.setattr(TA, "BWD_CHUNK", 6)
    d, h, hd, t = 32, 4, 8, 17
    r = np.random.default_rng(7 + g)
    p = _attn_params(r, d, h, h // g, hd)
    x = r.normal(0, 1, (2, t, d)).astype(np.float32)
    w = r.normal(0, 1, (2, t, d)).astype(np.float32)
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    with _flash_calls() as calls:
        out = TA.attention(tp, tx, causal=False, rope_theta=1e4)
    assert calls == [(False, t, t)]
    (out * torch.from_numpy(w)).sum().backward()

    def f(p, x):
        o = JA.attention(p, x, jnp.arange(t, dtype=jnp.int32), causal=False,
                         rope_theta=1e4)
        return jnp.sum(o * w), o
    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {n: jnp.asarray(a) for n, a in p.items()}, x)
    _close(out, want)
    _close(tx.grad, grads[1], err_msg="x")
    for n in p:
        _close(tp[n].grad, grads[0][n], err_msg=n)


def test_noncausal_window_and_explicit_positions_take_sdpa():
    # The kernel takes a window only when causal, and default positions
    # only: these calls stay on _sdpa, and equal JAX's.
    d, h, hd, t = 16, 2, 8, 10
    r = np.random.default_rng(11)
    p = _attn_params(r, d, h, h, hd)
    x = r.normal(0, 1, (1, t, d)).astype(np.float32)
    pos = np.arange(3, 3 + t, dtype=np.int32)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    with _flash_calls() as calls:
        a = TA.attention(tp, torch.from_numpy(x), causal=False, window=3)
        b = TA.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         causal=False)
    assert calls == []
    _close(a, JA.attention(jp, jnp.asarray(x), jnp.arange(t), causal=False,
                           window=3))
    _close(b, JA.attention(jp, jnp.asarray(x), jnp.asarray(pos),
                           causal=False))


def test_fp32_source_under_bf16_weights_promotes_as_jax():
    # JAX's einsum promotes bf16 weights over an fp32 kv_x to fp32 K / V;
    # the port does too, runs the kernel's function on fp32 operands and
    # returns bf16 like JAX's _sdpa.
    d, h, kh, hd, t, s = 16, 2, 1, 8, 5, 7
    r = np.random.default_rng(5)
    p = _attn_params(r, d, h, kh, hd)
    x = r.normal(0, 1, (1, t, d)).astype(np.float32)
    src = r.normal(0, 1, (1, s, d)).astype(np.float32)
    tp = {n: torch.from_numpy(a).bfloat16() for n, a in p.items()}
    seen = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, causal, window)
    ops.flash_attention, was = rec, ops.flash_attention
    try:
        got = TA.attention(tp, torch.from_numpy(x).bfloat16(),
                           kv_x=torch.from_numpy(src), causal=False,
                           use_rope=False)
    finally:
        ops.flash_attention = was
    assert seen == [(torch.float32,) * 3] and got.dtype == torch.bfloat16
    want = JA.attention({n: jnp.asarray(a, jnp.bfloat16)
                         for n, a in p.items()},
                        jnp.asarray(x, jnp.bfloat16), jnp.arange(t),
                        kv_x=jnp.asarray(src), causal=False, use_rope=False)
    assert want.dtype == jnp.bfloat16
    _close(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_vision_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    cfg = get_config(ARCH)
    want = [s.cross_attn for sb, rep in jsegments(jget_config(ARCH))
            for _ in range(rep) for s in sb]
    assert [s.cross_attn for s in layer_specs(cfg)] == want
    assert sum(want) == 8 and want[4::5] == [True] * 8


def test_vision_forward_and_prefill_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 20)).astype(
        np.int32)
    vis = _vision(jcfg, 2, seed=4)
    want, _ = jm.forward(jp, jnp.asarray(toks), cross_kv_x=jnp.asarray(vis))
    with _flash_calls() as calls:
        got, aux = tm(torch.from_numpy(toks),
                      cross_kv_x=torch.from_numpy(vis))
    # 4 layers, the 2nd and 4th with a cross block over 16 vision tokens.
    assert calls == [(True, 20, 20), (True, 20, 20), (False, 20, 16),
                     (True, 20, 20), (True, 20, 20), (False, 20, 16)]
    assert got.shape == (2, 20, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    batch = {"tokens": toks, "vision": vis}
    last = TS.make_prefill_step(tm, tcfg)(
        tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(last, JS.make_prefill_step(jm, jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))


def _jax_filled(jm, jp, cache, src):
    """tests/test_models.py's fill of JAX's cross caches: ``src``
    projected through each cross block's xattn wk / wv."""
    out = []
    for (sb, rep), seg_p, seg_c in zip(jm.segments, jp["segments"], cache):
        blocks = []
        for spec, bp, c in zip(sb, seg_p, seg_c):
            if spec.cross_attn:
                def proj(pp):
                    return (jnp.einsum("bsd,dke->bske", src,
                                       pp["xattn"]["wk"]),
                            jnp.einsum("bsd,dke->bske", src,
                                       pp["xattn"]["wv"]))
                ks, vs = jax.vmap(proj)(bp)
                c = dict(c, xk=ks.astype(c["xk"].dtype),
                         xv=vs.astype(c["xv"].dtype))
            blocks.append(c)
        out.append(tuple(blocks))
    return out


def test_vision_decode_with_filled_cross_caches_matches_forward_and_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=0)
    b, t = 2, 12
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (b, t)).astype(
        np.int32)
    vis = _vision(jcfg, b, seed=1)
    fwd, _ = tm(torch.from_numpy(toks), cross_kv_x=torch.from_numpy(vis))
    jfwd, _ = jm.forward(jp, jnp.asarray(toks), cross_kv_x=jnp.asarray(vis))
    _close(fwd, jfwd)
    cache = tm.init_cache(b, t)
    held = [(lc["xk"], lc["xv"]) for lc in cache if "xk" in lc]
    assert [tuple(x.shape) for x, _ in held] == [(b, 16, 2, 16)] * 2
    assert all(float(x.abs().sum()) == 0 for pair in held for x in pair)
    tm.fill_cross_caches(cache, torch.from_numpy(vis))
    # written in place: the same tensors, now holding the projections
    assert all(lc["xk"] is x and lc["xv"] is v for lc, (x, v) in zip(
        [lc for lc in cache if "xk" in lc], held))
    jc = _jax_filled(jm, jp, jm.init_cache(b, t), jnp.asarray(vis))
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]),
                                   i)
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i))
        _close(lg, jlg)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - fwd).abs().max())
    assert err / (float(fwd.abs().max()) + 1e-9) < 2e-4


def test_vision_cross_len_and_zeroed_decode_match_jax():
    # init_cache's cross_len (JAX's default: n_vision_tokens) and serving
    # over zeroed cross caches, as JAX's launch.serve does.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=5)
    for cl in (None, 9):
        jc = jm.init_cache(2, 6, cross_len=cl)
        got = tm.init_cache(2, 6, cross_len=cl)
        want = [tuple(jc[0][b]["xk"].shape[1:]) for b in range(2)
                if "xk" in jc[0][b]]
        assert [tuple(lc["xk"].shape) for lc in got if "xk" in lc] == \
            want * 2
    cache, jc = tm.init_cache(2, 6), jm.init_cache(2, 6)
    tok = np.array([[3], [7]], np.int32)
    for i in range(6):
        lg, cache = tm.decode_step(cache, torch.from_numpy(tok), i)
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(i))
        _close(lg, jlg)


def _as_port(tcfg, tree):
    return convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray,
                                                            tree))


def _jax_loss_grads(jm, jcfg, jp, batch):
    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(batch["tokens"]),
                                 cross_kv_x=jnp.asarray(batch["vision"]))
        return (JL.softmax_xent(logits, jnp.asarray(batch["labels"]))
                + jcfg.router_aux_coef * aux)
    return jax.value_and_grad(lf)(jp)


def test_vision_loss_and_every_gradient_match_jax(monkeypatch):
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = next(jbatches(jcfg, 2, 20, seed=2))
    assert b["vision"].shape == (2, 16, 64)
    jl, jg = _jax_loss_grads(jm, jcfg, jp, b)
    tm, _ = TS.init_train_state(tm)
    tot, loss, aux, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tot, jl)
    _close(loss, jl)
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    assert any(".xattn.wk" in n for n in grads)
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_vision_train_steps_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=3)
    _, jopt = JS.init_train_state(jm, jax.random.PRNGKey(3))
    jstep = JS.make_train_step(jm, jcfg, base_lr=1.0)
    tm, topt = TS.init_train_state(tm)
    tstep = TS.make_train_step(tm, tcfg, base_lr=1.0)
    jit = jbatches(jcfg, 2, 16, seed=4)
    tit = synthetic_batches(tcfg, 2, 16, seed=4)
    for i in range(3):
        jb, tb = next(jit), next(tit)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        jp, jopt, jmet = jstep(jp, jopt, {k: jnp.asarray(v)
                                          for k, v in jb.items()})
        tm, topt, tmet = tstep(tm, topt, {k: torch.from_numpy(v)
                                          for k, v in tb.items()})
        _close(tmet["loss"], jmet["loss"])
    for tree, got in ((jp, dict(tm.named_parameters())), (jopt.mu, topt.mu),
                      (jopt.nu, topt.nu)):
        want = _as_port(tcfg, tree)
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name], err_msg=name)


def test_vision_remat_policies_give_equal_loss_and_grads(monkeypatch):
    # cfg.remat per superblock repeat, cross_kv_x passed to the checkpoint
    # as an argument: "full" and "dots" against "none", loss and every
    # gradient (the vision input's too), and JAX's "full".
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    jcfg, tcfg = _cfg32(remat="full")
    jm, jp, tm = _carried(jcfg, tcfg, seed=6)
    b = next(jbatches(jcfg, 2, 12, seed=7))
    tm, _ = TS.init_train_state(tm)
    named = dict(tm.named_parameters())
    got = {}
    for policy in ("none", "full", "dots"):
        tm.cfg = dataclasses.replace(tcfg, remat=policy)
        vis = torch.from_numpy(b["vision"]).requires_grad_()
        logits, _ = tm(torch.from_numpy(b["tokens"]), cross_kv_x=vis)
        loss = TS.softmax_xent(logits, torch.from_numpy(b["labels"]))
        grads = torch.autograd.grad(loss, list(named.values()) + [vis])
        got[policy] = (loss, grads)
    for policy in ("full", "dots"):
        assert torch.equal(got[policy][0], got["none"][0])
        for g, g0 in zip(got[policy][1], got["none"][1]):
            assert torch.equal(g, g0)
    jl, jg = _jax_loss_grads(jm, jcfg, jp, b)
    _close(got["full"][0], jl)
    want = _as_port(tcfg, jg)
    for name, g in zip(named, got["full"][1]):
        _close(g, want[name], err_msg=name)


def test_vision_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JS.build_model(jget_config(ARCH)).param_specs())
    assert got == want
    assert len(got) == 3 + 40 * 9 + 8 * 5
    assert got["layers.4.xattn.wk"] == (4096, 8, 128)
    assert "layers.3.ln_x" not in got and "layers.39.ln_x" in got
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    assert mats == cfg.n_params() == 10_110_369_792


def test_vision_launch_serve_generates_jax_tokens(monkeypatch):
    # Both launch.serve mains decode over zeroed cross caches of
    # n_vision_tokens slots.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "5",
                            "--gen", "4"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={ARCH} requests=3 prompt=5 gen=4"
    got = [eval(s) for s in lines[3:]]
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (3, 5)).astype(np.int32))
    cache = jm.init_cache(3, 9)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp, prompts, cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, want = last, [np.asarray(last)]
    for i in range(3):
        tok, cache = serve(jp, cache, tok, jnp.int32(5 + i))
        want.append(np.asarray(tok))
    assert got == np.concatenate(want, axis=1).tolist()


def test_vision_launch_train_logs_jax_losses(monkeypatch):
    # The plain path (vision batches) and JAX's error-feedback path, whose
    # forward reads batch["tokens"] alone: the cross blocks then attend to
    # their own input, in both packages.
    jcfg, tcfg = _cfg32()
    jp = JS.build_model(jcfg).init_params(jax.random.PRNGKey(0))
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "12", "--log-every", "1", "--lr", "0.05"]

    def port_model(cfg, device, seed):
        tm = TS.build_model(cfg, device=device, seed=seed)
        tm.load_state_dict(_as_port(cfg, jp))
        return tm
    monkeypatch.setattr(ttrain, "build_model", port_model)

    def losses(text):
        return [float(x) for x in re.findall(r"loss\s+([-\d.]+)", text)]
    for extra in ([], ["--compress-grads"]):
        out_t, out_j = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_t):
            assert ttrain.main(argv + extra + ["--device", "cpu"]) == 0
        with contextlib.redirect_stdout(out_j):
            assert jtrain.main(argv + extra) == 0
        lt, lj = losses(out_t.getvalue()), losses(out_j.getvalue())
        assert len(lt) == len(lj) == 4
        np.testing.assert_allclose(lt, lj, atol=2e-4)


def test_vision_builds_and_trains_through_the_steps():
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tm = TS.build_model(cfg, device="cpu")
    assert sum(s.cross_attn for s in tm.specs) == 2
    tm, opt = TS.init_train_state(tm)
    step = TS.make_train_step(tm, cfg)
    b = next(synthetic_batches(cfg, 2, 8, seed=0))
    tm, opt, met = step(tm, opt, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    assert np.isfinite(float(met["loss"])) and int(opt.step) == 1
    serve = TS.make_serve_step(tm, cfg)
    nxt, _ = serve(tm, tm.init_cache(2, 4), torch.zeros(2, 1,
                                                         dtype=torch.int32),
                   0)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
