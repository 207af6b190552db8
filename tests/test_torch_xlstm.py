"""xlstm-125m in the port (mLSTM and sLSTM blocks without FFNs, fp32 gate
leaves in a bf16 model, the -1e30 stabilizer, in-place state caches)
against the JAX package on the CPU, at smoke size in fp32.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``.  JAX runs the mLSTM's
stabilizer as an associative scan and the sLSTM as ``lax.scan``; the port
uses ``cummax`` and a loop over T.  No flash kernel is on this path.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models import xlstm_blocks as JXL  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models import xlstm_blocks as TXL  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "xlstm-125m"
D, H = 32, 4                      # d_model, heads of the block tests


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


def _as_port(tcfg, tree):
    return convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray,
                                                            tree))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _pair(p):
    """A JAX param dict and its torch twin (copies)."""
    p = {k: np.array(v) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(b, t, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, t, D)).astype(
        np.float32)


def _mlstm(seed):
    return _pair(JXL.mlstm_init(jax.random.PRNGKey(seed), D, H,
                                jnp.float32))


def _slstm(seed, r_std=0.3):
    # r_z drawn larger than init's 0.02 so that the recurrence on h moves
    # the output well past the tolerance (a transposed r_z must fail).
    p = JXL.slstm_init(jax.random.PRNGKey(seed), D, H, jnp.float32)
    p = {k: np.array(v) for k, v in p.items()}
    p["r_z"] = np.random.default_rng(seed).normal(
        0, r_std, p["r_z"].shape).astype(np.float32)
    return _pair(p)


# --------------------------------------------------------------------------- #
# The blocks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [512, 100])
def test_mlstm_scan_matches_jax(t):
    # T = 512: two query chunks of 256; T = 100: one.
    jp, tp = _mlstm(t)
    x = _x(2, t, t + 1)
    got = TXL.mlstm_scan(tp, torch.from_numpy(x))
    assert got.shape == (2, t, D)
    _close(got, JXL.mlstm_scan(jp, jnp.asarray(x)))


@pytest.mark.parametrize("t", [512, 100])
def test_mlstm_decode_steps_match_jax_and_the_scan_in_place(t):
    jp, tp = _mlstm(3)
    x = _x(2, t, 4)
    dh = 2 * D // H
    st = TXL.mlstm_decode_init(2, H, dh)
    assert float(st["m"].max()) == float(np.float32(-1e30))
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    jst = JXL.mlstm_decode_init(2, H, dh)
    outs = []
    for i in range(t):
        y, st2 = TXL.mlstm_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                       st)
        jy, jst = JXL.mlstm_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jst)
        assert st2 is st and {k: v.data_ptr() for k, v in st.items()} == ptrs
        if i % 23 == 0 or i == t - 1:
            _close(y, jy)
            for k in st:
                _close(st[k], jst[k], err_msg=k)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), JXL.mlstm_scan(jp, jnp.asarray(x)))


def test_mlstm_gradient_is_finite_where_jax_s_is_nan():
    # A forget bias of -3 makes F fall ~3 a step, so a later key's logD
    # passes exp's range within 40 steps.  Both forwards agree; JAX's
    # where(mask, exp(logD), 0) gives a NaN gradient, the port masks logD
    # before the exp.  At init's bias of 3 (below) both agree.
    t = 64
    x = _x(1, t, 9)
    for bias, finite_in_jax in ((-3.0, False), (3.0, True)):
        jp, tp = _mlstm(5)
        jp["f_bias"] = jnp.full((H,), bias, jnp.float32)
        tp["f_bias"] = torch.full((H,), bias)
        _close(TXL.mlstm_scan(tp, torch.from_numpy(x)),
               JXL.mlstm_scan(jp, jnp.asarray(x)))
        jg = jax.grad(lambda p: jnp.sum(JXL.mlstm_scan(
            p, jnp.asarray(x))))(jp)
        tp = {k: v.requires_grad_() for k, v in tp.items()}
        TXL.mlstm_scan(tp, torch.from_numpy(x)).sum().backward()
        assert all(bool(torch.isfinite(v.grad).all()) for v in tp.values())
        assert all(bool(jnp.isfinite(v).all())
                   for v in jg.values()) == finite_in_jax
        if finite_in_jax:
            for k in jg:
                _close(tp[k].grad, jg[k], err_msg=k)


@pytest.mark.parametrize("t", [100, 37])
def test_slstm_scan_matches_jax(t):
    jp, tp = _slstm(t)
    x = _x(2, t, t + 2)
    got = TXL.slstm_scan(tp, torch.from_numpy(x))
    assert got.shape == (2, t, D)
    _close(got, JXL.slstm_scan(jp, jnp.asarray(x)))


def test_slstm_tolerance_tells_gelu_and_r_z_layout_apart(monkeypatch):
    # The comparison above fails for exact GELU and for r_z read as [H, dh,
    # dh] (its transpose per head): each changes the output past it.
    jp, tp = _slstm(11)
    x = torch.from_numpy(_x(2, 60, 12))
    want = _np(JXL.slstm_scan(jp, jnp.asarray(x.numpy())))
    _close(TXL.slstm_scan(tp, x), want)
    flipped = dict(tp, r_z=tp["r_z"].permute(2, 1, 0).contiguous())
    with pytest.raises(AssertionError):
        _close(TXL.slstm_scan(flipped, x), want)
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(TXL.F, "gelu", lambda u, approximate="none": gelu(u))
    with pytest.raises(AssertionError):
        _close(TXL.slstm_scan(tp, x), want)


@pytest.mark.parametrize("t", [100, 37])
def test_slstm_decode_steps_match_jax_and_the_scan_in_place(t):
    jp, tp = _slstm(6)
    x = _x(2, t, 7)
    st = TXL.slstm_decode_init(2, H, D // H)
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    jst = JXL.slstm_decode_init(2, H, D // H)
    outs = []
    for i in range(t):
        y, st2 = TXL.slstm_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                       st)
        jy, jst = JXL.slstm_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jst)
        assert st2 is st and {k: v.data_ptr() for k, v in st.items()} == ptrs
        if i % 9 == 0 or i == t - 1:
            _close(y, jy)
            for k in st:
                _close(st[k], jst[k], err_msg=k)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), JXL.slstm_scan(jp, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_init_leaves_match_jax_in_bf16(kind):
    jinit, tinit = ((JXL.mlstm_init, TXL.mlstm_init) if kind == "mlstm"
                    else (JXL.slstm_init, TXL.slstm_init))
    want = jinit(jax.random.PRNGKey(0), 768, 4, jnp.bfloat16)
    got = tinit(torch.Generator().manual_seed(0), 768, 4, torch.bfloat16)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    _close(got["f_bias"], want["f_bias"], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_xlstm_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    specs = layer_specs(get_config(ARCH))
    want = [s for sb, rep in jsegments(jget_config(ARCH))
            for _ in range(rep) for s in sb]
    assert [(s.attn, s.ffn) for s in specs] == \
        [(s.attn, s.ffn) for s in want] == [("mlstm", "none"),
                                            ("slstm", "none")] * 6


def test_xlstm_forward_and_prefill_match_jax(monkeypatch):
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    toks = _tokens(jcfg, (2, 20), 3)
    calls = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(a))
    got, aux = tm(torch.from_numpy(toks))
    assert calls == []                           # no attention on the path
    want, _ = jm.forward(jp, jnp.asarray(toks))
    assert got.shape == (2, 20, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))


def test_xlstm_decode_matches_forward_and_jax_in_place():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=0)
    b, t = 2, 16
    toks = _tokens(jcfg, (b, t), 1)
    fwd, _ = tm(torch.from_numpy(toks))
    cache, jc = tm.init_cache(b, t), jm.init_cache(b, t)
    ptrs = [{k: v.data_ptr() for k, v in lc.items()} for lc in cache]
    for i in range(t):
        lg, cache2 = tm.decode_step(cache, torch.from_numpy(
            toks[:, i:i + 1]), i)
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i))
        assert cache2 is cache
        assert [{k: v.data_ptr() for k, v in lc.items()}
                for lc in cache] == ptrs
        _close(lg, jlg)
        _close(lg[:, 0], fwd[:, i])
    for i, lc in enumerate(cache):             # layer i: repeat i // 2
        want = jc[0][i % 2]
        for k in lc:
            _close(lc[k], want[k][i // 2], err_msg=f"{i} {k}")


def test_xlstm_cache_shapes_and_stabilizer_match_jax():
    jcfg, tcfg = _cfg32()
    jc = JDecoderLM(jcfg).init_cache(3, 10)
    got = TS.build_model(tcfg, device="cpu").init_cache(3, 10)
    assert [set(lc) for lc in got] == [{"C", "n", "m"},
                                       {"c", "n", "h", "m"}] * 2
    for i, lc in enumerate(got):
        want = jc[0][i % 2]
        for k in lc:
            assert lc[k].dtype == torch.float32, (i, k)
            _close(lc[k], want[k][i // 2], rtol=0, atol=0,
                   err_msg=f"{i} {k}")
    assert tuple(got[0]["C"].shape) == (3, 4, 32, 32)
    assert tuple(got[1]["h"].shape) == (3, 4, 16)
    assert float(got[1]["m"].max()) == float(np.float32(-1e30))


def test_xlstm_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = next(jbatches(jcfg, 2, 20, seed=2))

    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(b["tokens"]))
        return (JL.softmax_xent(logits, jnp.asarray(b["labels"]))
                + jcfg.router_aux_coef * aux)
    jl, jg = jax.value_and_grad(lf)(jp)
    tm, _ = TS.init_train_state(tm)
    tot, loss, aux, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tot, jl)
    _close(loss, jl)
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    assert "head" not in grads                  # tied to the embedding
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_xlstm_train_steps_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=3)
    _, jopt = JS.init_train_state(jm, jax.random.PRNGKey(3))
    jstep = JS.make_train_step(jm, jcfg, base_lr=1.0)
    tm, topt = TS.init_train_state(tm)
    tstep = TS.make_train_step(tm, tcfg, base_lr=1.0)
    jit = jbatches(jcfg, 2, 16, seed=4)
    tit = synthetic_batches(tcfg, 2, 16, seed=4)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
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


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_xlstm_remat_policies_give_none_s_loss_and_grads(policy):
    # A checkpoint spans one (mLSTM, sLSTM) pair; the sLSTM's loop runs
    # again in the backward.
    _, tcfg = _cfg32()
    tm, _ = TS.init_train_state(TS.build_model(tcfg, device="cpu", seed=5))
    assert len(tm.repeats) == 2 and tm.repeats[0] == (0, 2)
    b = {k: torch.from_numpy(v)
         for k, v in next(synthetic_batches(tcfg, 2, 20, seed=6)).items()}
    _, loss0, _, g0 = TS.value_and_grad(tm, tcfg, b)
    tm.cfg = dataclasses.replace(tcfg, remat=policy)
    _, loss1, _, g1 = TS.value_and_grad(tm, tm.cfg, b)
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_xlstm_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config(ARCH)).param_specs())
    assert got == want and len(got) == 2 + 6 * (9 + 9)
    assert got["layers.0.core.w_q"] == (1536, 4, 384)
    assert got["layers.1.core.r_z"] == (192, 4, 192)
    assert got["layers.1.core.w_up"] == (768, 1024)
    assert sum(p.numel() for p in tm.parameters()) == 112_777_008


def test_xlstm_bf16_parameter_dtypes_match_jax_leaves():
    # w_i, w_f, f_bias and the sLSTM's r_z stay fp32 in a bf16 model, as
    # JAX's leaves; loading JAX's values keeps them exact.
    jcfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    assert tcfg.dtype == "bfloat16"
    jp = JDecoderLM(jcfg).init_params(jax.random.PRNGKey(0))
    want = {n: str(leaf.dtype) for n, leaf, _ in
            convert._lm_leaves(tcfg, jp)}
    tm = TS.build_model(tcfg, device="cpu")
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want
    assert {n.split(".")[-1] for n, d in got.items() if d == "float32"} == \
        {"w_i", "w_f", "f_bias", "r_z"}
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    leaves = {n: np.asarray(leaf if r is None else leaf[r], np.float32)
              for n, leaf, r in convert._lm_leaves(tcfg, jp)}
    for n, p in tm.named_parameters():
        if p.dtype == torch.float32:
            _close(p, leaves[n], rtol=0, atol=0, err_msg=n)


def test_xlstm_bf16_forward_promotes_gates_as_jax():
    # The bf16 smoke model against JAX's bf16 model on the same weights:
    # the gates' products run in fp32 in both (bf16 rounding, so a bf16
    # tolerance on the logits).
    jcfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jm, jp, tm = _carried(jcfg, tcfg, seed=7)
    toks = _tokens(jcfg, (2, 12), 8)
    got, _ = tm(torch.from_numpy(toks))
    want, _ = jm.forward(jp, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    g, w = _np(got), _np(want)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2


def test_xlstm_bf16_train_state_checkpoint_round_trip(tmp_path):
    # Two bf16 steps, then save / restore onto a fresh model: the fp32
    # leaves come back fp32 and every tensor bit for bit.
    tcfg = get_smoke_config(ARCH)
    tm, opt = TS.init_train_state(TS.build_model(tcfg, device="cpu", seed=1))
    step = TS.make_train_step(tm, tcfg, base_lr=1.0)
    for s in (1, 2):
        b = next(synthetic_batches(tcfg, 2, 16, seed=s))
        tm, opt, _ = step(tm, opt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    save(str(tmp_path), 2, (tm, opt))
    fresh, fopt = TS.init_train_state(TS.build_model(tcfg, device="cpu",
                                                     seed=2))
    (fresh, fopt), s, _ = restore(str(tmp_path), (fresh, fopt))
    assert s == 2 and int(fopt.step) == 2
    assert fresh.layers[1].core["r_z"].dtype == torch.float32
    assert fresh.layers[1].core["w_z"].dtype == torch.bfloat16
    for (n, a), b in zip(tm.state_dict().items(),
                         fresh.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for n in opt.mu:
        assert torch.equal(opt.mu[n], fopt.mu[n])
        assert torch.equal(opt.nu[n], fopt.nu[n])
        assert torch.equal(opt.master[n], fopt.master[n])


def test_xlstm_launch_serve_generates_jax_tokens(monkeypatch):
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "7",
                            "--gen", "5"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={ARCH} requests=3 prompt=7 gen=5"
    got = [eval(s) for s in lines[3:]]
    prompts = jnp.asarray(_tokens(jcfg, (3, 7), 0))
    cache = jm.init_cache(3, 12)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp, prompts, cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, want = last, [np.asarray(last)]
    for i in range(4):
        tok, cache = serve(jp, cache, tok, jnp.int32(7 + i))
        want.append(np.asarray(tok))
    assert got == np.concatenate(want, axis=1).tolist()


def test_xlstm_launch_train_logs_jax_losses(monkeypatch):
    jcfg, tcfg = _cfg32()
    jp = JS.build_model(jcfg).init_params(jax.random.PRNGKey(0))
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--lr", "0.05"]

    def port_model(cfg, device, seed):
        tm = TS.build_model(cfg, device=device, seed=seed)
        tm.load_state_dict(_as_port(cfg, jp))
        return tm
    monkeypatch.setattr(ttrain, "build_model", port_model)

    def losses(text):
        return [float(x) for x in re.findall(r"loss\s+([-\d.]+)", text)]
    out_t, out_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_t):
        assert ttrain.main(argv + ["--device", "cpu"]) == 0
    with contextlib.redirect_stdout(out_j):
        assert jtrain.main(argv) == 0
    lt, lj = losses(out_t.getvalue()), losses(out_j.getvalue())
    assert len(lt) == len(lj) == 4
    np.testing.assert_allclose(lt, lj, atol=2e-4)
    assert "done: 3 steps" in out_t.getvalue()
