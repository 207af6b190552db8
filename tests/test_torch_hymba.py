"""hymba-1.5b in the port (windowed GQA attention beside parallel SSM
heads, the SSM's fp32 state cache) against the JAX package on the CPU, at
smoke size in fp32.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``.  JAX runs the SSM's scans
in XLA (``lax.scan`` over chunks; ``associative_scan`` inside one for
``ssm_impl="assoc"``); the port loops over chunks (SSD) or steps (assoc)
in torch.  The attention half goes through ``ops.flash_attention``, here
its plain version.
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
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "hymba-1.5b"


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


# --------------------------------------------------------------------------- #
# The SSM module
# --------------------------------------------------------------------------- #
D, H, P, N = 32, 4, 8, 4          # d_model, SSM heads, head dim, state


def _ssm_params(seed):
    """JAX's ``ssm_init`` in fp32, with dt_bias, A_log and D drawn from
    numpy so that every head decays at its own rate."""
    p = JSSM.ssm_init(jax.random.PRNGKey(seed), D, H, P, N, jnp.float32)
    r = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["dt_bias"] = r.normal(0, 0.5, H).astype(np.float32)
    p["A_log"] = r.normal(0, 0.5, H).astype(np.float32)
    p["D"] = r.normal(0, 0.3, H).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(b, t, seed):
    # At unit-variance inputs the outputs reach about 45 (y is cubic in x)
    # and both packages' fp32 SSD sits ~1e-4 from a float64 evaluation (the
    # 256-term chunk sums), past atol 2e-5 for small elements; at 0.3 the
    # outputs stay near unit scale, where the tolerance holds rounding.
    return np.random.default_rng(seed).normal(0, 0.3, (b, t, D)).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["ssd", "assoc"])
@pytest.mark.parametrize("t", [512, 300])
def test_ssm_scans_match_jax(impl, t):
    # T = 512: two chunks of 256 (the state carried across the boundary);
    # T = 300: one ragged chunk of 300.
    jp, tp = _ssm_params(t)
    x = _x(2, t, t + 1)
    jfn, tfn = ((JSSM.ssm_scan_ssd, TSSM.ssm_scan_ssd) if impl == "ssd"
                else (JSSM.ssm_scan, TSSM.ssm_scan))
    want = jfn(jp, jnp.asarray(x), N)
    got = tfn(tp, torch.from_numpy(x), N)
    assert got.shape == (2, t, D) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("t", [512, 300])
def test_ssm_decode_steps_match_jax_and_the_scan_in_place(t):
    jp, tp = _ssm_params(7)
    x = _x(2, t, 8)
    h = TSSM.ssm_decode_init(2, H, P, N)
    ptr, jh = h.data_ptr(), JSSM.ssm_decode_init(2, H, P, N)
    outs = []
    for i in range(t):
        y, h2 = TSSM.ssm_decode_step(tp, torch.from_numpy(x[:, i:i + 1]), h,
                                     N)
        jy, jh = JSSM.ssm_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jh, N)
        assert h2 is h and h.data_ptr() == ptr and h.dtype == torch.float32
        if i % 37 == 0 or i == t - 1:
            _close(y, jy)
            _close(h, jh)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1),
           JSSM.ssm_scan_ssd(jp, jnp.asarray(x), N))


def test_ssm_init_leaves_match_jax_in_bf16():
    want = JSSM.ssm_init(jax.random.PRNGKey(0), D, H, P, N, jnp.bfloat16)
    got = TSSM.ssm_init(torch.Generator().manual_seed(0), D, H, P, N,
                        torch.bfloat16)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    for k in ("dt_bias", "A_log", "D"):
        _close(got[k], want[k], rtol=0, atol=0, err_msg=k)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_hymba_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    specs = layer_specs(get_config(ARCH))
    want = [s for sb, rep in jsegments(jget_config(ARCH))
            for _ in range(rep) for s in sb]
    assert [(s.attn, s.ffn, s.window) for s in specs] == \
        [(s.attn, s.ffn, s.window) for s in want] == [("hymba", "dense",
                                                       2048)] * 32


@pytest.mark.parametrize("impl", ["ssd", "assoc"])
def test_hymba_forward_and_prefill_match_jax(monkeypatch, impl):
    # Each layer's attention is one causal flash call under the window.
    jcfg, tcfg = _cfg32(ssm_impl=impl)
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    toks = _tokens(jcfg, (2, 20), 3)           # 20 > the window of 8
    calls = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        calls.append((causal, window, q.shape[0] // k.shape[0]))
        return real(q, k, v, causal, window)
    monkeypatch.setattr(ops, "flash_attention", rec)
    got, aux = tm(torch.from_numpy(toks))
    assert calls == [(True, 8, 1)] * jcfg.n_layers
    want, _ = jm.forward(jp, jnp.asarray(toks))
    assert got.shape == (2, 20, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))


def test_hymba_decode_matches_forward_and_jax_past_the_window():
    # 14 positions over rings of 8 slots; every cache tensor (k, v and the
    # fp32 SSM state) is written in place.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=0)
    b, t = 2, 14
    toks = _tokens(jcfg, (b, t), 1)
    fwd, _ = tm(torch.from_numpy(toks))
    cache, jc = tm.init_cache(b, t), jm.init_cache(b, t)
    ptrs = [{k: v.data_ptr() for k, v in lc.items()} for lc in cache]
    outs = []
    for i in range(t):
        lg, cache2 = tm.decode_step(cache, torch.from_numpy(
            toks[:, i:i + 1]), i)
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i))
        assert cache2 is cache
        assert [{k: v.data_ptr() for k, v in lc.items()}
                for lc in cache] == ptrs
        _close(lg, jlg)
        outs.append(lg[:, 0])
    for r, lc in enumerate(cache):             # one segment of 1 x 2
        _close(lc["ssm"], jc[0][0]["ssm"][r])
        _close(lc["k"], jc[0][0]["k"][r])
    err = float((torch.stack(outs, 1) - fwd).abs().max())
    assert err / float(fwd.abs().max()) < 2e-4


def test_hymba_cache_shapes_match_jax():
    jcfg, tcfg = _cfg32()
    for seq in (5, 8, 30):                     # below, at and past window 8
        jc = JDecoderLM(jcfg).init_cache(2, seq)
        got = TS.build_model(tcfg, device="meta").init_cache(2, seq)
        for i, lc in enumerate(got):
            want = jc[0][0]
            assert lc.keys() == want.keys() == {"k", "v", "ssm"}
            for k in lc:
                assert tuple(lc[k].shape) == want[k].shape[1:], (i, k)
                assert str(lc[k].dtype).split(".")[-1] == str(
                    want[k].dtype), (i, k)
    assert tuple(got[0]["ssm"].shape) == (2, 5, 16, 16)


def test_hymba_loss_and_every_gradient_match_jax():
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
    assert any(".ssm." in n for n in grads)
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_hymba_train_steps_match_jax():
    # Three steps at base lr 1 (lr 0, 0.01, 0.02): each loss, then params,
    # mu and nu.
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
def test_hymba_remat_policies_give_none_s_loss_and_grads(policy):
    # A checkpoint spans one hymba layer; the SSD chunk loop recomputes in
    # the backward.
    _, tcfg = _cfg32()
    tm, _ = TS.init_train_state(TS.build_model(tcfg, device="cpu", seed=5))
    b = {k: torch.from_numpy(v)
         for k, v in next(synthetic_batches(tcfg, 2, 20, seed=6)).items()}
    _, loss0, _, g0 = TS.value_and_grad(tm, tcfg, b)
    tm.cfg = dataclasses.replace(tcfg, remat=policy)
    _, loss1, _, g1 = TS.value_and_grad(tm, tm.cfg, b)
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_hymba_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config(ARCH)).param_specs())
    assert got == want and len(got) == 3 + cfg.n_layers * 16
    assert got["layers.0.ssm.w_in"] == (1600, 25, 64)
    assert got["layers.31.ssm.w_bc"] == (1600, 32)
    assert sum(p.numel() for p in tm.parameters()) == 1_311_290_400


def test_hymba_bf16_parameter_dtypes_match_jax_leaves():
    # dt_bias, A_log and D stay fp32 in a bf16 model, as JAX's leaves.
    jcfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    assert tcfg.dtype == "bfloat16"
    jp = JDecoderLM(jcfg).init_params(jax.random.PRNGKey(0))
    want = {n: str(leaf.dtype) for n, leaf, _ in
            convert._lm_leaves(tcfg, jp)}
    tm = TS.build_model(tcfg, device="cpu")
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want
    assert {n.split(".")[-1] for n, d in got.items() if d == "float32"} == \
        {"dt_bias", "A_log", "D"}
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    leaves = {n: np.asarray(leaf if r is None else leaf[r], np.float32)
              for n, leaf, r in convert._lm_leaves(tcfg, jp)}
    for n, p in tm.named_parameters():
        if p.dtype == torch.float32:
            _close(p, leaves[n], rtol=0, atol=0, err_msg=n)


def test_hymba_launch_serve_generates_jax_tokens(monkeypatch):
    # 7 prompt tokens and 5 generated: 12 positions wrap the rings of 8.
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


def test_hymba_launch_train_logs_jax_losses(monkeypatch):
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
    assert len(lt) == len(lj) == 4            # 3 steps and the last line
    np.testing.assert_allclose(lt, lj, atol=2e-4)
    assert "done: 3 steps" in out_t.getvalue()
