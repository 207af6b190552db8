"""MLA attention in the port (``repro_torch.models.mla``) and deepseek-v3,
its model (MLA in every layer, a MoE FFN after three dense layers),
against the JAX package on the CPU, in fp32.

Inputs are made with numpy from a seed and handed to both packages; MLA
parameters and model weights are JAX's ``mla_init`` / ``init_params``
carried over by ``repro_torch.convert``.  The port's flash route is
``ops.flash_attention`` on ``[q_nope | q_rope]``, ``[k_nope | k_rope]``
and V padded to the same head dim, here the kernel's plain version;
JAX's ``mla_attention`` computes the two score terms apart.
"""
import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import synthetic_batches as jbatches  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_replay import _StandInGraph  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "deepseek-v3-671b"


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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _as_port(tcfg, tree):
    return convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray,
                                                            tree))


def _carried(jcfg, tcfg, seed=0):
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(_as_port(tcfg, jp))
    return jm, jp, tm


def _mla_params(seed, **kw):
    jcfg, tcfg = _cfg32(**kw)
    jp = JMLA.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # Norm scales drawn from numpy, so that the norms scale each channel.
    r = np.random.default_rng(seed)
    for name, n in (("q_norm", jcfg.q_lora), ("kv_norm", jcfg.kv_lora)):
        jp[name] = jnp.asarray(r.normal(0, 0.3, n), jnp.float32)
    return jcfg, tcfg, jp, {k: torch.from_numpy(np.array(v))
                            for k, v in jp.items()}


@pytest.fixture
def flash_calls(monkeypatch):
    """Records (causal, window, G, d) of every ``ops.flash_attention``."""
    calls = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        calls.append((causal, window, q.shape[0] // k.shape[0], q.shape[-1]))
        return real(q, k, v, causal, window)
    monkeypatch.setattr(ops, "flash_attention", rec)
    return calls


# --------------------------------------------------------------------------- #
# The module
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t,chunk", [(24, 0), (32, 8)])
def test_mla_attention_routes_match_jax(flash_calls, t, chunk):
    # Default positions: one flash call at d = qk_nope + qk_rope = 24 (V of
    # 16 padded); explicit positions: _sdpa_chunked, in chunks of 8 when
    # 8 divides T, as JAX's query-chunked form.
    jcfg, tcfg, jp, tp = _mla_params(t)
    x = np.random.default_rng(t + 1).normal(0, 1, (2, t, 64)).astype(
        np.float32)
    want = JMLA.mla_attention(jp, jcfg, jnp.asarray(x),
                              jnp.arange(t, dtype=jnp.int32), chunk=chunk)
    got = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x), chunk=chunk)
    assert flash_calls == [(True, 0, 1, 24)]
    _close(got, want)
    pos = torch.arange(t, dtype=torch.int32)
    _close(TMLA.mla_attention(tp, tcfg, torch.from_numpy(x), pos,
                              chunk=chunk), want)
    assert len(flash_calls) == 1


def test_mla_absorbed_decode_matches_jax_and_the_forward_in_place():
    jcfg, tcfg, jp, tp = _mla_params(5)
    b, t = 2, 12
    x = np.random.default_rng(6).normal(0, 1, (b, t, 64)).astype(np.float32)
    fwd = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x))
    cache = TMLA.mla_cache_init(b, t, tcfg, torch.float32)
    jc = JMLA.mla_cache_init(b, t, jcfg, jnp.float32)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jc.items()} == {"c": (b, t, 16),
                                               "k_rope": (b, t, 8)}
    for i in range(t):
        xi = x[:, i:i + 1]
        pos = i if i % 2 else torch.tensor(i)      # an int or a tensor
        got, cache2 = TMLA.mla_decode_step(tp, tcfg, torch.from_numpy(xi),
                                           cache, pos)
        want, jc = JMLA.mla_decode_step(jp, jcfg, jnp.asarray(xi), jc,
                                        jnp.int32(i))
        assert cache2 is cache
        assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
        _close(got, want, err_msg=str(i))
        _close(got[:, 0], fwd[:, i], err_msg=str(i))
    _close(cache["c"], jc["c"])
    _close(cache["k_rope"], jc["k_rope"])


def test_mla_needs_v_no_wider_than_the_query_head():
    _, tcfg, _, tp = _mla_params(1)
    with pytest.raises(ValueError, match="wider"):
        TMLA.mla_attention(tp, dataclasses.replace(tcfg, v_head_dim=32),
                           torch.zeros(1, 4, 64))


# --------------------------------------------------------------------------- #
# deepseek-v3
# --------------------------------------------------------------------------- #
def test_deepseek_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    specs = layer_specs(get_config(ARCH))
    want = [s for sb, rep in jsegments(jget_config(ARCH))
            for _ in range(rep) for s in sb]
    assert [(s.attn, s.ffn) for s in specs] == \
        [(s.attn, s.ffn) for s in want] == \
        [("mla", "dense")] * 3 + [("mla", "moe")] * 58


def test_deepseek_forward_prefill_and_decode_match_jax(flash_calls):
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    b, t = 2, 10
    toks = _tokens(jcfg, (b, t), 3)
    got, aux = tm(torch.from_numpy(toks))
    assert flash_calls == [(True, 0, 1, 24)] * jcfg.n_layers
    want, jaux = jm.forward(jp, jnp.asarray(toks))
    _close(got, want)
    _close(aux, jaux)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))
    cache, jc = tm.init_cache(b, t), jm.init_cache(b, t)
    assert all(lc.keys() == {"c", "k_rope"} for lc in cache)
    ptrs = [{k: v.data_ptr() for k, v in lc.items()} for lc in cache]
    jstep = jax.jit(jm.decode_step)
    outs = []
    for i in range(t):
        lg, _ = tm.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
        jlg, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        _close(lg, jlg, err_msg=str(i))
        outs.append(lg[:, 0])
    assert [{k: v.data_ptr() for k, v in lc.items()} for lc in cache] == ptrs
    err = float((torch.stack(outs, 1) - got).abs().max())
    assert err / float(got.abs().max()) < 2e-4


def test_deepseek_loss_aux_and_every_gradient_match_jax():
    # The gradient reaches MLA's weights through the flash route's
    # backward (the plain recompute), q_rope / k_rope's concatenation and
    # V's padding.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = next(jbatches(jcfg, 2, 12, seed=2))

    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(b["tokens"]))
        return (JL.softmax_xent(logits, jnp.asarray(b["labels"]))
                + jcfg.router_aux_coef * aux, aux)
    (jl, jaux), jg = jax.value_and_grad(lf, has_aux=True)(jp)
    tm, _ = TS.init_train_state(tm)
    tot, _, aux, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tot, jl)
    _close(aux, jaux)
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_deepseek_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config(ARCH)).param_specs())
    assert got == want
    assert got["layers.0.attn.w_uq"] == (1536, 128, 192)
    assert got["layers.0.attn.w_dkv"] == (7168, 576)
    assert got["layers.3.moe.wi"] == (256, 7168, 2048)
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    assert mats == cfg.n_params() == 671_025_397_760
    cut = TS.build_model(dataclasses.replace(cfg, n_layers=4),
                         device="meta")
    assert [s.ffn for s in cut.specs] == ["dense"] * 3 + ["moe"]
    assert sum(p.numel() for p in cut.parameters()) == 15_111_101_440


def test_deepseek_bf16_parameter_dtypes_match_jax_leaves():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jp = JDecoderLM(jcfg).init_params(jax.random.PRNGKey(0))
    want = {n: str(leaf.dtype) for n, leaf, _ in convert._lm_leaves(tcfg, jp)}
    tm = TS.build_model(tcfg, device="cpu")
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want
    assert {n for n, d in got.items() if d == "float32"} == {
        f"layers.{i}.moe.router" for i in (2, 3)}


def _jax_generate(jm, jcfg, jp, prompts, gen):
    b, plen = prompts.shape
    cache = jm.init_cache(b, plen + gen)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp,
                                             jnp.asarray(prompts), cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, out = last, [np.asarray(last)]
    for i in range(gen - 1):
        tok, cache = serve(jp, cache, tok, jnp.int32(plen + i))
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def test_deepseek_captured_decode_with_a_tensor_position_gives_jax_tokens(
        monkeypatch):
    # launch.serve's Step under the CUDA-graph stand-in: the latent caches
    # are written at the position the 0-d tensor holds, in every replay.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=4)
    prompts = _tokens(jcfg, (3, 5), 6)
    monkeypatch.setattr(tserve, "CudaGraph", _StandInGraph)
    _StandInGraph.captures = 0
    got, _, _ = tserve.generate(tm, tcfg, torch.from_numpy(prompts), 6)
    assert _StandInGraph.captures == 1
    eager, _, _ = tserve.generate(tm, tcfg, torch.from_numpy(prompts), 6,
                                  capture=False)
    assert torch.equal(got, eager)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_generate(jm, jcfg, jp, prompts, 6))


def test_deepseek_launch_serve_generates_jax_tokens(monkeypatch):
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "4",
                            "--gen", "4"]) == 0
    got = [eval(s) for s in out.getvalue().splitlines()[3:]]
    want = _jax_generate(jm, jcfg, jp, _tokens(jcfg, (3, 4), 0), 4)
    assert got == want.tolist()


def test_flash_backward_chunks_match_jax_gradients(monkeypatch):
    # The flash route's backward recomputes in chunks of BWD_CHUNK query
    # rows; at 8 rows over T = 20 the chunks end inside the sequence.
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    jcfg, tcfg, jp, tp = _mla_params(9)
    x = np.random.default_rng(10).normal(0, 1, (2, 20, 64)).astype(
        np.float32)
    g = np.random.default_rng(11).normal(0, 1, (2, 20, 64)).astype(
        np.float32)

    def jf(p, xx):
        y = JMLA.mla_attention(p, jcfg, xx, jnp.arange(20, dtype=jnp.int32))
        return jnp.sum(y * jnp.asarray(g))
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (TMLA.mla_attention(tp, tcfg, tx) * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jgx)
    for k in tp:
        _close(tp[k].grad, jgp[k], err_msg=k)
