"""The port's LM path (repro_torch.models / configs / launch.serve) against
the JAX package on the CPU, at smoke size.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``.  Comparisons run in fp32
(``dataclasses.replace(smoke_config(), dtype="float32")`` on both sides,
as ``tests/test_models.py`` does).  JAX's Pallas flash kernel is not run
(its interpret mode is xfail under this jax, ``tests/test_kernels.py``):
the port's plain version is held against the JAX test's inline oracle and
``repro.kernels.ref.flash_attention_ref`` instead.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

# tests/test_kernels.py's flash sweep: (tq, tk, heads, d, causal).
FLASH_SHAPES = [(128, 128, 2, 64, True), (256, 256, 4, 32, True),
                (128, 256, 1, 64, False), (256, 128, 2, 128, True)]
RTOL, ATOL = 2e-4, 2e-5


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _cfg32(arch="qwen3-0.6b", **kw):
    """An architecture's smoke config (qwen3-0.6b's by default) in fp32,
    for both packages."""
    j = dataclasses.replace(jget_smoke(arch), dtype="float32", **kw)
    t = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return j, t


def _carried(jcfg, tcfg, seed=0):
    """JAX DecoderLM with init_params(PRNGKey(seed)) and the port model
    holding the same weights."""
    jm = JDecoderLM(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _attn_params(rng, d, h, kh, hd, qk_norm):
    p = {"wq": rng.normal(0, d ** -0.5, (d, h, hd)),
         "wk": rng.normal(0, d ** -0.5, (d, kh, hd)),
         "wv": rng.normal(0, d ** -0.5, (d, kh, hd)),
         "wo": rng.normal(0, (h * hd) ** -0.5, (h * hd, d))}
    if qk_norm:
        p["q_norm"] = rng.normal(0, 0.1, (hd,))
        p["k_norm"] = rng.normal(0, 0.1, (hd,))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# --------------------------------------------------------------------------- #
# Flash attention: the plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tq,tk,h,d,causal", FLASH_SHAPES)
def test_flash_plain_matches_jax_oracle(tq, tk, h, d, causal):
    r = np.random.default_rng(7)
    q = r.normal(0, 1, (h, tq, d)).astype(np.float32)
    k = r.normal(0, 1, (h, tk, d)).astype(np.float32)
    v = r.normal(0, 1, (h, tk, d)).astype(np.float32)
    got = ref.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal)
    # The JAX sweep's inline oracle (tests/test_kernels.py).
    s = jnp.einsum("hqd,hkd->hqk", q, k) * (d ** -0.5)
    if causal:
        qpos = np.arange(tq)[:, None]
        kpos = np.arange(tk)[None, :]
        s = jnp.where(jnp.asarray(qpos >= kpos)[None], s, -1e30)
    want = jnp.einsum("hqk,hkd->hqd", jax.nn.softmax(s, axis=-1), v)
    assert got.dtype == torch.float32 and got.shape == (h, tq, d)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("t,h,d", [(200, 3, 40), (64, 2, 128)])
def test_flash_plain_and_ref_match_jax_ref(t, h, d):
    r = np.random.default_rng(t)
    q, k, v = (r.normal(0, 1, (t, h, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jref.flash_attention_ref(q, k, v, causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_plain(tq.transpose(0, 1), tk.transpose(0, 1),
                                    tv.transpose(0, 1), causal=True)
    _close(got.transpose(0, 1), want, rtol=0, atol=2e-5)


def test_flash_plain_bf16_matches_jax_ref():
    r = np.random.default_rng(8)
    q, k, v = (r.normal(0, 1, (2, 128, 64)) for _ in range(3))
    tb = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (q, k, v)]
    got = ref.flash_attention_plain(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = jref.flash_attention_ref(*(a.swapaxes(0, 1) for a in jb)
                                    ).swapaxes(0, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_plain_grouped_heads_match_jax_ref(g):
    # k / v with one head per group of G adjacent query heads: query head
    # h reads KV head h // G, as JAX computes it on repeated heads.
    t, h, d = 96, 4, 32
    r = np.random.default_rng(11 + g)
    q = r.normal(0, 1, (t, h, d)).astype(np.float32)
    k, v = (r.normal(0, 1, (t, h // g, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jref.flash_attention_ref(
        q, np.repeat(k, g, axis=1), np.repeat(v, g, axis=1), causal=True))
    tq, tk, tv = (torch.from_numpy(a).transpose(0, 1).contiguous()
                  for a in (q, k, v))
    assert tk.shape == (h // g, t, d)
    got = ref.flash_attention_plain(tq, tk, tv, causal=True)
    _close(got.transpose(0, 1), want, rtol=0, atol=2e-5)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True), got)


def test_flash_plain_granite_group_matches_jax_ref():
    # granite-8b's grouping: 32 query heads over 8 KV heads (G = 4), here
    # 8 over 2 at d = 128, as the prefill lays them out ([BH, T, d]).
    t, h, g, d = 80, 8, 4, 128
    r = np.random.default_rng(44)
    q = r.normal(0, 1, (t, h, d)).astype(np.float32)
    k, v = (r.normal(0, 1, (t, h // g, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jref.flash_attention_ref(
        q, np.repeat(k, g, axis=1), np.repeat(v, g, axis=1), causal=True))
    tq, tk, tv = (torch.from_numpy(a).transpose(0, 1).contiguous()
                  for a in (q, k, v))
    got = ref.flash_attention_plain(tq, tk, tv, causal=True)
    _close(got.transpose(0, 1), want, rtol=0, atol=2e-5)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True), got)


def test_flash_wrapper_refuses_a_group_that_does_not_divide_bh():
    q = torch.zeros(6, 8, 16)
    with pytest.raises(ValueError, match="G dividing"):
        ops.flash_attention(q, torch.zeros(4, 8, 16), torch.zeros(4, 8, 16))
    with pytest.raises(ValueError, match="k / v"):
        ops.flash_attention(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 8))


def test_flash_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.normal(0, 1, (3, 50, 16)).astype(
        np.float32)) for _ in range(3))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.flash_attention_plain(q, k, v, True))
    assert ops.LAUNCHES["flash_attention"] == 0


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def test_layers_match_jax():
    r = np.random.default_rng(2)
    x = r.normal(0, 1, (2, 16, 4, 32)).astype(np.float32)
    scale = r.normal(0, 0.1, (32,)).astype(np.float32)
    tx = torch.from_numpy(x)
    _close(TL.rms_norm(tx, torch.from_numpy(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           rtol=1e-5, atol=1e-6)
    pos = np.arange(16, dtype=np.int32)
    for theta in (1e4, 1e6):
        _close(TL.rope(tx, torch.from_numpy(pos), theta),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
               rtol=1e-5, atol=1e-6)
    p = {n: r.normal(0, 0.2, s).astype(np.float32)
         for n, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    xs = r.normal(0, 1, (2, 5, 32)).astype(np.float32)
    _close(TL.swiglu({n: torch.from_numpy(a) for n, a in p.items()},
                     torch.from_numpy(xs)),
           JL.swiglu({n: jnp.asarray(a) for n, a in p.items()},
                     jnp.asarray(xs)),
           rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_flash_route_matches_jax(monkeypatch, qk_norm):
    r = np.random.default_rng(3)
    jp, tp = _attn_params(r, 64, 4, 2, 16, qk_norm)
    x = r.normal(0, 1, (2, 40, 64)).astype(np.float32)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = TA.attention(tp, torch.from_numpy(x), rope_theta=1e6)
    assert calls == [1]                        # default positions: flash
    want = JA.attention(jp, jnp.asarray(x), jnp.arange(40, dtype=jnp.int32),
                        rope_theta=1e6)
    _close(got, want)
    # Explicit positions take _sdpa; the same function here.
    pos = torch.arange(40, dtype=torch.int32)
    _close(TA.attention(tp, torch.from_numpy(x), pos, rope_theta=1e6), want)
    assert calls == [1]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_sdpa_chunked_matches_jax(causal, window):
    r = np.random.default_rng(4)
    q = r.normal(0, 1, (2, 32, 4, 16)).astype(np.float32)
    k, v = (r.normal(0, 1, (2, 32, 2, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(32, dtype=np.int32)
    args = (pos, pos, causal, window, 16 ** -0.5, 8)
    got = TA._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(pos), torch.from_numpy(pos),
                           *args[2:])
    want = JA._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                            *(jnp.asarray(a) for a in args[:2]), *args[2:])
    _close(got, want)


def test_windowed_and_chunked_attention_match_jax():
    r = np.random.default_rng(5)
    jp, tp = _attn_params(r, 64, 4, 2, 16, True)
    x = r.normal(0, 1, (1, 24, 64)).astype(np.float32)
    src = r.normal(0, 1, (1, 10, 64)).astype(np.float32)
    pos = jnp.arange(24, dtype=jnp.int32)
    for kw in ({"window": 6}, {"chunk": 8}, {"causal": False},
               {"kv_x": src, "causal": False, "use_rope": False}):
        tkw = {k: torch.from_numpy(v) if k == "kv_x" else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if k == "kv_x" else v
               for k, v in kw.items()}
        _close(TA.attention(tp, torch.from_numpy(x), **tkw),
               JA.attention(jp, jnp.asarray(x), pos, **jkw))


@pytest.mark.parametrize("window,s_len", [(0, 12), (4, 4)])
def test_decode_attention_matches_jax(window, s_len):
    # window 4 over a 4-slot ring buffer: 12 steps wrap around it twice.
    r = np.random.default_rng(6)
    jp, tp = _attn_params(r, 64, 4, 2, 16, True)
    jc = JA.init_cache(2, s_len, 2, 16, jnp.float32)
    tc = TA.init_cache(2, s_len, 2, 16, torch.float32)
    for pos in range(12):
        x = r.normal(0, 1, (2, 1, 64)).astype(np.float32)
        want, jc = JA.decode_attention(jp, jnp.asarray(x), jc,
                                       jnp.int32(pos), window=window,
                                       rope_theta=1e6)
        got, tc = TA.decode_attention(tp, torch.from_numpy(x), tc, pos,
                                      window=window, rope_theta=1e6)
        _close(got, want)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
    # cross-attention against a static cache (all slots valid)
    x = r.normal(0, 1, (2, 1, 64)).astype(np.float32)
    want, _ = JA.decode_attention(jp, jnp.asarray(x), jc, jnp.int32(3),
                                  cross=True)
    got, _ = TA.decode_attention(tp, torch.from_numpy(x), tc, 3, cross=True)
    _close(got, want)


# --------------------------------------------------------------------------- #
# The model and its steps
# --------------------------------------------------------------------------- #
def test_port_config_equals_jax_config():
    for arch in ("qwen3-0.6b", "granite-8b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jget_smoke(arch))
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]


def test_forward_and_prefill_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm(torch.from_numpy(toks))
    assert got.shape == (2, 12, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    jlast = JS.make_prefill_step(jm, jcfg)(jp, {"tokens": jnp.asarray(toks)})
    _close(last, jlast)


def test_decode_step_and_serve_step_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=3)
    b, t = 2, 10
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (b, t)).astype(
        np.int32)
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t)
    jstep = JS.make_serve_step(jm, jcfg)
    tstep = TS.make_serve_step(tm, tcfg)
    for i in range(t):
        tok = toks[:, i:i + 1]
        want, jc_next = jm.decode_step(jp, jc, jnp.asarray(tok),
                                       jnp.int32(i))
        jnxt, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(i))
        got, tc = tm.decode_step(tc, torch.from_numpy(tok), i)
        _close(got, want)
        for layer, lc in enumerate(tc):
            _close(lc["k"], jc_next[0][0]["k"][layer])
            _close(lc["v"], jc_next[0][0]["v"][layer])
        nxt = torch.argmax(got[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    # serve_step itself, on a fresh cache
    nxt, _ = tstep(tm, tm.init_cache(b, t), torch.from_numpy(toks[:, :1]), 0)
    assert nxt.dtype == torch.int32 and nxt.shape == (b, 1)


def test_granite_forward_and_prefill_match_jax():
    """granite-8b's smoke config: no qk_norm, an untied head carried by
    ``lm_params_from_arrays`` with the rest."""
    jcfg, tcfg = _cfg32("granite-8b")
    assert not tcfg.tie_embeddings and not tcfg.qk_norm
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    assert torch.equal(tm.head, torch.from_numpy(np.array(jp["head"])))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm(torch.from_numpy(toks))
    _close(got, want)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))
    # the head is the untied weight, not the embedding's transpose
    x = tm.hidden(torch.from_numpy(toks))
    assert torch.equal(tm._logits(x), torch.matmul(x, tm.head))


def test_granite_decode_and_serve_step_match_jax():
    jcfg, tcfg = _cfg32("granite-8b")
    jm, jp, tm = _carried(jcfg, tcfg, seed=6)
    b, t = 2, 9
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (b, t)).astype(
        np.int32)
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t)
    jstep = JS.make_serve_step(jm, jcfg)
    for i in range(t):
        tok = toks[:, i:i + 1]
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(i))
        got, tc = tm.decode_step(tc, torch.from_numpy(tok), i)
        _close(got, want)
    jnxt, _ = jstep(jp, jm.init_cache(b, t), jnp.asarray(toks[:, :1]),
                    jnp.int32(0))
    nxt, _ = TS.make_serve_step(tm, tcfg)(tm, tm.init_cache(b, t),
                                          torch.from_numpy(toks[:, :1]), 0)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_granite_decode_matches_forward():
    _, tcfg = _cfg32("granite-8b")
    tm = TS.build_model(tcfg, device="cpu", seed=8)
    b, t = 2, 10
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (b, t)).astype(np.int32))
    fwd, _ = tm(toks)
    cache = tm.init_cache(b, t)
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, dim=1) - fwd).abs().max())
    assert err / (float(fwd.abs().max()) + 1e-9) < 2e-4


def test_granite_launch_serve_generates_jax_tokens(monkeypatch):
    jcfg, tcfg = _cfg32("granite-8b")
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", "granite-8b", "--smoke", "--device",
                            "cpu", "--requests", "3", "--prompt-len", "5",
                            "--gen", "4"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=granite-8b requests=3 prompt=5 gen=4"
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


def test_decode_matches_forward():
    # The port's twin of tests/test_models.py::_decode_matches_forward.
    _, tcfg = _cfg32()
    tm = TS.build_model(tcfg, device="cpu", seed=4)
    b, t = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (b, t)).astype(np.int32))
    fwd, _ = tm(toks)
    cache = tm.init_cache(b, t)
    outs = []
    for i in range(t):
        lg, cache = tm.decode_step(cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, dim=1) - fwd).abs().max())
    assert err / (float(fwd.abs().max()) + 1e-9) < 2e-4


def test_launch_serve_generates_jax_tokens(monkeypatch):
    # The port's launch.serve and the JAX version's loop, fed the same
    # carried weights and the same prompts, generate the same token ids.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", "--requests", "4", "--prompt-len", "9",
                            "--gen", "6"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=qwen3-0.6b requests=4 prompt=9 gen=6"
    got = [eval(s) for s in lines[3:]]
    # JAX: repro.launch.serve.main's loop with these weights.
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (4, 9)).astype(np.int32))
    cache = jm.init_cache(4, 15)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp, prompts, cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, want = last, [np.asarray(last)]
    for i in range(5):
        tok, cache = serve(jp, cache, tok, jnp.int32(9 + i))
        want.append(np.asarray(tok))
    want = np.concatenate(want, axis=1)
    assert got == want[:3].tolist()


def test_full_width_shapes_on_meta_match_jax_specs():
    # qwen3-0.6b at full width, no allocation on either side.
    cfg = get_config("qwen3-0.6b")
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config("qwen3-0.6b")).param_specs())
    assert got == want and len(got) == 2 + 28 * 11
    # ModelConfig.n_params counts the matrices; the norm scales are the
    # rest: 28 x (ln1, ln2, q_norm, k_norm) + final_norm.
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    norms = sum(p.numel() for p in tm.parameters() if p.dim() == 1)
    assert mats == cfg.n_params() == 595_984_384
    assert norms == 28 * (2 * cfg.d_model + 2 * cfg.hd) + cfg.d_model


def test_granite_full_width_shapes_on_meta_match_jax_specs():
    # granite-8b at full width (8.25 B parameters), no allocation.
    cfg = get_config("granite-8b")
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config("granite-8b")).param_specs())
    assert got == want and len(got) == 3 + 36 * 9
    assert got["head"] == (4096, 49152) and tm.layers[0].attn[
        "wk"].shape == (4096, 8, 128)
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    norms = sum(p.numel() for p in tm.parameters() if p.dim() == 1)
    assert mats == cfg.n_params() == 8_254_390_272
    assert norms == 36 * 2 * cfg.d_model + cfg.d_model


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke"])
    assert TS.build_model(cfg, device="cpu").embed.device.type == "cpu"


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="A15"):
        get_config(arch)
