"""gemma3 in the port (sliding-window layers, ring-buffer caches, the
flash kernel's window and head dims up to 256) against the JAX package on
the CPU, at smoke size in fp32.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``.  JAX runs windowed
attention in XLA (``_sdpa`` with ``_mask_bias``); the port sends it
through ``ops.flash_attention``, here its plain version.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
GEMMAS = ["gemma3-12b", "gemma3-27b"]


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _cfg32(arch, **kw):
    j = dataclasses.replace(jget_smoke(arch), dtype="float32", **kw)
    t = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return j, t


def _carried(jcfg, tcfg, seed=0):
    jm = JDecoderLM(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _jax_attention(q, k, v, window, causal=True):
    """JAX's windowed attention on [B, T, H, hd] numpy arrays."""
    t, hd = q.shape[1], q.shape[-1]
    pos = jnp.arange(t, dtype=jnp.int32)
    return JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    JA._mask_bias(pos, pos, causal, window), hd ** -0.5)


def _heads(x):
    """[B, T, H, hd] -> the kernel's [B*H, T, hd]."""
    b, t, h, hd = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, t, hd
                                                       ).contiguous()


# --------------------------------------------------------------------------- #
# The flash kernel's function: windows and gemma3's head dims
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [168, 240])
@pytest.mark.parametrize("window", [1, 4, 64])
def test_flash_plain_window_matches_jax_sdpa(d, window):
    # gemma3-27b's and gemma3-12b's head dims; window 64 >= T is no window.
    t, h, g = 40, 4, 2
    r = np.random.default_rng(d + window)
    q = r.normal(0, 1, (1, t, h, d)).astype(np.float32)
    k, v = (r.normal(0, 1, (1, t, h // g, d)).astype(np.float32)
            for _ in range(2))
    want = _jax_attention(q, k, v, window)
    got = ref.flash_attention_plain(_heads(q), _heads(k), _heads(v), True,
                                    window)
    _close(got.reshape(1, h, t, d).transpose(1, 2), want, rtol=0, atol=2e-5)
    assert torch.equal(ops.flash_attention(_heads(q), _heads(k), _heads(v),
                                           True, window), got)


def test_flash_wrapper_takes_gemma3_head_dims_and_windows_on_cpu():
    # The wrapper's contract is the kernel's on both devices: any head dim
    # >= 1 (gemma3-12b's 240 among them; past 256 the kernel's single-pass
    # bodies, in clusters past 576), a window only with causal masking and
    # Tq <= Tk.
    r = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(r.normal(0, 1, (2, 30, 240)).astype(
        np.float32)) for _ in range(3))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, True, window=7)
    assert got.shape == (2, 30, 240) and ops.LAUNCHES["flash_attention"] == 0
    assert torch.equal(got, ref.flash_attention_plain(q, k, v, True, 7))
    assert not torch.equal(got, ref.flash_attention_plain(q, k, v, True))
    wide = torch.from_numpy(r.normal(0, 1, (2, 8, 264)).astype(np.float32))
    assert torch.equal(ops.flash_attention(wide, wide, wide),
                       ref.flash_attention_plain(wide, wide, wide))
    assert ops.LAUNCHES["flash_attention"] == 0
    empty = torch.zeros(2, 8, 0)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(empty, empty, empty)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, False, window=7)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k[:, :20], v[:, :20], True, window=7)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, True, window=-1)


@pytest.mark.parametrize("window", [0, 3, 11])
def test_flash_backward_matches_jax_grad(monkeypatch, window):
    # _FlashAttention's backward (the plain function recomputed by query
    # chunks of 8 over the keys each chunk sees) against jax.grad of
    # JAX's _sdpa with _mask_bias, grouped heads G = 2, ragged T.
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    b, t, h, kh, hd = 2, 21, 4, 2, 16
    r = np.random.default_rng(30 + window)
    q = r.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k, v = (r.normal(0, 1, (b, t, kh, hd)).astype(np.float32)
            for _ in range(2))
    w = r.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TA._flash(tq, tk, tv, window)
    (o * torch.from_numpy(w)).sum().backward()

    def f(q, k, v):
        return jnp.sum(_jax_attention(q, k, v, window) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, exp)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_routes_windows_to_flash(monkeypatch, window):
    r = np.random.default_rng(12)
    d, h, kh, hd = 64, 4, 2, 16
    p = {"wq": r.normal(0, d ** -0.5, (d, h, hd)),
         "wk": r.normal(0, d ** -0.5, (d, kh, hd)),
         "wv": r.normal(0, d ** -0.5, (d, kh, hd)),
         "wo": r.normal(0, (h * hd) ** -0.5, (h * hd, d)),
         "q_norm": r.normal(0, 0.1, (hd,)), "k_norm": r.normal(0, 0.1, (hd,))}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = r.normal(0, 1, (2, 24, d)).astype(np.float32)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(
        kw.get("window")) or real(*a, **kw))
    got = TA.attention({n: torch.from_numpy(a) for n, a in p.items()},
                       torch.from_numpy(x), window=window, rope_theta=1e6)
    assert calls == [window]
    want = JA.attention({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), jnp.arange(24, dtype=jnp.int32),
                        window=window, rope_theta=1e6)
    _close(got, want)


# --------------------------------------------------------------------------- #
# The models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma3_config_equals_jax_config(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jget_smoke(arch))
    cfg = get_config(arch)
    specs = layer_specs(cfg)
    want = [s.window for sb, rep in jsegments(jget_config(arch))
            for _ in range(rep) for s in sb]
    assert [s.window for s in specs] == want
    # gemma3-27b: a remainder segment of 2 local layers, then 10 x (5
    # local + 1 global); gemma3-12b: 8 superblocks, no remainder.
    assert sum(w == 0 for w in want) == cfg.n_layers // 6
    assert want[:2] == ([1024, 1024] if arch == "gemma3-27b"
                        else [1024] * 2)


@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma3_forward_and_prefill_match_jax(arch):
    jcfg, tcfg = _cfg32(arch)
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 20)).astype(
        np.int32)                              # 20 > the window of 8
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm(torch.from_numpy(toks))
    assert got.shape == (2, 20, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))


@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma3_weights_carry_over_superblocks(arch):
    # Port layer i holds JAX's segment s, superblock position b, repeat r,
    # in the order the scan applies them.
    jcfg, tcfg = _cfg32(arch)
    _, jp, tm = _carried(jcfg, tcfg, seed=4)
    i = 0
    for s, (sb, rep) in enumerate(jsegments(jcfg)):
        for r in range(rep):
            for b in range(len(sb)):
                want = np.asarray(jp["segments"][s][b]["attn"]["wq"][r])
                np.testing.assert_array_equal(
                    tm.layers[i].attn["wq"].detach().numpy(), want)
                i += 1
    assert i == jcfg.n_layers == len(tm.layers)


def test_gemma3_ring_buffer_decode_matches_forward_and_jax():
    # The twin of tests/test_models.py::test_sliding_window_ring_buffer:
    # local_window 4, 14 positions, so every local cache wraps three times.
    jcfg, tcfg = _cfg32("gemma3-12b", local_window=4)
    jm, jp, tm = _carried(jcfg, tcfg, seed=0)
    b, t = 1, 14
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (b, t)).astype(
        np.int32)
    fwd, _ = tm(torch.from_numpy(toks))
    jfwd, _ = jm.forward(jp, jnp.asarray(toks))
    _close(fwd, jfwd)
    cache, jc = tm.init_cache(b, t), jm.init_cache(b, t)
    assert [lc["k"].shape[1] for lc in cache] == [4] * 5 + [14]
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


@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma3_cache_slots_match_jax(arch):
    jcfg, tcfg = _cfg32(arch)
    for seq in (5, 8, 30):                     # below, at and past window 8
        jc = JDecoderLM(jcfg).init_cache(2, seq)
        want = [tuple(jc[s][b]["k"].shape[1:])
                for s, (sb, rep) in enumerate(jsegments(jcfg))
                for _ in range(rep) for b in range(len(sb))]
        got = TS.build_model(tcfg, device="meta").init_cache(2, seq)
        assert [tuple(lc["k"].shape) for lc in got] == want
        assert [tuple(lc["v"].shape) for lc in got] == want


@pytest.mark.parametrize("arch,n_par", [("gemma3-12b", 11_623_860_480),
                                        ("gemma3-27b", 28_288_258_656)])
def test_gemma3_full_width_shapes_on_meta_match_jax_specs(arch, n_par):
    cfg = get_config(arch)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config(arch)).param_specs())
    assert got == want and len(got) == 2 + cfg.n_layers * 11
    assert tm.layers[0].attn["wq"].shape == (cfg.d_model, cfg.n_heads,
                                             cfg.hd)
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    norms = sum(p.numel() for p in tm.parameters() if p.dim() == 1)
    assert mats == cfg.n_params()
    assert mats + norms == n_par


def test_gemma3_launch_serve_generates_jax_tokens(monkeypatch):
    # 7 prompt tokens and 5 generated: the caches of 12 positions wrap the
    # window-8 ring buffers.
    jcfg, tcfg = _cfg32("gemma3-12b")
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", "gemma3-12b", "--smoke", "--device",
                            "cpu", "--requests", "3", "--prompt-len", "7",
                            "--gen", "5"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=gemma3-12b requests=3 prompt=7 gen=5"
    got = [eval(s) for s in lines[3:]]
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (3, 7)).astype(np.int32))
    cache = jm.init_cache(3, 12)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp, prompts, cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, want = last, [np.asarray(last)]
    for i in range(4):
        tok, cache = serve(jp, cache, tok, jnp.int32(7 + i))
        want.append(np.asarray(tok))
    assert got == np.concatenate(want, axis=1).tolist()
