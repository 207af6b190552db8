"""whisper-base in the port (the encoder's non-causal self-attention and
the decoder's cross-attention on the flash route, cross caches filled from
``encode``) against the JAX package on the CPU, at smoke size in fp32.

Inputs are made with numpy from a seed and handed to both packages; model
weights are JAX's ``WhisperModel.init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays`` (encoder blocks unstacked
from their leading layer axis).
"""
import contextlib
import dataclasses
import io
import json
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
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.whisper import WhisperModel  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "whisper-base"


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


def _inputs(cfg, b, s, t, seed):
    r = np.random.default_rng(seed)
    frames = r.normal(0, 0.1, (b, s, cfg.d_model)).astype(np.float32)
    targets = r.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return frames, targets


@contextlib.contextmanager
def _flash_calls():
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
def test_whisper_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))


def test_whisper_weights_carry_over_by_name():
    jcfg, tcfg = _cfg32()
    _, jp, tm = _carried(jcfg, tcfg, seed=3)
    for i in range(jcfg.n_encoder_layers):
        np.testing.assert_array_equal(
            tm.encoder.blocks[i].attn["wq"].detach().numpy(),
            np.asarray(jp["encoder"]["blocks"]["attn"]["wq"][i]))
    np.testing.assert_array_equal(
        tm.decoder.layers[1].xattn["wv"].detach().numpy(),
        np.asarray(jp["decoder"]["segments"][0][0]["xattn"]["wv"][1]))
    assert tm.embed is tm.decoder.embed
    assert all(s.cross_attn for s in tm.decoder.specs)


def test_whisper_encode_forward_and_prefill_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    frames, targets = _inputs(jcfg, 2, 24, 10, seed=4)
    _close(tm.encode(torch.from_numpy(frames)),
           jm.encode(jp, jnp.asarray(frames)))
    with _flash_calls() as calls:
        got, aux = tm(torch.from_numpy(frames), torch.from_numpy(targets))
    # 2 encoder layers (non-causal over 24 frames), then per decoder layer
    # causal self-attention and a cross block over the 24 encoder states.
    assert calls == [(False, 24, 24)] * 2 + [(True, 10, 10),
                                             (False, 10, 24)] * 2
    want, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(targets))
    assert got.shape == (2, 10, jcfg.vocab) and float(aux) == 0.0
    _close(got, want)
    batch = {"frames": frames, "targets": targets}
    last = TS.make_prefill_step(tm, tcfg)(
        tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(last, JS.make_prefill_step(jm, jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))


def test_whisper_decode_with_cross_caches_from_encode_matches_forward():
    # tests/test_models.py's check: caches filled by projecting the encoder
    # output through each cross block; decode == teacher-forced forward,
    # and equal to JAX's decode on the same caches.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=0)
    b, t, s = 2, 12, 16
    frames, toks = _inputs(jcfg, b, s, t, seed=0)
    fwd, _ = tm(torch.from_numpy(frames), torch.from_numpy(toks))
    enc = tm.encode(torch.from_numpy(frames))
    cache = tm.init_cache(b, t, cross_len=s)
    tm.fill_cross_caches(cache, enc)
    jenc = jm.encode(jp, jnp.asarray(frames))
    jc = jm.init_cache(b, t, cross_len=s)
    filled = []
    for c, bp in zip(jc[0], jp["decoder"]["segments"][0]):
        ks = jax.vmap(lambda pp: jnp.einsum("bsd,dke->bske", jenc,
                                            pp["xattn"]["wk"]))(bp)
        vs = jax.vmap(lambda pp: jnp.einsum("bsd,dke->bske", jenc,
                                            pp["xattn"]["wv"]))(bp)
        filled.append(dict(c, xk=ks, xv=vs))
    jc = [tuple(filled)]
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


def test_whisper_cross_len_defaults_to_n_vision_tokens_as_in_jax():
    # JAX's init_cache(cross_len=None) gives whisper n_vision_tokens =
    # 1,601 cross slots, whatever the frame count; the port copies it.
    jcfg, tcfg = _cfg32()
    jc = JS.build_model(jcfg).init_cache(1, 4)
    tm = TS.build_model(tcfg, device="meta")
    for cl, want in ((None, 1601), (30, 30)):
        got = tm.init_cache(1, 4, cross_len=cl)
        assert [tuple(lc["xk"].shape) for lc in got] == \
            [(1, want, tcfg.n_kv_heads, tcfg.hd)] * tcfg.n_layers
    assert jc[0][0]["xk"].shape[2] == 1601


def _jax_loss_grads(jm, jcfg, jp, batch):
    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(batch["frames"]),
                                 jnp.asarray(batch["targets"]))
        return (JL.softmax_xent(logits, jnp.asarray(batch["target_labels"]))
                + jcfg.router_aux_coef * aux)
    return jax.value_and_grad(lf)(jp)


def test_whisper_loss_and_every_gradient_match_jax(monkeypatch):
    # Every encoder weight's gradient comes back through the decoder's
    # cross blocks (kv_x) and the encoder's non-causal flash backward.
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = next(jbatches(jcfg, 2, 20, seed=2))
    assert b.keys() == {"frames", "targets", "target_labels"}
    jl, jg = _jax_loss_grads(jm, jcfg, jp, b)
    tm, _ = TS.init_train_state(tm)
    tot, loss, aux, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tot, jl)
    _close(loss, jl)
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    assert float(grads["encoder.blocks.0.attn.wq"].abs().max()) > 0
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_whisper_train_steps_match_jax():
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


def test_whisper_remat_policies_give_equal_loss_and_grads(monkeypatch):
    # remat per encoder layer and per decoder repeat (the encoder output
    # reaches each checkpointed repeat as an argument): "full" / "dots"
    # equal "none" bit for bit, and JAX's "full".
    monkeypatch.setattr(TA, "BWD_CHUNK", 8)
    jcfg, tcfg = _cfg32(remat="full")
    jm, jp, tm = _carried(jcfg, tcfg, seed=6)
    b = next(jbatches(jcfg, 2, 20, seed=7))
    tm, _ = TS.init_train_state(tm)
    got = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=policy)
        tm.cfg = cfg
        tm.decoder.cfg = dataclasses.replace(tm.decoder.cfg, remat=policy)
        _, loss, _, grads = TS.value_and_grad(
            tm, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
        got[policy] = (loss, grads)
    for policy in ("full", "dots"):
        assert torch.equal(got[policy][0], got["none"][0])
        for n, g in got[policy][1].items():
            assert torch.equal(g, got["none"][1][n]), (policy, n)
    jl, jg = _jax_loss_grads(jm, jcfg, jp, b)
    _close(got["full"][0], jl)
    want = _as_port(tcfg, jg)
    for n, g in got["full"][1].items():
        _close(g, want[n], err_msg=n)


def test_whisper_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    assert isinstance(tm, WhisperModel)
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JS.build_model(jget_config(ARCH)).param_specs())
    assert got == want
    # encoder: 6 x 9 + final norm; decoder: embed, final norm (tied head),
    # 6 x (9 + 5 cross)
    assert len(got) == 6 * 9 + 1 + 2 + 6 * 14
    assert got["decoder.embed"] == (51865, 512)
    assert got["encoder.blocks.5.attn.wk"] == (512, 8, 64)
    assert sum(p.numel() for p in tm.parameters()) == 83_194_368


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_synthetic_batches_equal_jax_for_enc_dec_and_vision(arch):
    tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    mine = synthetic_batches(tcfg, 3, 20, seed=5, host_id=1, n_hosts=2)
    theirs = jbatches(jcfg, 3, 20, seed=5, host_id=1, n_hosts=2)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    if arch == ARCH:
        assert a["targets"].shape == (3, tcfg.decoder_target_len)
        np.testing.assert_array_equal(a["target_labels"][:, :-1],
                                      a["targets"][:, 1:])


def test_whisper_launch_serve_generates_jax_tokens(monkeypatch):
    # Both launch.serve mains decode over zeroed cross caches of 1,601 slots.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "2", "--prompt-len", "4",
                            "--gen", "4"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={ARCH} requests=2 prompt=4 gen=4"
    got = [eval(s) for s in lines[3:]]
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 4)).astype(np.int32))
    cache = jm.init_cache(2, 8)
    last, cache = jserve._prefill_with_cache(jm, jcfg, jp, prompts, cache)
    serve = jax.jit(JS.make_serve_step(jm, jcfg))
    tok, want = last, [np.asarray(last)]
    for i in range(3):
        tok, cache = serve(jp, cache, tok, jnp.int32(4 + i))
        want.append(np.asarray(tok))
    assert got == np.concatenate(want, axis=1).tolist()


def test_whisper_launch_train_logs_jax_losses(monkeypatch):
    # The plain path trains on frames / targets.  JAX's error-feedback
    # path reads batch["tokens"], which an encoder-decoder batch lacks:
    # both packages raise KeyError there (a finding in ROADMAP C).
    jcfg, tcfg = _cfg32()
    jp = JS.build_model(jcfg).init_params(jax.random.PRNGKey(0))
    # --seq 20 covers the smoke config's decoder_target_len of 16 (the
    # frames are 20 long, targets and labels 16)
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "20", "--log-every", "1", "--lr", "0.05"]

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
    with pytest.raises(KeyError, match="tokens"):
        ttrain.main(argv + ["--compress-grads", "--device", "cpu"])
    with pytest.raises(KeyError, match="tokens"):
        jtrain.main(argv + ["--compress-grads"])


def test_whisper_train_state_checkpoint_round_trip(tmp_path):
    _, tcfg = _cfg32()
    tm, opt = TS.init_train_state(TS.build_model(tcfg, device="cpu", seed=1))
    step = TS.make_train_step(tm, tcfg, base_lr=1.0)
    for s in (1, 2):
        b = next(synthetic_batches(tcfg, 2, 16, seed=s))
        tm, opt, _ = step(tm, opt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    save(str(tmp_path), 2, (tm, opt))
    names = set(json.loads((tmp_path / "step_00000002" / "manifest.json"
                            ).read_text())["leaves"])
    assert "0__encoder.blocks.1.attn.wq" in names
    assert "0__decoder.layers.0.xattn.wk" in names
    assert "1__mu__encoder.final_norm" in names
    fresh, fopt = TS.init_train_state(TS.build_model(tcfg, device="cpu",
                                                     seed=2))
    (fresh, fopt), s, _ = restore(str(tmp_path), (fresh, fopt))
    assert s == 2 and int(fopt.step) == 2
    for (n, a), b in zip(tm.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for n in opt.mu:
        assert torch.equal(opt.mu[n], fopt.mu[n])
        assert torch.equal(opt.nu[n], fopt.nu[n])
        assert torch.equal(opt.master[n], fopt.master[n])


def test_whisper_serve_step_and_build_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.build_model(get_smoke_config(ARCH))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tm = TS.build_model(tcfg, device="cpu")
    nxt, cache = TS.make_serve_step(tm, tcfg)(
        tm, tm.init_cache(2, 3, cross_len=5),
        torch.zeros(2, 1, dtype=torch.int32), 0)
    assert nxt.shape == (2, 1) and cache[0]["xk"].shape[1] == 5
