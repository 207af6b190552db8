"""The port's train step (repro_torch.models.steps / optim / data /
distributed.compression / checkpoint / launch.train) against the JAX
package on the CPU, at smoke size in fp32.

Weights are JAX's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_arrays``, which also carries JAX's
gradients and AdamW moments (pytrees of the params' structure) to the
port's state-dict names.  Batches come from ``synthetic_batches`` with a
seed, the same numpy arrays for both packages.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import synthetic_batches as jbatches  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.distributed import compression as TC  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import cosine_schedule  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
REPO = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["qwen3-0.6b", "gemma3-12b"]


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _cfg32(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _carried(jcfg, tcfg, seed=0):
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _as_port(tcfg, tree):
    """A JAX pytree of the params' structure under the port's names."""
    return convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray,
                                                            tree))


def _batch(cfg, seed, b=2, t=16):
    return next(jbatches(cfg, b, t, seed=seed))


# --------------------------------------------------------------------------- #
# Pieces
# --------------------------------------------------------------------------- #
def test_softmax_xent_matches_jax():
    r = np.random.default_rng(0)
    logits = r.normal(0, 3, (2, 7, 50)).astype(np.float32)
    labels = r.integers(0, 50, (2, 7)).astype(np.int32)
    _close(TL.softmax_xent(torch.from_numpy(logits),
                           torch.from_numpy(labels)),
           JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)),
           rtol=1e-6, atol=1e-6)


def test_cosine_schedule_matches_jax():
    steps = [0, 1, 7, 50, 99, 100, 101, 777, 5000, 9999, 10000, 12345]
    for kw in ({}, {"warmup": 10, "total": 1000, "min_ratio": 0.2}):
        for s in steps:
            got = cosine_schedule(torch.tensor(s, dtype=torch.int32), 3e-4,
                                  **kw)
            assert got.dtype == torch.float32 and got.shape == ()
            want = float(jcosine(jnp.int32(s), 3e-4, **kw))
            assert float(got) == pytest.approx(want, rel=1e-6, abs=0), s
    # lr is 0 at step 0 under warmup, whatever the base rate.
    assert float(cosine_schedule(0, 1.0)) == 0.0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b", "granite-8b"])
def test_synthetic_batches_equal_bit_for_bit(arch):
    for cfg, jcfg in ((get_smoke_config(arch), jget_smoke(arch)),
                      (get_config(arch), None)):
        jcfg = jcfg or dataclasses.replace(jget_smoke(arch), vocab=cfg.vocab)
        mine = synthetic_batches(cfg, 3, 33, seed=5, host_id=1, n_hosts=2)
        theirs = jbatches(jcfg, 3, 33, seed=5, host_id=1, n_hosts=2)
        for _ in range(3):
            a, b = next(mine), next(theirs)
            assert a.keys() == b.keys() == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_ef_transform_matches_jax():
    r = np.random.default_rng(3)
    g = {"w": r.normal(0, 1, (16, 24)).astype(np.float32),
         "b": r.normal(0, 1e-3, (24,)).astype(np.float32),
         "z": np.zeros((5,), np.float32)}
    e = {k: r.normal(0, 1e-2, v.shape).astype(np.float32)
         for k, v in g.items()}
    e["z"][:] = 0.0
    got_g, got_e = TC.ef_transform({k: torch.from_numpy(v)
                                    for k, v in g.items()},
                                   {k: torch.from_numpy(v)
                                    for k, v in e.items()})
    want_g, want_e = JC.ef_transform({k: jnp.asarray(v)
                                      for k, v in g.items()},
                                     {k: jnp.asarray(v) for k, v in e.items()})
    for k in g:
        _close(got_g[k], want_g[k], rtol=1e-6, atol=0, err_msg=k)
        _close(got_e[k], want_e[k], rtol=1e-6, atol=1e-9, err_msg=k)
        # the residual carries the rounding error exactly
        _close(got_g[k] + got_e[k], g[k] + e[k], rtol=0, atol=1e-6)
    q, s = TC.compress(torch.from_numpy(g["w"]))
    jq, js = JC.compress(jnp.asarray(g["w"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    _close(TC.decompress(q, s), JC.decompress(jq, js), rtol=1e-7, atol=0)


@pytest.mark.parametrize("keep_master", [True, False])
def test_adamw_update_matches_jax(keep_master):
    # Three updates at lr 1e-3 with fresh gradients each time; the first
    # has a gradient norm above the clip of 1.
    r = np.random.default_rng(4)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 2, 4)}
    p0 = {k: r.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ts = adamw_init(tp, keep_master=keep_master)
    js = jadamw_init(jp, keep_master=keep_master)
    assert (ts.master is None) == (js.master is None)
    for i in range(3):
        g = {k: r.normal(0, 2.0 / (i + 1), s).astype(np.float32)
             for k, s in shapes.items()}
        tp, ts = adamw_update(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, 1e-3)
        jp, js = jadamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                               js, 1e-3)
    assert int(ts.step) == int(js.step) == 3
    for k in shapes:
        _close(tp[k], jp[k], err_msg=k)
        _close(ts.mu[k], js.mu[k], err_msg=k)
        _close(ts.nu[k], js.nu[k], err_msg=k)
        if keep_master:
            _close(ts.master[k], js.master[k], err_msg=k)


def test_adamw_keeps_a_bf16_param_on_its_fp32_master():
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.master["w"].dtype == torch.float32
    p, st = adamw_update(p, {"w": torch.full((4,), 0.5)}, st, 1e-3,
                         weight_decay=0.0)
    # one step moves the master by lr (|m / c1| / sqrt(v / c2) = 1); the
    # bf16 param is its rounding.
    assert float(st.master["w"][0]) == pytest.approx(1.0 - 1e-3, abs=1e-7)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], st.master["w"].to(torch.bfloat16))


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg = _cfg32(arch)
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = _batch(jcfg, seed=2, t=20)             # 20 > gemma3's window of 8

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
    assert float(aux) == 0.0
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    # Three steps of make_train_step at base lr 1 (the warmup gives lr 0,
    # 0.01 and 0.02): the loss of each, then params, mu and nu.
    jcfg, tcfg = _cfg32(arch)
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
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    assert float(tmet["lr"]) == pytest.approx(0.02, rel=1e-6)
    assert int(topt.step) == 3
    for tree, got in ((jp, dict(tm.named_parameters())), (jopt.mu, topt.mu),
                      (jopt.nu, topt.nu), (jopt.master, topt.master)):
        want = _as_port(tcfg, tree)
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name], err_msg=name)


def test_train_step_refuses_what_the_port_does_not_train():
    base = dataclasses.asdict(get_smoke_config("qwen3-0.6b"))
    for kw in ({"n_experts": 4, "top_k": 2, "d_ff_moe": 32},
               {"cross_attn_every": 2}, {"encoder_decoder": True}):
        cfg = ModelConfig(**{**base, **kw})
        with pytest.raises(NotImplementedError, match="A15"):
            TS.make_train_step(None, cfg)


def test_launch_train_logs_jax_losses(monkeypatch):
    # The port's launch.train and JAX's, fed the same carried weights, the
    # same synthetic batches and flags, print the same loss lines (each
    # rounded to 4 decimals), through the plain and compressed paths.  At
    # base lr 0.05 the steps move the loss by ~1e-2; much larger rates let
    # an int8 rounding that flips on fp32 noise show in the 4th decimal.
    jcfg, tcfg = _cfg32("qwen3-0.6b")
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--lr", "0.05"]

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
        assert len(lt) == len(lj) == 5            # 4 steps and the last line
        np.testing.assert_allclose(lt, lj, atol=2e-4)
        assert "done: 4 steps" in out_t.getvalue()


def test_train_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.build_model(cfg)
    tm, opt = TS.init_train_state(TS.build_model(cfg, device="cpu"))
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in tm.parameters())
    assert opt.master["embed"].device.type == "cpu"


# --------------------------------------------------------------------------- #
# Checkpoints: the twins of tests/test_checkpoint.py
# --------------------------------------------------------------------------- #
def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.normal(0, 1, (4, 8)).astype(np.float32)),
            "b": {"c": torch.from_numpy(r.integers(0, 9, (3,)).astype(
                np.int32)),
                  "d": [torch.from_numpy(r.normal(0, 1, (2, 2)).astype(
                      np.float32)).to(torch.bfloat16) for _ in range(2)]}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t, meta={"x": 1})
    target = _zeros_like(t)
    t2, step, meta = restore(str(tmp_path), target)
    assert step == 7 and meta == {"x": 1} and t2 is target
    for a, b in zip(_flat(t), _flat(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # bf16 leaves are their raw 16 bits on disk, as JAX stores them
    man = json.loads((tmp_path / "step_00000007" / "manifest.json"
                      ).read_text())
    assert man["leaves"]["b__d__0"] == {"shape": [2, 2], "dtype": "bfloat16"}
    raw = np.load(tmp_path / "step_00000007" / "b__d__0.npy")
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(
        raw, t["b"]["d"][0].view(torch.int16).numpy().view(np.uint16))


def test_train_state_roundtrip(tmp_path):
    # (model, AdamWState) under the port's state-dict names and the
    # optimizer's fields; a restore writes a fresh model's tensors.
    _, tcfg = _cfg32("gemma3-12b")
    tm, opt = TS.init_train_state(TS.build_model(tcfg, device="cpu", seed=1))
    step = TS.make_train_step(tm, tcfg, base_lr=1.0)
    for b in [next(synthetic_batches(tcfg, 2, 16, seed=s)) for s in (1, 2)]:
        tm, opt, _ = step(tm, opt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    save(str(tmp_path), 2, (tm, opt))
    names = set(json.loads((tmp_path / "step_00000002" / "manifest.json"
                            ).read_text())["leaves"])
    assert "0__layers.0.attn.wq" in names and "1__step" in names
    assert "1__mu__embed" in names and "1__master__final_norm" in names
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


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 5
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_00000004", "step_00000005"]


def test_incomplete_checkpoint_ignored(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    # simulate a crash mid-save: manifest without the complete flag
    bad = tmp_path / "step_00000002"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({"step": 2}))
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="does not fit"):
        restore(str(tmp_path), {"a": torch.zeros(4, 8, dtype=torch.float64),
                                "b": _zeros_like(t["b"])})


@pytest.mark.slow          # three training subprocesses
def test_crash_restart_loss_continuity(tmp_path):
    """launch.train: crash at step 12, relaunch with --resume auto; the
    run completes, and its last loss is the uninterrupted run's (the
    state is restored bit for bit and the data stream fast-forwarded)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "20",
            "--batch", "2", "--seq", "32", "--ckpt-every", "5",
            "--log-every", "5"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--resume", "auto"]
    r1 = subprocess.run(args + ck + ["--crash-at", "12"], env=env,
                        capture_output=True, text=True, timeout=600)
    assert r1.returncode == 42, r1.stderr[-2000:]  # simulated failure
    assert latest_step(str(tmp_path / "ck")) == 10
    r2 = subprocess.run(args + ck, env=env, capture_output=True, text=True,
                        timeout=600)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[resume] restored step 10" in r2.stdout
    assert "done: 20 steps" in r2.stdout
    r3 = subprocess.run(args, env=env, capture_output=True, text=True,
                        timeout=600)
    assert r3.returncode == 0, r3.stderr[-2000:]
    last = [ln for ln in r3.stdout.splitlines() if ln.startswith("step")]
    resumed = [ln for ln in r2.stdout.splitlines() if ln.startswith("step")]
    assert last[-1].split("(")[0] == resumed[-1].split("(")[0]
