"""The MoE FFN in the port (``repro_torch.models.moe``) and kimi-k2, its
model, against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; MoE
parameters and model weights are JAX's ``moe_init`` / ``init_params``
carried over by ``repro_torch.convert`` (which transposes the experts to
the port's E-major layout).  ``moe_a2a`` and ``moe_local`` run on four
virtual CPU entries, ``DeviceMesh(["cpu"] * 4)``, against JAX's on a
4-device ``("model",)`` mesh in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this process gives
JAX one CPU device), as ``tests/test_torch_placement.py`` does.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
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
from repro.models import moe as JMOE  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.models.transformer import build_segments as jsegments  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batches  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_replay import _StandInGraph  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
ARCH = "kimi-k2-1t-a32b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
D, F, E, K = 16, 32, 8, 2          # d_model, d_ff_moe, experts, top-k
MESH = DeviceMesh(["cpu"] * 4)


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _moe_params(dtype=jnp.float32, seed=0):
    """JAX's ``moe_init`` (with a shared expert) and the port's copy."""
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), D, F, E, dtype, n_shared=1)

    def port(a, axes=None):
        a32 = np.asarray(a, np.float32)
        t = torch.from_numpy(np.array(a32 if axes is None
                                      else a32.transpose(axes)))
        return t.bfloat16() if a.dtype == jnp.bfloat16 else t
    tp = {k: port(v, convert._axes(f"moe.{k}")) for k, v in jp.items()
          if k != "shared"}
    tp["shared"] = {k: port(v) for k, v in jp["shared"].items()}
    return jp, tp


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(0, 1, shape + (D,)).astype(
        dtype)


# --------------------------------------------------------------------------- #
# Router and dispatch
# --------------------------------------------------------------------------- #
def test_router_matches_jax():
    jp, tp = _moe_params()
    x = _x((40,), 1)
    w, ids, aux = TMOE._router(tp, torch.from_numpy(x), K)
    jw, jids, jaux = JMOE._router(jp, jnp.asarray(x), K)
    assert ids.shape == (40, K) and w.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(aux, jaux)


def test_router_breaks_ties_to_the_lower_expert_as_lax_top_k():
    # A zero input gives every expert the same probability.
    jp, tp = _moe_params()
    x = np.zeros((3, D), np.float32)
    _, ids, _ = TMOE._router(tp, torch.from_numpy(x), 3)
    _, jids, _ = JMOE._router(jp, jnp.asarray(x), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1, 2]] * 3


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_dispatch_slots_and_drops_match_jax(cap):
    # 24 tokens x 3 slots over 8 experts: at cap 1 and 3 assignments drop.
    r = np.random.default_rng(cap)
    xf = r.normal(0, 1, (24, D)).astype(np.float32)
    ids = np.stack([r.permutation(E)[:3] for _ in range(24)]).astype(
        np.int32)
    w = r.random((24, 3)).astype(np.float32)
    buf, slot, keep = TMOE._dispatch_local(torch.from_numpy(xf),
                                           torch.from_numpy(ids), E, cap)
    jbuf, jslot, jkeep = JMOE._dispatch_local(jnp.asarray(xf), jnp.asarray(w),
                                              jnp.asarray(ids), E, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cap < 40)


# --------------------------------------------------------------------------- #
# The dense oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_matches_jax(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, tp = _moe_params(jdt, seed=3)
    assert tp["router"].dtype == torch.float32          # fp32 in bf16 too
    assert str(tp["wi"].dtype).endswith(dtype)
    x = jnp.asarray(_x((2, 7), 4), jdt)
    tx = torch.from_numpy(np.array(x, np.float32)).to(tp["wi"].dtype)
    y, aux = TMOE.moe_dense(tp, tx, K)
    jy, jaux = JMOE.moe_dense(jp, x, K)
    assert y.dtype == tx.dtype and y.shape == (2, 7, D)
    tol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    _close(y, jy, *tol)
    _close(aux, jaux, *tol)


# --------------------------------------------------------------------------- #
# a2a / local on a mesh, against JAX's 4-device mesh
# --------------------------------------------------------------------------- #
A2A_CASES = [((2, 64), 1), ((2, 6), 2)]     # split by sequence; replicated
LOCAL_CASES = [((4, 1), 3), ((8, 2), 4)]
CFS = (1.0, 4.0)
_JAX_MESH = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from repro.compat import make_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.models import moe as MOE
from repro.models.steps import build_model
assert jax.device_count() == 4, jax.device_count()
a = json.loads(sys.argv[2])
mesh = make_mesh((4,), ("model",))
p = MOE.moe_init(jax.random.PRNGKey(0), a["d"], a["f"], a["e"], jnp.float32,
                 n_shared=1)
out = {}
def x_of(shape, seed):
    return jnp.asarray(np.random.default_rng(seed).normal(
        0, 1, tuple(shape) + (a["d"],)).astype(np.float32))
with set_mesh(mesh):
    for fn, cases in (("a2a", a["a2a"]), ("local", a["local"])):
        f = MOE.moe_a2a if fn == "a2a" else MOE.moe_local
        for shape, seed in cases:
            for cf in a["cfs"]:
                y, aux = jax.jit(lambda x, cf=cf: f(p, x, a["k"], cf, mesh))(
                    x_of(shape, seed))
                out[f"{fn} {tuple(shape)} {cf}"] = [np.asarray(y).tolist(),
                                             float(aux)]
    cfg = dataclasses.replace(get_smoke_config(a["arch"]), dtype="float32")
    m = build_model(cfg, moe_impl="a2a", mesh=mesh)
    params = m.init_params(jax.random.PRNGKey(1))
    toks = jnp.asarray(np.asarray(a["tokens"], np.int32))
    lg, aux = jax.jit(m.forward)(params, toks)
    out["forward"] = [np.asarray(lg).tolist(), float(aux)]
    cache = m.init_cache(*toks.shape)
    step = jax.jit(m.decode_step)
    out["decode"] = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, i:i + 1], jnp.int32(i))
        out["decode"].append(np.asarray(lg).tolist())
print(json.dumps(out))
"""


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_mesh():
    """JAX's moe_a2a / moe_local on a 4-device ("model",) mesh for every
    case, and the kimi-k2 smoke model (fp32, moe_impl="a2a", weights from
    key 1) forward and decode over tokens of seed 5."""
    args = {"d": D, "f": F, "e": E, "k": K, "a2a": A2A_CASES,
            "local": LOCAL_CASES, "cfs": CFS, "arch": ARCH,
            "tokens": _tokens(jget_smoke(ARCH), (2, 8), 5).tolist()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_MESH, os.path.join(ROOT, "src"),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _drops(x, tp, cap, use_seq, n_dev=4):
    """Assignments the port's dispatch drops over the entries' shards."""
    b, t, _ = x.shape
    _, ids, _ = TMOE._router(tp, x.reshape(b * t, D), K)
    ids = ids.view(b, t, K)
    tl = t // n_dev if use_seq else t
    shards = [ids[:, j * tl:(j + 1) * tl] for j in range(n_dev)] \
        if use_seq else [ids] * n_dev
    return sum(int((~TMOE._dispatch_local(
        torch.zeros(s.shape[0] * s.shape[1], D), s.reshape(-1, K), E,
        cap)[2]).sum()) for s in shards)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape,seed", A2A_CASES)
def test_moe_a2a_on_four_entries_matches_jax_mesh(jax_mesh, shape, seed, cf):
    _, tp = _moe_params()
    x = torch.from_numpy(_x(shape, seed))
    y, aux = TMOE.moe_a2a(tp, x, K, cf, MESH)
    want, jaux = jax_mesh[f"a2a {tuple(shape)} {cf}"]
    _close(y, np.asarray(want))
    _close(aux, jaux)
    use_seq = shape[1] % 4 == 0
    n = shape[0] * (shape[1] // 4 if use_seq else shape[1])
    cap = TMOE._capacity(n, K, cf, E, 4)
    dropped = _drops(x, tp, cap, use_seq)
    one, _ = TMOE.moe_a2a(tp, x, K, cf, DeviceMesh(["cpu"]))
    if cf == 4.0:
        # Room for every assignment: the dense oracle's output.
        assert dropped == 0
        _close(y, TMOE.moe_dense(tp, x, K)[0])
        _close(one, y)
    else:
        assert dropped > 0                     # the same drops as JAX's


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape,seed", LOCAL_CASES)
def test_moe_local_on_four_entries_matches_jax_mesh(jax_mesh, shape, seed,
                                                    cf):
    _, tp = _moe_params()
    x = torch.from_numpy(_x(shape, seed))
    y, aux = TMOE.moe_local(tp, x, K, cf, MESH)
    want, jaux = jax_mesh[f"local {tuple(shape)} {cf}"]
    _close(y, np.asarray(want))
    _close(aux, jaux)
    dense = TMOE.moe_dense(tp, x, K)[0]
    if cf == 4.0:
        _close(y, dense)
        _close(TMOE.moe_local(tp, x, K, cf, DeviceMesh(["cpu"]))[0], y)
    else:
        assert float((y - dense).abs().max()) > 1e-3   # drops show


def test_kimi_a2a_model_matches_jax_mesh(jax_mesh):
    # Prefill through moe_a2a, decode through moe_local (JAX's
    # DecoderLM(moe_impl="a2a")), on four entries against four devices.
    jcfg, tcfg = _cfg32()
    jp = JS.build_model(jcfg).init_params(jax.random.PRNGKey(1))
    tm = TS.build_model(tcfg, device="cpu", moe_impl="a2a", mesh=MESH)
    tm.load_state_dict(_as_port(tcfg, jp))
    toks = _tokens(jcfg, (2, 8), 5)
    lg, aux = tm(torch.from_numpy(toks))
    _close(lg, np.asarray(jax_mesh["forward"][0]))
    _close(aux, jax_mesh["forward"][1])
    cache = tm.init_cache(2, 8)
    for i in range(8):
        lg, _ = tm.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(lg, np.asarray(jax_mesh["decode"][i]), err_msg=str(i))


def test_mesh_must_split_the_experts_and_a2a_needs_one():
    _, tp = _moe_params()
    x = torch.from_numpy(_x((1, 3), 0))
    with pytest.raises(ValueError, match="split"):
        TMOE.moe_a2a(tp, x, K, 1.0, DeviceMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="mesh"):
        TS.build_model(get_smoke_config(ARCH), device="cpu", moe_impl="a2a")
    with pytest.raises(ValueError, match="moe_impl"):
        TS.build_model(get_smoke_config(ARCH), device="cpu",
                       moe_impl="sparse")


# --------------------------------------------------------------------------- #
# kimi-k2
# --------------------------------------------------------------------------- #
def _cfg32(**kw):
    return (dataclasses.replace(jget_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                                **kw))


def _as_port(tcfg, tree):
    return convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray,
                                                            tree))


def _carried(jcfg, tcfg, seed=0):
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(_as_port(tcfg, jp))
    return jm, jp, tm


def test_kimi_config_equals_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    specs = layer_specs(get_config(ARCH))
    want = [s for sb, rep in jsegments(jget_config(ARCH))
            for _ in range(rep) for s in sb]
    assert [(s.attn, s.ffn) for s in specs] == \
        [(s.attn, s.ffn) for s in want] == \
        [("gqa", "dense")] + [("gqa", "moe")] * 60


def test_kimi_forward_prefill_and_decode_match_jax():
    # Every cache tensor is written in place.
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=2)
    b, t = 2, 10
    toks = _tokens(jcfg, (b, t), 3)
    got, aux = tm(torch.from_numpy(toks))
    want, jaux = jm.forward(jp, jnp.asarray(toks))
    _close(got, want)
    _close(aux, jaux)
    assert float(aux) > 0
    last = TS.make_prefill_step(tm, tcfg)(tm, {"tokens":
                                               torch.from_numpy(toks)})
    _close(last, JS.make_prefill_step(jm, jcfg)(jp, {"tokens":
                                                     jnp.asarray(toks)}))
    cache, jc = tm.init_cache(b, t), jm.init_cache(b, t)
    ptrs = [{k: v.data_ptr() for k, v in lc.items()} for lc in cache]
    jstep = jax.jit(jm.decode_step)
    for i in range(t):
        lg, cache2 = tm.decode_step(cache, torch.from_numpy(
            toks[:, i:i + 1]), i)
        jlg, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        assert cache2 is cache
        _close(lg, jlg, err_msg=str(i))
    assert [{k: v.data_ptr() for k, v in lc.items()} for lc in cache] == ptrs


def test_kimi_loss_aux_and_every_gradient_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    b = next(jbatches(jcfg, 2, 12, seed=2))

    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(b["tokens"]))
        return (JL.softmax_xent(logits, jnp.asarray(b["labels"]))
                + jcfg.router_aux_coef * aux, aux)
    (jl, jaux), jg = jax.value_and_grad(lf, has_aux=True)(jp)
    tm, _ = TS.init_train_state(tm)
    tot, loss, aux, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tot, jl)
    _close(aux, jaux)
    assert float(aux) > 0
    want = _as_port(tcfg, jg)
    assert grads.keys() == want.keys() == dict(tm.named_parameters()).keys()
    assert {n.split(".", 2)[2] for n in grads if ".moe." in n} >= {
        "moe.router", "moe.wi", "moe.wo", "moe.shared.wg"}
    for name, g in grads.items():
        _close(g, want[name], err_msg=name)


def test_kimi_train_steps_match_jax():
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=3)
    _, jopt = JS.init_train_state(jm, jax.random.PRNGKey(3))
    jstep = jax.jit(JS.make_train_step(jm, jcfg, base_lr=1.0))
    tm, topt = TS.init_train_state(tm)
    tstep = TS.make_train_step(tm, tcfg, base_lr=1.0)
    jit = jbatches(jcfg, 2, 8, seed=4)
    tit = synthetic_batches(tcfg, 2, 8, seed=4)
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        jp, jopt, jmet = jstep(jp, jopt, {k: jnp.asarray(v)
                                          for k, v in jb.items()})
        tm, topt, tmet = tstep(tm, topt, {k: torch.from_numpy(v)
                                          for k, v in tb.items()})
        _close(tmet["loss"], jmet["loss"])
        _close(tmet["aux"], jmet["aux"])
    want = _as_port(tcfg, jp)
    for name, p in tm.named_parameters():
        _close(p, want[name], err_msg=name)


def test_kimi_full_width_shapes_on_meta_match_jax_specs():
    cfg = get_config(ARCH)
    tm = TS.build_model(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = convert.lm_param_shapes(
        cfg, JDecoderLM(jget_config(ARCH)).param_specs())
    assert got == want
    assert got["layers.1.moe.wi"] == (384, 7168, 2048)
    assert got["layers.60.moe.wo"] == (384, 2048, 7168)
    assert got["layers.1.moe.shared.wi"] == (7168, 2048)
    assert "layers.0.mlp.wi" in got and "layers.0.moe.wi" not in got
    mats = sum(p.numel() for p in tm.parameters() if p.dim() > 1)
    assert mats == cfg.n_params() == 1_027_290_693_632


def test_kimi_two_layer_cut_and_a_zero_repeat_moe_segment():
    # The card's cut: one dense layer and one MoE layer (19.93 B
    # parameters).  A cut at first_k_dense leaves the MoE segment with no
    # repeat at all.
    cut = TS.build_model(dataclasses.replace(get_config(ARCH), n_layers=2),
                         device="meta")
    assert [s.ffn for s in cut.specs] == ["dense", "moe"]
    assert sum(p.numel() for p in cut.parameters()) == 19_934_645_248
    _, tcfg = _cfg32(n_layers=1)
    tm = TS.build_model(tcfg, device="cpu")
    assert [s.ffn for s in tm.specs] == ["dense"] and tm.repeats == [(0, 1)]
    logits, aux = tm(torch.from_numpy(_tokens(tcfg, (2, 5), 0)))
    assert logits.shape == (2, 5, tcfg.vocab) and float(aux) == 0.0


def test_kimi_bf16_router_stays_fp32_as_jax_leaves():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jp = JDecoderLM(jcfg).init_params(jax.random.PRNGKey(0))
    want = {n: str(leaf.dtype) for n, leaf, _ in convert._lm_leaves(tcfg, jp)}
    tm = TS.build_model(tcfg, device="cpu")
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want
    assert {n for n, d in got.items() if d == "float32"} == {
        f"layers.{i}.moe.router" for i in (1, 2)}
    tm.load_state_dict(_as_port(tcfg, jp))
    _close(tm.layers[1].moe["router"], np.asarray(
        jp["segments"][1][0]["moe"]["router"][0]), rtol=0, atol=0)


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


def test_kimi_captured_decode_with_a_tensor_position_gives_jax_tokens(
        monkeypatch):
    # launch.serve's Step under the CUDA-graph stand-in: the capture and
    # every replay read the position from a 0-d tensor.
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


def test_kimi_launch_serve_generates_jax_tokens(monkeypatch):
    jcfg, tcfg = _cfg32()
    jm, jp, tm = _carried(jcfg, tcfg, seed=1)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, device, seed: tm)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "4",
                            "--gen", "4"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={ARCH} requests=3 prompt=4 gen=4"
    got = [eval(s) for s in lines[3:]]
    want = _jax_generate(jm, jcfg, jp, _tokens(jcfg, (3, 4), 0), 4)
    assert got == want.tolist()
