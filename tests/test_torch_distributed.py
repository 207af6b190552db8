"""The port's distributed stack (``repro_torch.distributed`` and the
(data, model) meshes of ``repro_torch.launch.mesh``) against JAX's
(``repro.distributed``): the sharding rules leaf for leaf at full width
(the port's model on ``meta``, JAX's ``param_specs()`` on an
``AbstractMesh``, which needs no devices), the cache / batch specs, ZeRO-1's
specs and a ZeRO-1 train step bit for bit the unsharded one, placement
round trips, and the GPipe schedule against sequential execution and
against JAX's ``pipeline_apply`` on 4 host devices (a subprocess)."""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.distributed.zero import opt_state_specs as j_opt_specs  # noqa
from repro.distributed.zero import zero_param_spec as j_zero_spec  # noqa
from repro.models.steps import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch.mesh import (DeviceMesh, make_local_mesh,  # noqa
                                     make_production_mesh)
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.transformer import block_apply  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
JMESH = {False: AbstractMesh((16, 16), ("data", "model")),
         True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(port config, port model on meta, JAX param shapes) at full
    width."""
    cfg = get_config(arch)
    return (cfg, TS.build_model(cfg, device="meta"),
            jbuild(jget_config(arch)).param_specs())


def _jax_leaves(cfg, tree, shapes):
    """(port name, JAX leaf of ``tree``, JAX shape, stacked?)."""
    for (name, leaf, r), (_, sd, _) in zip(convert._lm_leaves(cfg, tree),
                                           convert._lm_leaves(cfg, shapes)):
        yield name, leaf, tuple(sd.shape), r is not None


def _as_port(name, jspec, jshape, stacked, keep_layer=False):
    """JAX's spec of a leaf as the port writes it: padded to the leaf's
    rank, the stacked layer entry dropped (or kept first), the trailing
    entries in the port's axis order."""
    full = tuple(jspec) + (None,) * (len(jshape) - len(jspec))
    lead = full[:1] if stacked else ()
    rest = full[1:] if stacked else full
    axes = convert._axes(name)
    if axes is not None:
        rest = tuple(rest[i] for i in axes)
    return (lead if keep_layer else ()) + rest


# --------------------------------------------------------------------------- #
# Meshes.
# --------------------------------------------------------------------------- #
def test_meshes_name_jax_s_axes_and_keep_the_1d_default():
    m = DeviceMesh(["cpu"] * 3)
    assert m.axis_names == ("dev",) and m.shape == {"dev": 3}
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    single, multi = make_production_mesh(), make_production_mesh(True)
    assert single.shape == dict(JMESH[False].shape)
    assert multi.shape == dict(JMESH[True].shape)
    assert {d.type for d in multi.devices} == {"meta"} and multi.size == 512
    assert multi.coords(300) == {"pod": 1, "data": 2, "model": 12}
    assert all(multi.index(multi.coords(i)) == i for i in range(512))
    sub = multi.along("model", pod=1, data=2)
    assert sub.axis_names == ("model",) and sub.size == 16
    loc = make_local_mesh(2, 4, ["cpu"] * 8)
    assert loc.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="holds 8 entries"):
        DeviceMesh(["cpu"] * 6, (2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        loc.along("pod")


# --------------------------------------------------------------------------- #
# Sharding rules.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_leaf_for_leaf(arch):
    cfg, model, shapes = _pair(arch)
    named = dict(model.named_parameters())
    for multi in (None, False, True):
        jm = None if multi is None else JMESH[multi]
        tm = None if multi is None else make_production_mesh(multi)
        got = SH.param_specs(model, tm)
        want = JSH.param_specs(shapes, jm)
        seen = 0
        for name, spec, jshape, stacked in _jax_leaves(cfg, want, shapes):
            exp = _as_port(name, spec, jshape, stacked)
            assert got[name] == exp, (name, multi, got[name], exp)
            assert len(got[name]) == named[name].dim()
            seen += 1
        assert seen == len(named)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_jax_s(arch):
    cfg, model, shapes = _pair(arch)
    for multi in (False, True):
        got = Z.opt_state_specs(model, make_production_mesh(multi))
        want = j_opt_specs(shapes, JMESH[multi])
        assert got.step == () and tuple(want.step) == ()
        for part in ("mu", "nu", "master"):
            for name, spec, jshape, stacked in _jax_leaves(
                    cfg, getattr(want, part), shapes):
                exp = _as_port(name, spec, jshape, stacked, keep_layer=True)
                assert P(*getattr(got, part)[name]) == P(*exp), (
                    name, multi, getattr(got, part)[name], exp)


def test_hymba_s_state_splits_its_layer_stack_over_data():
    """hymba's 32 layers divide 16 data rows: JAX's ZeRO splits the
    stacked layer dimension, two layers' state a row; its 25-head
    ``A_log`` has no other divisible dimension."""
    cfg, model, _ = _pair("hymba-1.5b")
    specs = Z.opt_state_specs(model, make_production_mesh()).master
    assert specs["layers.5.ssm.A_log"] == ("data", None)
    slots = SH.layer_slots(model)
    assert slots["layers.5.ssm.A_log"] == (5, 32)


def test_layer_slots_follow_jax_s_segments():
    cfg, model, _ = _pair("gemma3-12b")     # 48 = 6 superblocks of 6
    slots = SH.layer_slots(model)
    assert slots["layers.0.ln1"] == (0, 8)
    assert slots["layers.13.attn.wq"] == (2, 8)
    assert "embed" not in slots
    cfg, model, _ = _pair("kimi-k2-1t-a32b")  # 1 dense + 60 MoE layers
    slots = SH.layer_slots(model)
    assert slots["layers.0.mlp.wi"] == (0, 1)
    assert slots["layers.7.moe.wi"] == (6, 60)
    cfg, model, _ = _pair("whisper-base")
    slots = SH.layer_slots(model)
    assert slots["encoder.blocks.3.attn.wq"] == (3, cfg.n_encoder_layers)
    assert slots["decoder.layers.2.xattn.wq"][0] == 2


def test_zero_param_spec_cases_of_the_jax_suite():
    mesh = make_local_mesh(2, 4, ["cpu"] * 8)
    assert Z.zero_param_spec((None, "model"), (8, 16), mesh) == \
        ("data", "model")
    assert Z.zero_param_spec(("model", None), (8, 3), mesh) == \
        (("model", "data"), None)
    jm = AbstractMesh((2, 4), ("data", "model"))
    for spec, shape in [((None, "model"), (8, 16)), (("model", None), (8, 3)),
                        ((None,), (3,)), ((None, None), (2, 5)),
                        (("model", None), (4, 6))]:
        assert P(*Z.zero_param_spec(spec, shape, mesh)) == \
            j_zero_spec(P(*spec), shape, jm), (spec, shape)


@pytest.mark.parametrize("multi", [False, True])
def test_cache_and_batch_specs_equal_jax_s(multi):
    tm, jm = make_production_mesh(multi), JMESH[multi]
    assert SH.mesh_batch_axes(tm) == JSH.mesh_batch_axes(jm)
    for b in (1, 2, 16, 32, 128, 256, 512):
        for extra in (0, 1, 2):
            assert P(*SH.batch_spec(tm, b, extra)) == \
                JSH.batch_spec(jm, b, extra)
        assert P(*SH.latent_cache_spec(b, tm)) == \
            JSH.latent_cache_spec(b, jm)
        for kv in (1, 4, 8, 16, 32):
            for s in (0, 1, 448, 4096, 32768):
                assert P(*SH.kv_cache_spec(b, tm, kv, s)) == \
                    JSH.kv_cache_spec(b, jm, kv, s), (b, kv, s)
        for shape in [(b,), (b, 16), (b, 25, 64), (b, 4, 64, 16)]:
            assert P(*SH.state_cache_spec(shape, tm)) == \
                JSH.state_cache_spec(shape, jm), shape


# --------------------------------------------------------------------------- #
# Placement.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [(None, "model", None), ("data", None, None),
                                  ("data", "model", None),
                                  (("model", "data"), None, None),
                                  (None, None, None), ("model",)])
def test_shard_then_gather_is_bit_for_bit(spec):
    mesh = make_local_mesh(2, 4, ["cpu"] * 8)
    t = torch.randn(8, 12, 3, generator=torch.Generator().manual_seed(0))
    shards = SH.shard(t, spec, mesh)
    loc = SH.local_shape(t.shape, spec, mesh)
    assert all(s.shape == loc for s in shards)
    assert SH.held_nbytes(t.shape, t.dtype, spec, mesh) == \
        shards[0].numel() * 4
    back = SH.gather(shards, spec, mesh, t.shape, "cpu")
    assert torch.equal(back, t)
    shards[0].zero_()                   # each entry holds its own copy
    assert torch.equal(SH.gather(SH.shard(t, spec, mesh), spec, mesh,
                                 t.shape, "cpu"), t)


def test_a_layer_split_spec_places_whole_layers_by_data_row():
    mesh = make_local_mesh(2, 2, ["cpu"] * 4)
    t = torch.arange(12.0).reshape(3, 4)
    for r in range(4):                  # slice r of a stack of 4
        shards = SH.shard(t, ("data", None, "model"), mesh, slot=(r, 4))
        row = r // 2
        for i, s in enumerate(shards):
            if mesh.coords(i)["data"] == row:
                assert s.shape == (3, 2)
            else:
                assert s is None
        assert torch.equal(SH.gather(shards, ("data", None, "model"), mesh,
                                     t.shape, "cpu", slot=(r, 4)), t)
        nb = SH.held_nbytes(t.shape, t.dtype, ("data", None, "model"),
                            mesh, slot=(r, 4))
        assert nb == (24 if row == 0 else 0)


def test_full_width_parameters_round_trip_on_a_2x4_mesh_of_meta_entries():
    cfg, model, _ = _pair("qwen3-0.6b")
    mesh = make_local_mesh(2, 4, ["meta"] * 8)
    specs = SH.param_specs(model, mesh)
    for n, p in model.named_parameters():
        shards = SH.shard(p, specs[n], mesh)
        assert [tuple(s.shape) for s in shards] == \
            [SH.local_shape(p.shape, specs[n], mesh)] * 8
        assert SH.gather(shards, specs[n], mesh, p.shape,
                         "meta").shape == p.shape


# --------------------------------------------------------------------------- #
# ZeRO-1 train step.
# --------------------------------------------------------------------------- #
def _batches(cfg, n, b=4, t=16):
    rng = np.random.default_rng(7)
    return [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)),
                                dtype=torch.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _zero_against_unsharded(cfg, mesh, steps=2):
    ref = TS.build_model(cfg, device="cpu", seed=3)
    ref, ropt = TS.init_train_state(ref)
    rstep = TS.make_train_step(ref, cfg)
    model = TS.build_model(cfg, device="cpu", seed=3)
    zstate = Z.zero_init(model, mesh)
    zstep = Z.make_zero_train_step(model, cfg, mesh)
    for batch in _batches(cfg, steps):
        ref, ropt, rm = rstep(ref, ropt, batch)
        model, zstate, zm = zstep(model, zstate, batch)
        assert torch.equal(rm["loss"], zm["loss"])
        assert torch.equal(rm["lr"], zm["lr"])
    assert int(zstate.step) == int(ropt.step) == steps
    for (n, a), (_, b) in zip(ref.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n
    full = Z.zero_gather(zstate, model, mesh)
    for part in ("mu", "nu", "master"):
        for n in getattr(ropt, part):
            assert torch.equal(getattr(ropt, part)[n],
                               getattr(full, part)[n]), (part, n)
    return zstate


def test_zero_train_step_is_bit_for_bit_the_unsharded_step():
    cfg = get_smoke_config("qwen3-0.6b")
    mesh = make_local_mesh(4, 2, ["cpu"] * 8)
    zstate = _zero_against_unsharded(cfg, mesh)
    specs = Z.opt_state_specs(TS.build_model(cfg, device="meta"),
                              mesh).master
    assert specs["layers.0.attn.wq"] == (None, "data", "model", None)
    per = Z.shard_bytes(zstate)
    assert len(per) == 8 and len(set(per.values())) == 1
    n_state = sum(p.numel() for p in TS.build_model(
        cfg, device="meta").parameters())
    assert per[0] < 3 * 4 * n_state / 2       # sharded: well under a copy


def test_zero_train_step_with_layer_split_state_and_moe_experts():
    """hymba's smoke stack of 2 layers on 2 data rows (whole layers a
    row) and kimi's E-major experts, each bit for bit unsharded."""
    cfg = get_smoke_config("hymba-1.5b")
    mesh = make_local_mesh(2, 1, ["cpu"] * 2)
    zstate = _zero_against_unsharded(cfg, mesh)
    assert zstate.mu["layers.1.ssm.A_log"][0] is None
    assert zstate.mu["layers.1.ssm.A_log"][1] is not None
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    _zero_against_unsharded(cfg, make_local_mesh(2, 2, ["cpu"] * 4),
                            steps=1)


# --------------------------------------------------------------------------- #
# GPipe.
# --------------------------------------------------------------------------- #
def _stage_case():
    rng = np.random.default_rng(0)
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    ws = rng.normal(0, 0.5, (n_stages, d, d)).astype(np.float32)
    x = rng.normal(0, 1, (n_micro, mb, d)).astype(np.float32)
    return ws, x


def _jax_pipeline(tmp_path, ws, x):
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipeline_apply
        from repro.compat import make_mesh, set_mesh
        mesh = make_mesh((4,), ("stage",))
        ws = jnp.asarray(np.load({str(tmp_path / "ws.npy")!r}))
        x = jnp.asarray(np.load({str(tmp_path / "x.npy")!r}))
        with set_mesh(mesh):
            y = pipeline_apply(lambda w, h: jnp.tanh(h @ w), ws, x, mesh,
                               axis="stage")
        np.save({str(tmp_path / "y.npy")!r}, np.asarray(y))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(tmp_path / "y.npy")


def test_pipeline_is_sequential_bit_for_bit_and_matches_jax(tmp_path):
    ws, x = _stage_case()
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("stage",))
    tw, tx = torch.from_numpy(ws), torch.from_numpy(x)
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), list(tw), tx, mesh)
    seq = []
    for mb in tx:
        h = mb
        for w in tw:
            h = torch.tanh(h @ w)
        seq.append(h)
    assert torch.equal(y, torch.stack(seq))
    jy = _jax_pipeline(tmp_path, ws, x)
    assert np.max(np.abs(y.numpy() - jy)) < 1e-5


def test_pipeline_of_model_layers_equals_the_layer_loop():
    """qwen3's smoke layers as 2 stages of one layer, 3 microbatches:
    the flash route included, bit for bit the per-microbatch loop."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              dtype="float32")
    model = TS.build_model(cfg, device="cpu")
    mesh = DeviceMesh(["cpu"] * 2, (2,), ("stage",))
    x = model.embed[torch.randint(0, cfg.vocab, (3, 2, 12),
                                  generator=torch.Generator()
                                  .manual_seed(1)).long()]

    def stage(layers, h):
        for spec, bp in layers:
            h, _ = block_apply(cfg, spec, bp, h, None)
        return h

    pairs = list(zip(model.specs, model.layers))
    parts = [pairs[:1], pairs[1:]]
    with torch.no_grad():
        y = pipeline_apply(stage, parts, x, mesh)
        want = torch.stack([stage(pairs, mb) for mb in x])
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="stage parameters"):
        pipeline_apply(stage, parts[:1], x, mesh)
