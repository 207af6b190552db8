"""The control: the plain reference put in the program's place, computed
one precision below the configurations' float32 (TF32 products, as the
tensor cores take float32 operands), must read as not correct.

On the CPU the TF32 rounding is emulated (``check.tf32_matmul``) at a
300-vertex graph.  On the card (``-m gpu``) it runs at the cells' own
size, both emulated and with ``allow_tf32``, on three seeds; run with
``-s`` to see the readings."""
import pytest
import torch

from gnnbench.harness import check, graphgen, inputs, spec
from gnnbench.tests import tiny

CONFIGS = ["gcn-b2-flickr", "gatdot-flickr"]


def readings(cell, seed, device, modes):
    """out_err of the float32 reference in each of ``modes`` against the
    float64 reference, worst over the pool's items."""
    cfg = cell.config
    edges = graphgen.edges(cfg["graph"])
    inp = inputs.make(cfg, cell.traffic, cell.family, seed, device)
    items = range(cell.traffic["pool"])
    want = check.reference_outputs(cell.reference, cfg, edges, inp, items)
    out = {}
    for mode in modes:
        mm = check.tf32_matmul if mode == "tf32_emulated" else torch.matmul
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        try:
            got = check.reference_outputs(cell.reference, cfg, edges, inp,
                                          items, dtype=torch.float32, mm=mm)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        out[mode] = max(check.out_err(got[k], want[k]) for k in items)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_and_float32_passes_on_cpu(config, seed):
    cell = tiny.cell(config)
    r = readings(cell, seed, "cpu", ["tf32_emulated", "fp32"])
    limit = cell.config["check"]["out_err"]
    assert r["tf32_emulated"] > limit
    assert r["fp32"] < limit


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_at_cell_size_on_the_card(config, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(f"{config}.resident")
    r = readings(cell, seed, "cuda", ["tf32", "tf32_emulated", "fp32"])
    limit = cell.config["check"]["out_err"]
    print(f"control {config} seed {seed}: {r} (limit {limit})")
    assert r["tf32"] > limit and r["tf32_emulated"] > limit
