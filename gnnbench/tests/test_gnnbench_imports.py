"""Nothing under gnnbench/ imports JAX or the JAX package (``repro``),
compared by whole top-level name, so ``repro_torch`` is not ``repro``;
the references import nothing of the program either."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _modules():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(path):
    """Top-level names of every absolute import in the file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_walk_finds_the_harness():
    found = {os.path.relpath(p, BENCH) for p in _modules()}
    assert {"run.py", "harness/runner.py", "reference/gcn.py"} <= found


@pytest.mark.parametrize("path", list(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_nor_jax_package(path):
    assert not imported_tops(path) & BANNED


@pytest.mark.parametrize(
    "path", [p for p in _modules() if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)


def test_whole_name_comparison():
    assert "repro_torch".split(".")[0] not in BANNED
    assert "repro.core".split(".")[0] in BANNED
