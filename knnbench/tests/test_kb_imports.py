"""Nothing the benchmark runs on the card loads JAX or the JAX package:
module names are compared by their whole top-level name, since the port's
name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from kb_helpers import CHECKOUT
from knnbench import run as run_py

FORBIDDEN = ("jax", "jaxlib", "flax", "petal_neighbors_tpu")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import knnbench, petal_neighbors_tpu_torch
from knnbench import spec
for pkg in (knnbench, petal_neighbors_tpu_torch):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
for folder in ("modes", "references", "metrics"):
    for p in sorted((spec.ROOT / folder).glob("*.py")):
        spec.load_module(p)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_nothing_loads_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(CHECKOUT)],
                         capture_output=True, text=True, timeout=300,
                         check=True, cwd=CHECKOUT)
    loaded = set(out.stdout.split())
    assert {"knnbench", "petal_neighbors_tpu_torch", "torch"} <= loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_run_py_checks_the_same_names():
    assert set(run_py.FORBIDDEN) == set(FORBIDDEN)
    assert run_py.forbidden_modules(["jaxlib.xla_client", "numpy"]) == [
        "jaxlib"]
    # the port's name begins with the JAX package's and is no match
    assert run_py.forbidden_modules([
        "petal_neighbors_tpu_torch", "petal_neighbors_tpu_torch.ops",
        "jaxtyping", "flaxen"]) == []
    assert run_py.forbidden_modules(["petal_neighbors_tpu.ops", "flax"]) == [
        "flax", "petal_neighbors_tpu"]


@pytest.mark.parametrize("path", sorted(
    (CHECKOUT / "knnbench" / "references").glob("*.py")),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = list(_imports(path))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN + (
        "petal_neighbors_tpu_torch", "knnbench") or n.startswith(".")]
    assert not bad, bad
    assert "torch" in names


def test_no_harness_file_imports_jax():
    for path in sorted((CHECKOUT / "knnbench").rglob("*.py")):
        bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)
