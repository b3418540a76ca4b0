"""The port stands alone: no module of petal_neighbors_tpu_torch, nor
chip_smoke.py, fold_profile.py, kernel_ab.py or the port's examples
(examples/torch_*.py), imports jax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "petal_neighbors_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "fold_profile.py", ROOT / "kernel_ab.py"
] + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "petal_neighbors_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"knn_kernel.py", "lp_kernel.py", "minima_kernel.py",
            "sort_kernel.py", "rank_sort_kernel.py", "bruteforce.py",
            "topk.py", "convert.py", "chip_smoke.py",
            "fold_profile.py", "kernel_ab.py", "ball.py", "ball_query.py",
            "ball_build.py", "ball_build_device.py", "_auto.py",
            "tree_math.py", "vantage.py", "vantage_build_device.py",
            "dynamic.py", "dual.py", "boruvka.py", "cluster.py",
            "mst_kernel.py", "sklearn.py", "serialize.py", "serving.py",
            "profiling.py", "torch_dbscan.py", "torch_optics.py",
            "torch_hdbscan_core.py", "api.py", "_comm.py",
            "dryrun.py"} <= names
    port = ROOT / "petal_neighbors_tpu_torch"
    assert port / "native" / "__init__.py" in PORT_FILES
    assert (port / "native" / "src" / "petal_native.cpp").is_file()
    csrc = ROOT / "petal_neighbors_tpu_torch" / "ops" / "cuda" / "csrc"
    assert {"knn_fold.cu", "knn_minima.cu", "knn_tiles.cuh", "lp_knn.cu",
            "row_sort.cu", "knn_select.cu", "knn_tc.cuh",
            "mst_scan.cu"} <= {
        p.name for p in csrc.iterdir()}


def test_import_leaves_jax_unloaded():
    code = ("import sys, petal_neighbors_tpu_torch, "
            "petal_neighbors_tpu_torch.ops.cuda._build, "
            "petal_neighbors_tpu_torch.ops.cuda.lp_kernel, "
            "petal_neighbors_tpu_torch.ops.cuda.minima_kernel, "
            "petal_neighbors_tpu_torch.distance, "
            "petal_neighbors_tpu_torch.native, "
            "petal_neighbors_tpu_torch.trees.ball, "
            "petal_neighbors_tpu_torch.trees.ball_query, "
            "petal_neighbors_tpu_torch.trees.ball_build, "
            "petal_neighbors_tpu_torch.trees.ball_build_device, "
            "petal_neighbors_tpu_torch.trees._auto, "
            "petal_neighbors_tpu_torch.trees.vantage, "
            "petal_neighbors_tpu_torch.trees.vantage_build_device, "
            "petal_neighbors_tpu_torch.trees.dynamic, "
            "petal_neighbors_tpu_torch.trees.dual, "
            "petal_neighbors_tpu_torch.trees.boruvka, "
            "petal_neighbors_tpu_torch.cluster, "
            "petal_neighbors_tpu_torch.ops.cuda.mst_kernel, "
            "petal_neighbors_tpu_torch.utils.tree_math, "
            "petal_neighbors_tpu_torch.sklearn, "
            "petal_neighbors_tpu_torch.utils.serialize, "
            "petal_neighbors_tpu_torch.utils.serving, "
            "petal_neighbors_tpu_torch.utils.profiling, "
            "petal_neighbors_tpu_torch.parallel, "
            "petal_neighbors_tpu_torch.parallel.dryrun; "
            "sys.path.insert(0, 'examples'); "
            "import torch_dbscan, torch_optics, torch_hdbscan_core; "
            "torch_dbscan.dbscan(torch_optics.demo_points()[:300], 0.3, 5, "
            "device='cpu'); "
            "torch_hdbscan_core.mst_edges(torch_hdbscan_core.demo_points()"
            "[:100], 3, device='cpu'); "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert not any(m.split('.')[0] == 'petal_neighbors_tpu' "
            "for m in sys.modules), 'JAX package loaded'")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
