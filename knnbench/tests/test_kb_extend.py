"""A cell brings its own program, reference, check and data as new files,
and the cells that bring none resolve as they always did: the flat index,
the reference of the configuration's metric, the k-NN check, and the
built-in uniform data, bit for bit."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

import kb_legacy
from kb_helpers import CHECKOUT
from knnbench import check, data, harness, spec

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
JOB_CELL = "blobs.job-mst"
#: the harness's files that a new cell may not need an edit of
UNTOUCHED = ("harness.py", "check.py", "data.py", "spec.py", "run.py")


@pytest.fixture
def job_root(tmp_path):
    """A copy of the benchmark's folder with the files of one job cell
    added (``tests/jobcell/``): a mode with ``program`` and
    ``REFERENCE``, a reference with ``compare``, a ``values/`` file of
    Gaussian blobs, and the cell's configuration, traffic and workload."""
    root = tmp_path / "knnbench"
    shutil.copytree(CHECKOUT / "knnbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(CHECKOUT / "knnbench" / "tests" / "jobcell", root,
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_job_cell_of_new_files_runs(job_root, tmp_path, trace):
    run = harness.run_cell(JOB_CELL, 2**33 + 5, 0.01, trace, device="cpu",
                           root=job_root, trace_dir=tmp_path)
    r = run["result"]
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"weight_gap", "edge_gap", "bad_edges"}
    assert r["checks"]["weight_gap"]["value"] < 1e-6
    assert r["attempted"] == run["notes"]["jobs"] >= 1
    if not trace:
        assert set(r["metrics"]) == {"job_s", "setup_s"}
    for f in UNTOUCHED:
        assert (job_root / f).read_bytes() == (
            CHECKOUT / "knnbench" / f).read_bytes()


def test_the_job_cell_makes_its_own_data(job_root):
    cfg = spec.cell(JOB_CELL, job_root)["config"]
    pts = data.make_points(cfg, "cpu", job_root)
    assert pts.shape == (cfg["n"], cfg["d"]) and pts.dtype == torch.float32
    assert torch.equal(pts, data.make_points(cfg, "cpu", job_root))
    # blobs, not the built-in uniform values in [0, 1)
    assert float(pts.min()) < 0.0 or float(pts.max()) > 1.0
    assert data.make_pool(cfg, 3, 0, job_root).shape == (0, cfg["d"])


def test_a_perturbed_job_is_not_correct(job_root, tmp_path):
    cell = spec.cell(JOB_CELL, job_root)
    mode = spec.mode(cell["traffic"]["mode"], job_root)

    def perturbed(points, config, device):
        job = mode.program(points, config, cell["traffic"], device)

        def run():
            us, vs, ws = job()
            ws = np.array(ws, dtype=np.float64)
            ws[0] *= 1 + 1e-3
            return us, vs, ws
        return run

    r = harness.run_cell(JOB_CELL, 9, 0.01, False, device="cpu",
                         root=job_root, index_factory=perturbed,
                         trace_dir=tmp_path)["result"]
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert r["checks"]["edge_gap"]["value"] > 1e-4


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_cells_resolve_as_before(cell):
    c = spec.cell(cell)
    cfg, mode = c["config"], spec.mode(c["traffic"]["mode"])
    assert not hasattr(mode, "program") and not hasattr(mode, "REFERENCE")
    assert harness.program_of(mode) is harness.index_program
    reference = harness.reference_of(mode, cfg)
    assert reference.__file__ == str(
        spec.ROOT / "references" / f"{cfg['metric']}.py")
    compare = harness.comparison(reference)
    assert compare.func is check.compare
    assert compare.keywords == {"reference": reference}
    # the built-in values, bit for bit, at a small n
    small = {**cfg, "n": 1000}
    assert cfg["values"]["distribution"] == "uniform"
    assert torch.equal(data.make_points(small, "cpu"),
                       kb_legacy.make_points(small, "cpu"))
    for seed in (0, 2**33 + 1):
        assert np.array_equal(data.make_pool(small, seed, 50),
                              kb_legacy.make_pool(small, seed, 50))


def test_an_unknown_distribution_is_a_missing_file(tmp_path):
    cfg = {**spec.config("sift1m"), "n": 10,
           "values": {"distribution": "nosuch"}}
    with pytest.raises(FileNotFoundError):
        data.make_points(cfg, "cpu", tmp_path)
    with pytest.raises(ValueError):
        data.make_pool({**cfg, "values": {"distribution": "../x"}}, 1, 4)
