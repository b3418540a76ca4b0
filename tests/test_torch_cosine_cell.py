"""The cosine layout of the port's flat index against the benchmark's plain
cosine reference (``knnbench/references/cosine.py``), the benchmark's
``glove100`` and ``sift1m.batch-k100`` cells, and the span and counter of
the route's query normalisation, on the CPU.

The port answers in float32: the route normalises each query in float32
(one rounding an element) and re-scores its candidates in the direct form
``‖q̂ − x̂‖²/2`` over d float32 terms, so its distances near 0.5 sit a few
units of 2⁻²⁴ from the float64 truth (2-3·10⁻⁷ relative at d = 100 and
128).  The comparison takes the ``glove100`` cell's own limits, 5·10⁻⁶:
twenty times that error, and thirty times below the TF32 control's
1.3-1.7·10⁻⁴, whose 10-bit mantissa moves a unit row's product by about
2⁻¹¹/√d."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import petal_neighbors_tpu_torch as tpn
from knnbench import harness, spec
from knnbench.trace import Records
from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.utils import profiling

CHECKOUT = Path(__file__).resolve().parents[1]
REF = spec.reference("cosine")
LIMITS = spec.cell("glove100.batch-k10")["limits"]
#: above ``KERNEL_MIN_N`` and no multiple of ``PAD_ROWS``
N = 8230
N_Q = 48


def _data(d, seed, n=N, q=N_Q):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    qs = rng.uniform(-1.0, 1.0, (q, d)).astype(np.float32)
    return pts, qs


def _gaps(pts, qs, dist, ids, k):
    """(rank_gap, id_gap, bad_ids) as the benchmark's check reads them:
    each served distance and the reference's distance to each served id
    against the reference's r-th distance, relative; ids out of range or
    repeated in a row."""
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    want, _ = REF.search(p, q, k)
    want = want.numpy()
    ids = np.asarray(ids, dtype=np.int64)
    ok = (ids >= 0) & (ids < pts.shape[0])
    got = REF.distances(p, q, torch.from_numpy(np.where(ok, ids, 0))).numpy()
    rank = np.abs(np.asarray(dist, np.float64) - want) / want
    idg = np.where(ok, np.abs(got - want) / want, 0.0)
    srt = np.sort(ids, axis=1)
    bad = int((~ok).sum() + (srt[:, 1:] == srt[:, :-1]).sum())
    return float(rank.max()), float(idg.max()), bad


def _force(monkeypatch, scheme):
    """``"auto"`` leaves ``pick_scheme`` alone (fold at this n); a scheme
    name makes the index take it, as capped at 1M rows."""
    if scheme != "auto":
        monkeypatch.setattr(tbf, "pick_scheme", lambda *a, **kw: scheme)


@pytest.mark.parametrize("scheme", ["auto", "capped"])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("d", [100, 128])
def test_cosine_index_matches_the_reference(d, k, scheme, monkeypatch):
    _force(monkeypatch, scheme)
    pts, qs = _data(d, 100 * d + k)
    index = tpn.BruteForce(pts, "cosine", device="cpu")
    dist, ids = index.query_batch(qs, k)
    assert index.last_backend == "kernel"
    assert index.last_scheme == ("fold" if scheme == "auto" else scheme)
    rank, idg, bad = _gaps(pts, qs, dist.numpy(), ids.numpy(), k)
    assert rank <= LIMITS["rank_gap"] and idg <= LIMITS["id_gap"], (rank, idg)
    assert bad == LIMITS["bad_ids"] == 0


@pytest.mark.parametrize("scheme", ["auto", "capped"])
@pytest.mark.parametrize("k", [10, 100])
def test_zero_norm_and_nan_rows_are_never_returned(k, scheme, monkeypatch):
    """Zero-norm rows (0/0) and NaN rows, some of them copies of a query's
    direction but for the zeroing, never appear; the answers are the
    reference's, which takes them as farthest."""
    _force(monkeypatch, scheme)
    pts, qs = _data(100, 7 + k)
    bad_rows = np.arange(0, N, 97)
    pts[bad_rows[::2]] = 0.0
    pts[bad_rows[1::2]] = qs[0]
    pts[bad_rows[1::2], 3] = np.nan
    index = tpn.BruteForce(pts, "cosine", device="cpu")
    dist, ids = index.query_batch(qs, k)
    assert not np.isin(ids.numpy(), bad_rows).any()
    assert torch.isfinite(dist).all()
    _, ref_ids = REF.search(torch.from_numpy(pts), torch.from_numpy(qs), k)
    assert not np.isin(ref_ids.numpy(), bad_rows).any()
    rank, idg, bad = _gaps(pts, qs, dist.numpy(), ids.numpy(), k)
    assert rank <= LIMITS["rank_gap"] and idg <= LIMITS["id_gap"], (rank, idg)
    assert bad == 0


@pytest.mark.parametrize("k", [10, 100])
def test_the_tf32_control_fails_the_limits(k):
    pts, qs = _data(100, 31 + k)
    dist, ids = REF.search(torch.from_numpy(pts), torch.from_numpy(qs), k,
                           precision="tf32")
    rank, _, _ = _gaps(pts, qs, dist.numpy(), ids.numpy(), k)
    assert rank > 10 * LIMITS["rank_gap"], rank
    with pytest.raises(ValueError):
        REF.search(torch.from_numpy(pts), torch.from_numpy(qs), k,
                   precision="bf16")


def test_the_reference_matches_a_numpy_brute_force():
    """Ties included: copies of one row share a distance, and the ids of a
    tied run may come in any order."""
    rng = np.random.default_rng(5)
    pts = rng.integers(-3, 4, size=(300, 6)).astype(np.float32)
    pts[200:230] = pts[7] * 2.0
    pts[0] = 0.0
    qs = np.concatenate([pts[7:8], rng.integers(-3, 4, (8, 6))]
                        ).astype(np.float32)
    qs[np.abs(qs).sum(1) == 0, 0] = 1.0
    x, q = pts.astype(np.float64), qs.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        full = 1.0 - (q @ x.T) / np.outer(np.linalg.norm(q, axis=1),
                                          np.linalg.norm(x, axis=1))
    full = np.where(np.isnan(full), np.inf, full)
    for k in (1, 10, 31, 40):
        want = np.sort(full, axis=1)[:, :k]
        dist, ids = REF.search(torch.from_numpy(pts), torch.from_numpy(qs), k)
        assert dist.dtype == torch.float64 and ids.shape == want.shape
        np.testing.assert_allclose(dist.numpy(), want, rtol=0, atol=1e-15)
        np.testing.assert_allclose(np.take_along_axis(full, ids.numpy(), 1),
                                   want, rtol=0, atol=1e-15)
        assert not (ids.numpy() == 0).any()
        assert all(len(set(r.tolist())) == k for r in ids.numpy())


# -- the benchmark's new cells ------------------------------------------------

@pytest.mark.parametrize("name,config,k,d", [
    ("glove100.batch-k10", "glove100", 10, 100),
    ("sift1m.batch-k100", "sift1m", 100, 128)])
def test_the_new_cells_load(name, config, k, d):
    cell = spec.cell(name)
    cfg = cell["config"]
    assert cell["config_name"] == config and cell["chips"] == 1
    assert cell["traffic"]["mode"] == "batch" and cell["traffic"]["k"] == k
    assert cell["traffic"]["batch"] == "published" and cfg["queries"] == 10000
    assert cfg["d"] == d and cfg["reduced"] == []
    assert spec.reference(cfg["metric"]).search is not None
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    assert name in {w["name"] for w in bench["workloads"]}
    # the route the cell drives at its published size
    n = cfg["n"]
    cosine = cfg["metric"] == "cosine"
    assert tbf.pick_scheme(k, n, tbf.with_bcap_planes(
        n, cfg["d"], cosine)) == "capped"
    assert tbf.scan_width("capped", k, n) == k + tbf.RESCORE_SLACK


def test_glove100_is_the_published_shape():
    cfg = spec.config("glove100")
    assert (cfg["n"], cfg["d"], cfg["queries"]) == (1183514, 100, 10000)
    assert cfg["metric"] == "cosine" and cfg["dtype"] == "float32"
    assert cfg["values"] == {"distribution": "uniform", "low": -1.0,
                             "high": 1.0}
    assert "glove-100-angular" in cfg["source"] and len(cfg["source"]) <= 200
    assert cfg["assumed"] and cfg["n"] % tbf.PAD_ROWS


def _tiny_root(tmp_path):
    """A copy of the benchmark's folder with a cosine cell small enough for
    the CPU, under the ``glove100`` cell's limits."""
    root = tmp_path / "knnbench"
    shutil.copytree(CHECKOUT / "knnbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def write(rel, obj):
        (root / rel).write_text(json.dumps(obj))

    write("configs/tinycos.json", {
        "name": "tinycos", "source": "tests", "n": N, "d": 100,
        "queries": 64, "metric": "cosine", "dtype": "float32",
        "values": {"distribution": "uniform", "low": -1.0, "high": 1.0},
        "data_seed": 11, "assumed": [], "reduced": []})
    write("traffic/tinycos-batch.json", {
        "mode": "batch", "k": 10, "batch": "published", "pool": 256,
        "warmup_steps": 1, "trace_warmup_steps": 1, "trace_steps": 2})
    write("workloads/tinycos.batch.json", {
        "config": "tinycos", "traffic": "tinycos-batch", "chips": 1,
        "why": "tests", "limits": LIMITS})
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cosine_cell_runs_and_its_control_fails(trace, tmp_path):
    """A cosine cell through the unchanged harness: the port's answers are
    correct against ``references/cosine.py``, the TF32 control's are not."""
    root = _tiny_root(tmp_path)
    run = harness.run_cell("tinycos.batch", 2**33 + 3, 0.05, trace,
                           device="cpu", root=root, trace_dir=tmp_path)
    r = run["result"]
    assert r["correct"] and r["failed"] == 0, r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"qps", "setup_s"}

    def control(points, config, device):
        return harness.ReferenceIndex(spec.reference("cosine", root), points,
                                      "tf32")

    run = harness.run_cell("tinycos.batch", 2**33 + 4, 0.05, False,
                           device="cpu", root=root, index_factory=control)
    r = run["result"]
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["rank_gap"]["value"] > LIMITS["rank_gap"]


# -- the normalisation's span and counter -------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_route_normalized_counts_the_cosine_queries(metric):
    pts, qs = _data(40, 3, n=4096, q=24)
    index = tpn.BruteForce(pts, metric, device="cpu")
    profiling.reset_counters()
    index.query_batch(qs, 5)
    index.query(qs[0], 5)
    got = profiling.counters()
    assert got["route.queries"] == 25
    assert got.get("route.normalized", 0) == (25 if metric == "cosine"
                                              else 0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_the_normalize_span_lies_inside_the_prep(metric):
    pts, qs = _data(40, 4, n=4096, q=6)
    index = tpn.BruteForce(pts, metric, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.query_batch(qs, 5)
    spans = {}
    for e in prof.events():
        if e.name.startswith("petal."):
            spans.setdefault(e.name, []).append((e.time_range.start,
                                                 e.time_range.end))
    if metric == "euclidean":
        assert "petal.route.normalize" not in spans
        return
    (norm,) = spans["petal.route.normalize"]
    (prep,) = spans["petal.route.prep"]
    assert prep[0] <= norm[0] and norm[1] <= prep[1]


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(with_span):
    """Two steps of 100 µs.  The normalisation span 10-14 of step 1 launches
    a kernel that runs 15-17, that of step 2 (110-114) one that runs
    116-120; the candidate kernel launched at 30 runs 40-90."""
    ev = [
        _ev("user_annotation", "ProfilerStep#3", 0, 100),
        _ev("user_annotation", "ProfilerStep#4", 100, 100),
        _ev("user_annotation", "petal.route.prep", 8, 10),
        _ev("user_annotation", "petal.route.normalize", 10, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        _ev("kernel", "div", 15, 2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _ev("kernel", "capped", 40, 50, corr=2),
        _ev("user_annotation", "petal.route.prep", 108, 10),
        _ev("user_annotation", "petal.route.normalize", 110, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 111, 1, corr=3),
        _ev("kernel", "div", 116, 4, corr=3),
    ]
    return [e for e in ev if with_span or e["name"] != "petal.route.normalize"]


@pytest.mark.parametrize("mode,with_span,want", [
    ("batch", True, (2 + 4) * 1e-3 / 2),
    ("batch", False, None),
    ("single", True, None)])
def test_the_normalize_reader(mode, with_span, want):
    reader = spec.metric_readers()["normalize_ms_per_batch.batch"]
    assert reader.UNIT == "ms"
    rec = Records(_trace(with_span), mode=mode, config={"n": N, "d": 100},
                  traffic={"k": 10}, queries_per_step=10,
                  repair_probe=False)
    got = reader.read(rec)
    assert got == (None if want is None else pytest.approx(want))
