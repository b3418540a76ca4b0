"""The benchmark's 1000-NN graph cells (``nytimes256.batch-k1000`` and
``sift1m.batch-k1000``: HDBSCAN's core distances at ``min_samples`` 1000)
on the CPU: the port's two large-k paths against the plain references,
the cells' files, a small copy of the cosine cell through the unchanged
harness with its TF32 control, and the merge kernel's span, counter and
readers.

At k = 1000 the route keeps ``k_scan`` = 1008 candidates.  Below about
714,000 rows capped would need more than ``PASSES_MAX`` passes, so the
route takes merge (exact, no proof); from there capped serves, with the
proof and a fold repair.  The CPU runs each kernel's plain version, so
the answers' rounding is the card's: the float32 direct-form rescore,
a few units of 2⁻²⁴ from the float64 truth, against the cells' limits of
5·10⁻⁶."""

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
CELLS = ("nytimes256.batch-k1000", "sift1m.batch-k1000")
LIMITS = spec.cell(CELLS[0])["limits"]
K = 1000
#: merge at k = 1000; no multiple of ``PAD_ROWS``
N_MERGE = 8230
#: the fewest rows at which capped keeps 1008 in at most 15 passes is
#: 713,749; this many take capped with 15
N_CAPPED = 720_000
MERGE_SPAN = "petal.route.merge"
READERS = spec.metric_readers()
NEW_READERS = ("merge_ms_per_batch.batch", "merge_per_1000.batch")


def _gaps(reference, pts, qs, dist, ids, k):
    """(rank_gap, id_gap, bad_ids) as the benchmark's check reads them."""
    p, q = torch.from_numpy(pts), torch.from_numpy(qs)
    want, _ = reference.search(p, q, k)
    want = want.numpy()
    ids = np.asarray(ids, dtype=np.int64)
    ok = (ids >= 0) & (ids < pts.shape[0])
    got = reference.distances(p, q,
                              torch.from_numpy(np.where(ok, ids, 0))).numpy()
    rank = np.abs(np.asarray(dist, np.float64) - want) / want
    idg = np.where(ok, np.abs(got - want) / want, 0.0)
    srt = np.sort(ids, axis=1)
    bad = int((~ok).sum() + (srt[:, 1:] == srt[:, :-1]).sum())
    return float(rank.max()), float(idg.max()), bad


@pytest.mark.parametrize("metric,n,d,low,scheme", [
    ("cosine", N_MERGE, 256, -1.0, "merge"),
    ("euclidean", N_CAPPED, 40, 0.0, "capped")])
def test_the_large_k_routes_match_the_reference(metric, n, d, low, scheme):
    rng = np.random.default_rng(n + d)
    high = 1.0 if metric == "cosine" else 255.0
    pts = rng.uniform(low, high, (n, d)).astype(np.float32)
    qs = rng.uniform(low, high, (10, d)).astype(np.float32)
    index = tpn.BruteForce(pts, metric, device="cpu")
    profiling.reset_counters()
    dist, ids = index.query_batch(qs, K)
    assert index.last_backend == "kernel" and index.last_scheme == scheme
    got = profiling.counters()
    assert got.get("knn.merge_queries", 0) == (10 if scheme == "merge" else 0)
    assert ("route.repaired" in got) == (scheme == "capped")
    rank, idg, bad = _gaps(spec.reference(metric), pts, qs, dist.numpy(),
                           ids.numpy(), K)
    assert rank <= LIMITS["rank_gap"] and idg <= LIMITS["id_gap"], (rank, idg)
    assert bad == LIMITS["bad_ids"] == 0


# -- the cells' files ---------------------------------------------------------

@pytest.mark.parametrize("name,config,scheme,passes", [
    ("nytimes256.batch-k1000", "nytimes256", "merge", None),
    ("sift1m.batch-k1000", "sift1m", "capped", 13)])
def test_the_graph_cells_load(name, config, scheme, passes):
    cell = spec.cell(name)
    cfg, trf = cell["config"], cell["traffic"]
    assert cell["config_name"] == config and cell["chips"] == 1
    assert cell["traffic_name"] == "batch-k1000"
    assert trf["mode"] == "batch" and trf["k"] == K
    assert trf["batch"] == "published" and trf["pool"] == 100000
    assert cell["limits"] == {"rank_gap": 5e-6, "id_gap": 5e-6, "bad_ids": 0}
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    assert entry["config"] == config and entry["chips"] == 1
    assert entry["why"] == cell["why"] and len(entry["why"]) <= 200
    # the route the cell drives at its published size
    n, cosine = cfg["n"], cfg["metric"] == "cosine"
    assert tbf.pick_scheme(K, n, tbf.with_bcap_planes(
        n, cfg["d"], cosine)) == scheme
    assert tbf.scan_width(scheme, K, n) == K + tbf.RESCORE_SLACK
    if passes is not None:
        assert tbf.capped_passes(K + tbf.RESCORE_SLACK, tbf.CAPPED_TILE, n,
                                 "capped") == passes


def test_nytimes256_is_the_published_shape():
    cfg = spec.config("nytimes256")
    assert (cfg["n"], cfg["d"], cfg["queries"]) == (290000, 256, 10000)
    assert cfg["metric"] == "cosine" and cfg["dtype"] == "float32"
    assert cfg["values"] == {"distribution": "uniform", "low": -1.0,
                             "high": 1.0}
    assert cfg["data_seed"] == 256001 and cfg["reduced"] == []
    assert "nytimes-256-angular" in cfg["source"] and len(cfg["source"]) <= 200
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["nytimes256"]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    assert entry["file"] == "knnbench/configs/nytimes256.json"
    # the cutover between merge and capped at k = 1000
    assert [tbf.pick_scheme(K, n) for n in (700_000, 713_748, 713_749)] == [
        "merge", "merge", "capped"]


def _tiny_root(tmp_path):
    """A copy of the benchmark's folder with ``nytimes256.batch-k1000``
    cut to a size the CPU runs in a second: its configuration and traffic
    but for ``n``, the batch and the pool, under the cell's limits."""
    root = tmp_path / "knnbench"
    shutil.copytree(CHECKOUT / "knnbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = spec.cell(CELLS[0])
    cfg = {**spec.config("nytimes256"), "name": "tinynyt", "n": N_MERGE,
           "queries": 16}
    trf = {**spec.traffic("batch-k1000"), "pool": 48, "warmup_steps": 1,
           "trace_warmup_steps": 1, "trace_steps": 2}
    (root / "configs" / "tinynyt.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tinynyt-k1000.json").write_text(json.dumps(trf))
    (root / "workloads" / "tinynyt.batch-k1000.json").write_text(json.dumps({
        "config": "tinynyt", "traffic": "tinynyt-k1000", "chips": 1,
        "why": "tests", "limits": cell["limits"]}))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_graph_cell_runs_and_its_control_fails(trace, tmp_path):
    """The cosine graph cell through the unchanged harness: the port's
    answers at k = 1000 are correct against ``references/cosine.py``, the
    TF32 control's are not.  The CPU trace holds no card activity, so the
    merge readers read nothing."""
    root = _tiny_root(tmp_path)
    run = harness.run_cell("tinynyt.batch-k1000", 2**33 + 7, 0.05, trace,
                           device="cpu", root=root, trace_dir=tmp_path)
    r = run["result"]
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] % 16 == 0
    if trace:
        assert not set(NEW_READERS) & set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"qps", "setup_s"}

    def control(points, config, device):
        return harness.ReferenceIndex(spec.reference("cosine", root), points,
                                      "tf32")

    run = harness.run_cell("tinynyt.batch-k1000", 2**33 + 8, 0.05, False,
                           device="cpu", root=root, index_factory=control)
    r = run["result"]
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["rank_gap"]["value"] > 10 * LIMITS["rank_gap"]


# -- the merge kernel's span and counter --------------------------------------

def _spans(prof):
    out = {}
    for e in prof.events():
        if e.name.startswith("petal."):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return out


def _inside(inner, outer):
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


@pytest.mark.parametrize("where", ["petal.route.candidates",
                                   "petal.route.repair"])
def test_the_merge_span_and_counter(where):
    """The merge scheme's candidates, and a repair above ``k_scan`` 1024,
    each run ``knn_merge`` inside ``petal.route.merge``, which lies inside
    the stage that called it; ``knn.merge_queries`` takes the queries."""
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((4096, 40)).astype(np.float32)
    qs = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if where == "petal.route.candidates":
            tbf.knn_prepadded(pp, pn, qs, K, 4096, mu)
        else:
            k_scan = tbf.scan_width("merge", 1100, 4096)
            assert k_scan > tbf.FOLD_K_MAX
            covered = torch.tensor([True, False, True, False, False, True])
            rd = torch.zeros((6, 1100))
            ids = torch.zeros((6, 1100), dtype=torch.int32)
            tbf._prove_repair(covered, rd, ids, pp, pn, qs - mu, 1100,
                              k_scan, 4096)
    spans = _spans(prof)
    (merge,) = spans[MERGE_SPAN]
    assert _inside(merge, spans[where])
    assert profiling.counters()["knn.merge_queries"] == (
        6 if where == "petal.route.candidates" else 3)


# -- the readers, on traces made by hand --------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(with_span):
    """Two steps of 100 µs.  The merge span 10-60 of step 1 launches two
    kernels that run 15-45 and 50-70; that of step 2 (110-150) one that
    runs 120-160; the rescore kernel launched at 80 runs 80-95."""
    ev = [
        _ev("user_annotation", "ProfilerStep#3", 0, 100),
        _ev("user_annotation", "ProfilerStep#4", 100, 100),
        _ev("user_annotation", "petal.route.candidates", 8, 60),
        _ev("user_annotation", MERGE_SPAN, 10, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        _ev("kernel", "collect", 15, 30, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        _ev("kernel", "word_sort", 50, 20, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 79, 1, corr=3),
        _ev("kernel", "gather", 80, 15, corr=3),
        _ev("user_annotation", MERGE_SPAN, 110, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 111, 1, corr=4),
        _ev("kernel", "collect", 120, 40, corr=4),
    ]
    return [e for e in ev if with_span or e["name"] != MERGE_SPAN]


def _records(events, mode="batch"):
    return Records(events, mode=mode, config={"n": N_MERGE, "d": 256},
                   traffic={"k": K}, queries_per_step=16, repair_probe=False)


@pytest.mark.parametrize("mode,with_span,want", [
    ("batch", True, (30 + 20 + 40) * 1e-3 / 2),
    ("batch", False, None),
    ("single", True, None)])
def test_the_merge_ms_reader(mode, with_span, want):
    reader = READERS["merge_ms_per_batch.batch"]
    assert reader.UNIT == "ms"
    got = reader.read(_records(_trace(with_span), mode))
    assert got == (None if want is None else pytest.approx(want))


def test_the_merge_share_reader(monkeypatch):
    reader = READERS["merge_per_1000.batch"]
    assert reader.UNIT == "queries"
    rec = _records(_trace(True))
    monkeypatch.setattr(profiling, "_counters", {})
    assert reader.read(rec) is None
    profiling.count("route.queries", 20_000)
    assert reader.read(rec) is None            # merge never ran
    profiling.count("knn.merge_queries", 20_000)
    assert reader.read(rec) == 1000.0
    profiling.count("route.queries", 5_000)
    assert reader.read(rec) == pytest.approx(800.0)
    assert reader.read(_records(_trace(True), "single")) is None
    assert reader.read(_records([e for e in _trace(True)
                                 if e["cat"] != "kernel"])) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(rec) is None
