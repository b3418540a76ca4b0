"""The port's spans and counters (``utils/profiling.py`` ``span``,
``count``) on the CPU, and the benchmark's readers of them on Chrome
traces made by hand.

With no profiler recording, a span is one shared no-op context and the
answers do not change; under ``torch.profiler`` the k-NN path records
``petal.query`` and ``petal.query_batch`` at the index API and the
``petal.route.*`` stages inside ``petal.route``; the counters
``route.queries`` and ``route.repaired`` count the routed and the
repaired queries."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import petal_neighbors_tpu_torch as tpn
from knnbench import spec
from knnbench.trace import Records
from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.utils import profiling

N_Q = 24
K = 5

STAGES = ("petal.route.prep", "petal.route.candidates",
          "petal.route.rescore", "petal.route.out")
PROOF = ("petal.route.proof", "petal.route.repair")

READERS = spec.metric_readers()
NEW_READERS = ("rescore_ms_per_batch.batch",
               "route_repair_ms_per_batch.batch", "repaired_per_1000.batch",
               "api_idle_ms_per_query.single",
               "route_idle_ms_per_query.single")


def _spans(prof):
    """{name: [(start, end), ...]} of the ``petal.*`` spans recorded."""
    out = {}
    for e in prof.events():
        if e.name.startswith("petal."):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return out


def _inside(inner, outer):
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def _identical_points():
    """All-equal points: every tile overflows its passes, so the proof of
    bcap and capped leaves queries to the repair."""
    rng = np.random.default_rng(8)
    pts = np.ones((4096, 8), np.float32)
    qs = rng.standard_normal((N_Q, 8)).astype(np.float32)
    return tbf.prepare_euclidean_index(torch.from_numpy(pts)), qs


# -- the helpers ---------------------------------------------------------------

def test_span_is_a_shared_no_op_without_a_profiler():
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("a")
    assert isinstance(on, torch.profiler.record_function)


def test_counters_add_copy_and_reset():
    profiling.reset_counters()
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 0)
    got = profiling.counters()
    assert got == {"x": 5, "y": 0}
    got["x"] = 99
    assert profiling.counters()["x"] == 5
    profiling.reset_counters()
    assert profiling.counters() == {}
    assert {"span", "count", "counters", "reset_counters"} <= set(
        profiling.__all__)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan",
                                    "sqeuclidean"])
def test_no_record_function_without_a_profiler(metric, monkeypatch):
    """Every route of the index (Euclidean and cosine kernels, Lp kernel,
    scan) gives the same answers with ``record_function`` made to raise:
    no span enters it while no profiler records."""
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((4096, 40)).astype(np.float32)
    qs = rng.standard_normal((6, 40)).astype(np.float32)
    index = tpn.BruteForce(pts, metric, device="cpu")
    want_batch = index.query_batch(qs, K)
    want_one = index.query(qs[0], K)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got_batch = index.query_batch(qs, K)
    got_one = index.query(qs[0], K)
    for w, g in zip(want_batch, got_batch):
        assert torch.equal(w, g)
    for w, g in zip(want_one, got_one):
        np.testing.assert_array_equal(w, g)


# -- the route's spans and counters --------------------------------------------

@pytest.mark.parametrize("scheme", ["bcap", "capped", "fold"])
def test_route_records_every_stage(scheme, monkeypatch):
    """Each stage's span lies inside its ``petal.route``; bcap and capped
    also record the proof and the repair, fold has neither.  The counters
    take the batch size and the queries that reached the repair."""
    (mu, pp, pn, _), qs = _identical_points()
    uncovered = []
    orig = tbf._prove_repair

    def probe(covered, *args, **kwargs):
        uncovered.append(int((~covered).sum()))
        return orig(covered, *args, **kwargs)

    monkeypatch.setattr(tbf, "_prove_repair", probe)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dd, ii = tbf.knn_prepadded(pp, pn, torch.from_numpy(qs), K, 4096, mu,
                                   scheme=scheme)
    want = np.sqrt(((qs - 1.0) ** 2).sum(-1))
    np.testing.assert_allclose(dd.numpy(), np.repeat(want[:, None], K, 1),
                               rtol=1e-5, atol=1e-5)
    spans = _spans(prof)
    gated = scheme != "fold"
    expected = set(STAGES) | (set(PROOF) if gated else set())
    assert set(spans) == expected | {"petal.route"}
    assert len(spans["petal.route"]) == 1
    for name in expected:
        assert len(spans[name]) == 1, name
        assert _inside(spans[name][0], spans["petal.route"]), name
    got = profiling.counters()
    assert got["route.queries"] == N_Q
    if gated:
        assert uncovered and uncovered[0] > 0
        assert got["route.repaired"] == sum(uncovered)
    else:
        assert "route.repaired" not in got and not uncovered


def test_route_counts_a_proof_with_nothing_to_repair(monkeypatch):
    """A batch the proof covers whole still counts: ``route.repaired``
    reads 0 once the proof-gated route has run."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((4096, 8)).astype(np.float32)
    mu, pp, pn, _ = tbf.prepare_euclidean_index(torch.from_numpy(pts))
    covered_all = []
    orig = tbf._prove_repair

    def probe(covered, *args, **kwargs):
        covered_all.append(bool(covered.all()))
        return orig(covered, *args, **kwargs)

    monkeypatch.setattr(tbf, "_prove_repair", probe)
    profiling.reset_counters()
    tbf.knn_prepadded(pp, pn, torch.from_numpy(pts[:N_Q]), 1, 4096, mu,
                      scheme="capped")
    got = profiling.counters()
    assert got["route.queries"] == N_Q
    assert covered_all == [True]
    assert got["route.repaired"] == 0


def test_query_nests_the_route_in_the_index_api():
    """``BruteForce.query``: ``petal.query`` holds ``petal.query_batch``,
    which holds ``petal.route``; the copies to the host follow the route
    inside ``petal.query``."""
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((4096, 40)).astype(np.float32)
    index = tpn.BruteForce(pts, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.query(pts[7], K)
    spans = _spans(prof)
    (query,) = spans["petal.query"]
    (batch,) = spans["petal.query_batch"]
    (route,) = spans["petal.route"]
    (host,) = spans["petal.query.to_host"]
    assert _inside(batch, [query]) and _inside(route, [batch])
    assert _inside(host, [query]) and host[0] >= route[1]


# -- the benchmark's readers, on traces made by hand ---------------------------

def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def batch_trace():
    """Two steps of 100 µs.  Step 1: the rescore span 10-20 launches a
    kernel that runs 22-32; the repair span 40-50 launches one that runs
    50-80; a kernel launched outside both runs 85-95.  Step 2: the rescore
    span 110-120 launches a kernel that runs 125-130."""
    return [
        ev("user_annotation", "ProfilerStep#3", 0, 100),
        ev("user_annotation", "ProfilerStep#4", 100, 100),
        ev("user_annotation", "petal.route", 5, 90),
        ev("user_annotation", "petal.route.rescore", 10, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        ev("kernel", "gather", 22, 10, corr=1),
        ev("user_annotation", "petal.route.repair", 40, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=2),
        ev("kernel", "fold", 50, 30, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 82, 1, corr=3),
        ev("kernel", "bcap", 85, 10, corr=3),
        ev("user_annotation", "petal.route.rescore", 110, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 115, 1, corr=4),
        ev("kernel", "topk", 125, 5, corr=4),
    ]


def single_trace():
    """Two queries.  Query 1: ``petal.query`` 22-98 with an upload 25-28,
    ``petal.route`` 30-78 with kernels 40-60 and 65-70, a copy back
    85-90.  Query 2: ``petal.query`` 152-198, ``petal.route`` 160-190
    with a kernel 165-185.  The harness waits 0-20 and 100-150."""
    return [
        ev("user_annotation", "ProfilerStep#1", 0, 100),
        ev("user_annotation", "knnbench.pace_wait", 0, 20),
        ev("user_annotation", "knnbench.query", 20, 80),
        ev("user_annotation", "petal.query", 22, 76),
        ev("user_annotation", "petal.query_batch", 24, 56),
        ev("gpu_memcpy", "Memcpy HtoD", 25, 3),
        ev("user_annotation", "petal.route", 30, 48),
        ev("kernel", "bcap", 40, 20),
        ev("kernel", "gather", 65, 5),
        ev("user_annotation", "petal.query.to_host", 80, 16),
        ev("gpu_memcpy", "Memcpy DtoH", 85, 5),
        ev("user_annotation", "ProfilerStep#2", 100, 100),
        ev("user_annotation", "knnbench.pace_wait", 100, 50),
        ev("user_annotation", "knnbench.query", 150, 50),
        ev("user_annotation", "petal.query", 152, 46),
        ev("user_annotation", "petal.route", 160, 30),
        ev("kernel", "bcap", 165, 20),
    ]


def records(events, mode):
    return Records(events, mode=mode, config={"n": 8192, "d": 40},
                   traffic={"k": 10}, queries_per_step=10 if mode == "batch"
                   else 1, repair_probe=False)


def test_batch_readers_read_the_program_spans():
    rec = records(batch_trace(), "batch")
    assert READERS["rescore_ms_per_batch.batch"].read(rec) == pytest.approx(
        (10 + 5) * 1e-3 / 2)
    assert READERS["route_repair_ms_per_batch.batch"].read(
        rec) == pytest.approx(30 * 1e-3 / 2)
    for m in ("api_idle_ms_per_query.single",
              "route_idle_ms_per_query.single"):
        assert READERS[m].read(rec) is None


def test_single_readers_read_the_idle_time_by_span():
    rec = records(single_trace(), "single")
    # query 1: petal.query 76 µs, 33 busy; petal.route 48 µs, 25 busy
    # query 2: petal.query 46 µs, 20 busy; petal.route 30 µs, 20 busy
    route_idle = (48 - 25) + (30 - 20)
    query_idle = (76 - 33) + (46 - 20)
    assert READERS["route_idle_ms_per_query.single"].read(
        rec) == pytest.approx(route_idle * 1e-3 / 2)
    assert READERS["api_idle_ms_per_query.single"].read(
        rec) == pytest.approx((query_idle - route_idle) * 1e-3 / 2)
    # both lie inside the serving time's idle that device_idle_pct reads
    serving_idle = rec.serving_us() - rec.busy_serving_us()
    assert query_idle <= serving_idle
    for m in ("rescore_ms_per_batch.batch", "route_repair_ms_per_batch.batch",
              "repaired_per_1000.batch"):
        assert READERS[m].read(rec) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_read_nothing_without_the_program_spans(name, monkeypatch):
    """A trace with no ``petal.*`` span (a program that records none) and a
    process with no counters give None, never 0."""
    monkeypatch.setattr(profiling, "_counters", {})
    mode = name.rsplit(".", 1)[1]
    trace = batch_trace() if mode == "batch" else single_trace()
    rec = records([e for e in trace if not e["name"].startswith("petal.")],
                  mode)
    assert READERS[name].read(rec) is None


def test_repaired_per_1000_reads_the_program_counters(monkeypatch):
    rec = records(batch_trace(), "batch")
    reader = READERS["repaired_per_1000.batch"]
    monkeypatch.setattr(profiling, "_counters", {})
    profiling.count("route.queries", 40_000)
    assert reader.read(rec) is None            # the proof never ran
    profiling.count("route.repaired", 0)
    assert reader.read(rec) == 0.0
    profiling.count("route.repaired", 18)
    assert reader.read(rec) == pytest.approx(1000 * 18 / 40_000)
    # no card activity in the trace, or no counters in the program
    assert reader.read(records([e for e in batch_trace()
                                if e["cat"] != "kernel"], "batch")) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(rec) is None
