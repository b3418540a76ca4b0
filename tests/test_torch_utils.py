"""The port's serving and profiling helpers on the CPU: ``QueryStream``
against ``query_batch`` and the JAX package's stream (the case of
tests/test_utils.py), ``wall_time``, and ``trace`` writing its Chrome
trace.

Tolerance: the stream's rows equal one ``query_batch``'s bit for bit (the
same index, the same rows), and the JAX package's stream's ids exactly,
its distances within rtol 1e-6 (f32)."""

import json

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
from petal_neighbors_tpu_torch import AsyncResult, BruteForce, QueryStream
from petal_neighbors_tpu_torch.utils.profiling import trace, wall_time


@pytest.fixture
def index_and_queries(rng):
    pts = rng.standard_normal((500, 8)).astype(np.float32)
    qs = rng.standard_normal((20, 8)).astype(np.float32)
    return pts, qs, BruteForce.euclidean(pts, device="cpu")


def test_pipelined_results_match_sync(index_and_queries):
    pts, qs, idx = index_and_queries
    got = QueryStream(idx, k=5).query_many(qs)
    want_d, want_i = idx.query_batch(qs, 5)
    jgot = jpn.QueryStream(jpn.BruteForce.euclidean(pts), k=5).query_many(qs)
    for row, (ids, d) in enumerate(got):
        assert ids.dtype == np.int64 and isinstance(d, np.ndarray)
        np.testing.assert_array_equal(ids, want_i[row].numpy())
        np.testing.assert_array_equal(d, want_d[row].numpy())
        np.testing.assert_array_equal(ids, jgot[row][0])
        np.testing.assert_allclose(d, jgot[row][1], rtol=1e-6)


def test_flushes_in_groups_and_interleaved(index_and_queries):
    """Each flush answers the submits since the previous one with one
    ``query_batch`` call; handles read their own rows in any order."""
    _, qs, idx = index_and_queries
    calls = []
    real = idx.query_batch

    def counted(batch, k):
        calls.append(batch.shape[0])
        return real(batch, k)

    idx.query_batch = counted
    stream = QueryStream(idx, k=3)
    handles = [stream.submit(torch.from_numpy(q)) for q in qs[:7]]
    assert all(isinstance(h, AsyncResult) for h in handles) and calls == []
    last = handles[-1].result()
    stream.flush()                        # nothing pending: no call
    late = stream.submit(qs[7])
    first = handles[0].result()
    assert calls == [7]
    assert late.result() is late.result() and calls == [7, 1]
    want_d, want_i = real(qs[:8], 3)
    np.testing.assert_array_equal(first[0], want_i[0].numpy())
    np.testing.assert_array_equal(last[1], want_d[6].numpy())
    np.testing.assert_array_equal(late.result()[0], want_i[7].numpy())


def test_wall_time(index_and_queries):
    _, qs, idx = index_and_queries
    out = {}
    with wall_time(out, "knn_s") as o:
        o["result"] = idx.query_batch(qs, 4)
    assert out["knn_s"] > 0 and out["result"][0].shape == (20, 4)
    empty = {}
    with wall_time(empty):
        pass
    assert empty["seconds"] >= 0


def test_trace_writes_a_chrome_trace(index_and_queries, tmp_path):
    _, qs, idx = index_and_queries
    with trace(str(tmp_path / "knn")):
        idx.query_batch(qs, 4)
    path = tmp_path / "knn" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("topk" in e.get("name", "") or "sort" in e.get("name", "")
               for e in events)
