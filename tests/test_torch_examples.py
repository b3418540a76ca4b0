"""The port's examples (examples/torch_dbscan.py, torch_optics.py,
torch_hdbscan_core.py) on the CPU against the JAX package's examples and
the oracles of tests/test_dbscan_example.py, test_optics_example.py and
test_hdbscan_example.py, on the same inputs.

Tolerance: DBSCAN labels equal to the JAX example's (the same partition
and numbering); OPTICS ordering, reachability and core distances equal
bit for bit on integer lattice data (exact distances on both sides);
core distances within rtol 1e-6 of the oracle and 1e-12 of the JAX
example's (float64 inputs), the mutual-reachability matrix within 1e-12,
MST weights (sorted) within rtol 1e-12 of the JAX example's (float64) or
1e-4 of the f64 oracle (float32, as the JAX test)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import dbscan as jax_dbscan  # noqa: E402
import hdbscan_core as jax_hdb  # noqa: E402
import optics as jax_optics  # noqa: E402
import torch_dbscan  # noqa: E402
import torch_hdbscan_core as hdb  # noqa: E402
import torch_optics  # noqa: E402

from test_dbscan_example import _same_partition, naive_dbscan  # noqa: E402
from test_optics_example import naive_optics  # noqa: E402

CPU = {"device": "cpu"}


# -- DBSCAN ----------------------------------------------------------------

def test_dbscan_matches_naive_and_jax(rng):
    pts = np.concatenate([
        rng.normal([0, 0], 0.2, (60, 2)),
        rng.normal([4, 4], 0.2, (50, 2)),
        rng.uniform(-2, 6, (15, 2)),
    ])
    ours = torch_dbscan.dbscan(pts, eps=0.5, min_samples=5, batch=32,
                               cap=128, **CPU)
    assert _same_partition(ours, naive_dbscan(pts, eps=0.5, min_samples=5))
    np.testing.assert_array_equal(
        ours, jax_dbscan.dbscan(pts, eps=0.5, min_samples=5, batch=32,
                                cap=128))
    with pytest.raises(ValueError, match="neighbor cap 4 exceeded"):
        torch_dbscan.dbscan(pts, eps=0.5, min_samples=5, cap=4, **CPU)


def test_dbscan_all_noise(rng):
    pts = rng.uniform(0, 100, (40, 2))  # sparse: nothing is core
    labels = torch_dbscan.dbscan(pts, eps=0.5, min_samples=5, **CPU)
    assert (labels == torch_dbscan.NOISE).all()
    np.testing.assert_array_equal(
        labels, jax_dbscan.dbscan(pts, eps=0.5, min_samples=5))


# -- OPTICS ----------------------------------------------------------------

@pytest.mark.parametrize("min_samples", [3, 8])
def test_optics_matches_naive_and_jax(rng, min_samples):
    # integer lattice points: every squared distance is an exact integer,
    # so both packages and the oracle compute the same bits
    pts = np.concatenate([
        rng.integers(0, 12, (60, 2)),
        rng.integers(20, 34, (50, 2)),
        rng.integers(-20, 50, (15, 2)),
    ]).astype(np.float64)
    eps = 3.5
    ours = torch_optics.optics(pts, eps, min_samples, cap=256, **CPU)
    for want in (naive_optics(pts, eps, min_samples),
                 jax_optics.optics(pts, eps, min_samples, cap=256)):
        for a, b in zip(ours, want):
            np.testing.assert_array_equal(a, b)


def test_optics_extracted_clusters_are_sane(rng):
    pts = np.concatenate([
        rng.normal([0, 0], 0.2, (80, 2)),
        rng.normal([5, 5], 0.2, (80, 2)),
    ]).astype(np.float64)
    ordering, reach, core = torch_optics.optics(pts, 2.0, 5, cap=256, **CPU)
    labels = torch_optics.extract_dbscan(ordering, reach, core, 0.5)
    a, b = np.unique(labels[:80]), np.unique(labels[80:])
    a, b = a[a >= 0], b[b >= 0]
    assert len(a) == 1 and len(b) == 1 and a[0] != b[0]
    jo, jr, jc = jax_optics.optics(pts, 2.0, 5, cap=256)
    np.testing.assert_array_equal(
        labels, jax_optics.extract_dbscan(jo, jr, jc, 0.5))


def test_optics_all_sparse_unreachable(rng):
    pts = rng.uniform(0, 100, (40, 2)).astype(np.float64)
    ordering, reach, core = torch_optics.optics(pts, 0.01, 3, cap=64, **CPU)
    assert np.isinf(core).all() and np.isinf(reach).all()
    np.testing.assert_array_equal(ordering, np.arange(40))


# -- HDBSCAN core ------------------------------------------------------------

def _dense(pts):
    p = pts.astype(np.float64)
    return np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))


def test_core_distances_oracle(rng):
    pts = rng.uniform(0, 1, (50, 3))
    got = hdb.core_distances(pts, 4, **CPU)
    np.testing.assert_allclose(got, np.sort(_dense(pts), axis=1)[:, 3],
                               rtol=1e-6)
    np.testing.assert_allclose(got, jax_hdb.core_distances(pts, 4),
                               rtol=1e-12)


def test_mutual_reachability_properties(rng):
    pts = rng.uniform(0, 1, (30, 2))
    m = hdb.mutual_reachability(pts, 3, **CPU)
    assert m.shape == (30, 30)
    np.testing.assert_array_equal(np.diag(m), 0.0)
    np.testing.assert_allclose(m, m.T, atol=1e-7)
    core = hdb.core_distances(pts, 3, **CPU)
    d = _dense(pts)
    off = ~np.eye(30, dtype=bool)
    assert (m[off] >= d[off] - 1e-7).all()
    assert (m[off] >= np.maximum(core[:, None], core[None, :])[off]
            - 1e-7).all()
    np.testing.assert_allclose(m, jax_hdb.mutual_reachability(pts, 3),
                               rtol=1e-12, atol=1e-15)


def test_mst_separates_clusters(rng):
    pts = np.concatenate([
        rng.normal([0, 0], 0.1, (40, 2)),
        rng.normal([10, 10], 0.1, (40, 2)),
    ])
    edges = hdb.mst_edges(pts, k=3, **CPU)
    assert len(edges) == 79
    weights = sorted(e[2] for e in edges)
    assert weights[-1] > 10 and weights[-2] < 1
    np.testing.assert_allclose(
        weights, sorted(e[2] for e in jax_hdb.mst_edges(pts, k=3)),
        rtol=1e-12)


def test_core_distances_uses_dual_join(rng):
    pts = rng.normal(size=(700, 4))
    got = hdb.core_distances(pts, 6, **CPU)
    np.testing.assert_allclose(got, np.sort(_dense(pts), 1)[:, 5],
                               rtol=1e-6)
    np.testing.assert_allclose(got, jax_hdb.core_distances(pts, 6),
                               rtol=1e-12)


def test_mst_matches_host_oracle_end_to_end(rng):
    """The device Prim (dual join, the mutual-reachability matrix, the
    argmin loop) against a host f64 Prim: the same multiset of weights;
    and the scalable MST and the labels against the JAX example's."""
    pts = rng.normal(size=(2000, 3)).astype(np.float32)
    k = 5
    edges = hdb.mst_edges(pts, k, **CPU)
    assert len(edges) == 1999
    got_w = np.sort([e[2] for e in edges])
    d = _dense(pts)
    core = np.sort(d, 1)[:, k - 1]
    m = np.maximum(d, np.maximum(core[:, None], core[None, :]))
    np.fill_diagonal(m, 0.0)
    in_tree = np.zeros(len(m), bool)
    in_tree[0] = True
    best, want_w = m[0].copy(), []
    for _ in range(len(m) - 1):
        j = int(np.argmin(np.where(in_tree, np.inf, best)))
        want_w.append(best[j])
        in_tree[j] = True
        best = np.minimum(best, m[j])
    np.testing.assert_allclose(got_w, np.sort(want_w), rtol=1e-4)
    us, vs, ws = hdb.mst_edges_scalable(pts, k, **CPU)
    np.testing.assert_allclose(np.sort(ws), got_w, rtol=1e-6)
    labels, probs = hdb.hdbscan_labels(pts[:500], 10, **CPU)
    jl, jp = jax_hdb.hdbscan_labels(pts[:500], 10)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(probs, jp, rtol=1e-5)
