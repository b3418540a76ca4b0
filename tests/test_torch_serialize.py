"""The port's ``save_index`` / ``load_index`` on the CPU: the round trips
of tests/test_serialize.py on the port, and files crossing between the two
packages both ways for every kind.

Tolerance: a file re-saved after a load (by either package) holds every
array of the original bit for bit, dtypes included; a reloaded index gives
the same answers as the one saved, bit for bit within a package, and as
tests/test_torch_ball_tree.py's ``assert_knn_match`` across packages
(distances within rtol 1e-6, ids equal except at ties)."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu_torch import (BallTree, BruteForce, DynamicIndex,
                                       Minkowski, VantagePointTree,
                                       load_index, save_index)

from test_torch_ball_tree import assert_knn_match

CPU = {"device": "cpu"}


def _same_files(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def _equal_answers(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class TestBallRoundTrip:
    def test_bit_identical(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (50, 3))
        t = BallTree.euclidean(pts, leaf_size=8, **CPU)
        p = tmp_path / "ball.npz"
        t.save(p)
        t2 = load_index(p, **CPU)
        np.testing.assert_array_equal(t.idx, t2.idx)
        assert torch.equal(t.nodes.centroids, t2.nodes.centroids)
        assert torch.equal(t.nodes.radii, t2.nodes.radii)
        assert t2.metric == t.metric
        q = rng.uniform(0, 1, 3)
        i1, d1 = t.query(q, 5)
        i2, d2 = t2.query(q, 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)

    def test_reference_sizing_preserved(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (13, 2))
        t = BallTree.euclidean(pts, leaf_size=None, **CPU)
        p = tmp_path / "b.npz"
        t.save(p)
        t2 = load_index(p, **CPU)
        assert t2.num_nodes() == t.num_nodes()

    def test_minkowski_metric_round_trip(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (20, 3))
        t = BallTree(pts, Minkowski(3.0), leaf_size=4, **CPU)
        p = tmp_path / "m.npz"
        t.save(p)
        t2 = load_index(p, **CPU)
        assert isinstance(t2.metric, Minkowski) and t2.metric.p == 3.0


class TestVantageRoundTrip:
    def test_structure_and_queries(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (40, 4))
        v = VantagePointTree.euclidean(pts, **CPU)
        p = tmp_path / "vp.npz"
        v.save(p)
        v2 = load_index(p, **CPU)
        for key in ("vantage_point", "radius", "near", "far"):
            np.testing.assert_array_equal(v.nodes[key], v2.nodes[key])
        assert v2.root == v.root
        for a, b in zip(v._flat_tables(), v2._flat):
            assert a.dtype == b.dtype and torch.equal(a, b)
        q = rng.uniform(0, 1, 4)
        assert v.query_nearest(q) == v2.query_nearest(q)


class TestBruteRoundTrip:
    def test_round_trip(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (30, 3)).astype(np.float32)
        b = BruteForce.euclidean(pts, **CPU)
        p = tmp_path / "bf.npz"
        b.save(p)
        b2 = load_index(p, **CPU)
        q = rng.uniform(0, 1, 3).astype(np.float32)
        i1, d1 = b.query(q, 4)
        i2, d2 = b2.query(q, 4)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)


def test_device_built_trees_round_trip(rng, tmp_path):
    pts = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    q = rng.uniform(0, 1, 3).astype(np.float32)
    t = BallTree.euclidean(pts, builder="device", **CPU)
    t.save(tmp_path / "bd.npz")
    t2 = load_index(tmp_path / "bd.npz", **CPU)
    assert t.query(q, 5)[1].tolist() == t2.query(q, 5)[1].tolist()
    v = VantagePointTree(pts, "euclidean", builder="device", **CPU)
    v.save(tmp_path / "vd.npz")
    v2 = load_index(tmp_path / "vd.npz", **CPU)
    assert v.query_nearest(q) == v2.query_nearest(q)


class TestDynamicRoundTrip:
    def test_pending_mutations_survive(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (300, 3))
        idx = DynamicIndex(pts, rebuild_threshold=10.0, **CPU)
        added = idx.add(rng.uniform(0, 1, (40, 3)))
        idx.remove([3, 7, int(added[0])])
        p = tmp_path / "dyn.npz"
        idx.save(p)
        back = load_index(p, **CPU)
        assert back.num_points == idx.num_points
        assert back._next_id == idx._next_id
        assert back._tombstones == idx._tombstones
        np.testing.assert_array_equal(back._base_ids, idx._base_ids)
        qs = rng.uniform(0, 1, (16, 3))
        _equal_answers(idx.query_batch(qs, 7), back.query_batch(qs, 7))
        np.testing.assert_array_equal(idx.query_radius(qs[0], 0.4),
                                      back.query_radius(qs[0], 0.4))
        np.testing.assert_array_equal(idx.add(qs[1]), back.add(qs[1]))

    def test_clean_state_round_trip(self, rng, tmp_path):
        pts = rng.uniform(0, 1, (64, 2))
        idx = DynamicIndex(pts, **CPU)
        p = tmp_path / "dyn2.npz"
        idx.save(p)
        back = load_index(p, **CPU)
        q = rng.uniform(0, 1, 2)
        np.testing.assert_array_equal(idx.query(q, 5)[0],
                                      back.query(q, 5)[0])


# -- files across the two packages ----------------------------------------

def _index(pkg, kind, pts, rng):
    """The same index built by the JAX package or by the port; the
    dynamic one with pending adds and removes."""
    if kind == "ball":
        return (jpn.BallTree.euclidean(pts, leaf_size=16) if pkg is jpn
                else tpn.BallTree.euclidean(pts, leaf_size=16, **CPU))
    if kind == "vantage":
        return (jpn.VantagePointTree.euclidean(pts) if pkg is jpn
                else tpn.VantagePointTree.euclidean(pts, **CPU))
    if kind == "brute":
        return (jpn.BruteForce.euclidean(pts) if pkg is jpn
                else tpn.BruteForce.euclidean(pts, **CPU))
    idx = (jpn.DynamicIndex(pts[:300], leaf_size=16, rebuild_threshold=10.0)
           if pkg is jpn else tpn.DynamicIndex(
               pts[:300], leaf_size=16, rebuild_threshold=10.0, **CPU))
    idx.add(pts[300:])
    idx.remove([2, 5, 301, 330])
    return idx


def _load(pkg, path):
    return jpn.load_index(path) if pkg is jpn else tpn.load_index(path, **CPU)


def _answers(pkg, index, qs):
    if pkg is jpn:
        return index.query_batch(qs, 6)
    return index.query_batch(torch.from_numpy(qs), 6)


@pytest.mark.parametrize("kind", ["ball", "vantage", "brute", "dynamic"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_load(kind, direction, tmp_path):
    """A file of one package loads in the other: re-saved there it holds
    the same arrays bit for bit, and the loaded index answers as the saved
    one."""
    src, dst = (jpn, tpn) if direction == "jax_to_torch" else (tpn, jpn)
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(360, 5)).astype(np.float32)
    qs = rng.normal(size=(25, 5)).astype(np.float32)
    saved = _index(src, kind, pts, rng)
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    saved.save(a)
    loaded = _load(dst, a)
    assert type(loaded).__name__ == type(saved).__name__
    loaded.save(b)
    _same_files(a, b)
    want, got = _answers(src, saved, qs), _answers(dst, loaded, qs)
    if dst is tpn:
        assert_knn_match(want, got, np.float32)
    else:
        assert_knn_match(got, want, np.float32)


def test_v2_vantage_file_without_flat_tables(tmp_path):
    """A v2 file has no flat tables: the loaded tree derives them on its
    first query, equal to those the v3 file holds."""
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    v = jpn.VantagePointTree.euclidean(pts)
    v3 = tmp_path / "v3.npz"
    v.save(v3)
    with np.load(v3) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("flat_")}
    arrays["format_version"] = np.int64(2)
    v2 = tmp_path / "v2.npz"
    np.savez_compressed(v2, **arrays)
    tree = load_index(v2, **CPU)
    assert tree._flat is None
    qs = rng.normal(size=(40, 3)).astype(np.float32)
    assert_knn_match(v.query_batch(qs, 4), tree.query_batch(qs, 4),
                     np.float32)
    with np.load(v3) as z:
        for key, a in zip(("flat_trunk_pts", "flat_members", "flat_anc_t",
                           "flat_anc_near", "flat_anc_rho"), tree._flat):
            np.testing.assert_array_equal(a.numpy(), z[key], err_msg=key)


def test_future_version_raises(tmp_path):
    t = BallTree.euclidean(np.eye(3, dtype=np.float32), **CPU)
    p = tmp_path / "t.npz"
    save_index(t, p)
    with np.load(p) as z:
        arrays = dict(z)
    arrays["format_version"] = np.int64(4)
    np.savez_compressed(p, **arrays)
    with pytest.raises(ValueError, match="unsupported index format v4"):
        load_index(p, **CPU)
    with pytest.raises(ValueError, match="unsupported index format v4"):
        jpn.load_index(p)


def test_unknown_kind_raises(tmp_path):
    p = tmp_path / "k.npz"
    np.savez_compressed(p, kind="kd", format_version=np.int64(3),
                        metric='{"name": "euclidean"}',
                        points=np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError, match="unknown index kind 'kd'"):
        load_index(p, **CPU)
    with pytest.raises(TypeError, match="cannot serialize"):
        save_index(object(), tmp_path / "o.npz")
