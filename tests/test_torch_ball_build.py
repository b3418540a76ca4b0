"""The port's ball-tree builds against the JAX package's, on the CPU.

Tolerance: ``tree_shape`` equal field by field; ``idx`` equal exactly for
every builder; centroids and radii within 1e-9 absolute (f64) or 1e-5
relative (f32: the device build sums in the points' dtype, the host
builds in f64), with 1e-6 absolute for f32 values near 0 (a centroid of
N(0, 1) points).  The reference and native builders reproduce
``tests/golden/build_fixtures.json``."""

import json
import os

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu.distance import get_metric as jax_metric
from petal_neighbors_tpu.trees import ball_build as jbuild
from petal_neighbors_tpu.trees import ball_build_device as jdevice
from petal_neighbors_tpu.utils.tree_math import tree_shape as jax_shape
from petal_neighbors_tpu_torch import native
from petal_neighbors_tpu_torch.distance import get_metric as port_metric
from petal_neighbors_tpu_torch.trees import _auto
from petal_neighbors_tpu_torch.trees import ball_build as tbuild
from petal_neighbors_tpu_torch.trees.ball_build_device import build_device
from petal_neighbors_tpu_torch.utils.tree_math import tree_shape

FIXTURES = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                       "build_fixtures.json")))
METRICS = [("euclidean", {}), ("cosine", {}), ("minkowski", {"p": 3.0}),
           ("manhattan", {}), ("chebyshev", {})]


def _tol(dtype):
    return (dict(rtol=1e-5, atol=1e-6) if dtype == np.float32
            else dict(rtol=0, atol=1e-9))


def _points(n, d, dtype, seed=0, ties=True, nan=False):
    rng = np.random.default_rng(seed + n + 3 * d)
    pts = rng.normal(size=(n, d)).astype(dtype)
    if ties:
        pts[rng.integers(0, n, 8)] = pts[0]          # duplicated rows
        pts[:, 0] = np.round(pts[:, 0], 1)           # tied split values
    if nan:
        pts[[2, 9], 1] = np.nan
    return pts


@pytest.mark.parametrize("n,leaf", [(1, None), (2, None), (3, None),
                                    (40, None), (64, None), (1000, 128),
                                    (1000, 1), (7, 2), (131072, 128)])
def test_tree_shape_matches_jax(n, leaf):
    a, b = tree_shape(n, leaf), jax_shape(n, leaf)
    for field in ("n", "height", "n_nodes", "n_leaves", "max_leaf_points",
                  "leaf_offset"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("range_start", "range_end", "is_leaf"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert len(a.node_of_pos) == len(b.node_of_pos)
    for x, y in zip(a.node_of_pos, b.node_of_pos):
        np.testing.assert_array_equal(x, y)
    assert a.level_slice(1) == b.level_slice(1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", METRICS)
@pytest.mark.parametrize("builder", ["vectorized", "reference", "device"])
def test_builders_match_jax(builder, name, kw, dtype):
    pts = _points(150, 4, dtype, nan=name == "euclidean")
    jt = jpn.BallTree(pts, jax_metric(name, **kw), leaf_size=8,
                      builder=builder)
    tt = tpn.BallTree(pts, port_metric(name, **kw), leaf_size=8,
                      builder=builder, device="cpu")
    assert tt.builder == builder
    np.testing.assert_array_equal(tt.idx, jt.idx)
    assert tt.idx.dtype == np.int64
    c = tt.nodes.centroids.numpy()
    assert c.dtype == dtype and tt.nodes.radii.dtype == tt.points.dtype
    np.testing.assert_allclose(c, np.asarray(jt.nodes.centroids),
                               **_tol(dtype))
    np.testing.assert_allclose(tt.nodes.radii.numpy(),
                               np.asarray(jt.nodes.radii), **_tol(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("leaf", [None, 4, 32])
def test_device_build_equals_vectorized(leaf, dtype):
    """As the JAX package's test_ball_tree.py:306-314: the device build's
    idx is the host build's, its geometry within tolerance."""
    pts = _points(200, 5, dtype, nan=True)
    shape = tree_shape(200, leaf)
    metric = tpn.Euclidean()
    dev = build_device(torch.from_numpy(pts), shape, metric)
    host = tbuild.build_host_vectorized(pts, shape, metric)
    np.testing.assert_array_equal(dev.idx, host.idx)
    np.testing.assert_allclose(dev.centroids.numpy(), host.centroids,
                               **_tol(dtype))
    np.testing.assert_allclose(dev.radii.numpy(), host.radii, **_tol(dtype))
    jd = jdevice.build_device(pts, jax_shape(200, leaf), jpn.Euclidean())
    np.testing.assert_array_equal(dev.idx, jd.idx)


def test_device_build_nan_column_never_splits():
    """A column with a NaN member has a NaN spread, which never wins, as
    the host's reductions make it."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(64, 3))
    pts[:, 2] *= 100.0                   # the widest column...
    pts[7, 2] = np.nan                   # ...holds a NaN
    shape = tree_shape(64, 8)
    dev = build_device(torch.from_numpy(pts), shape, tpn.Euclidean())
    host = tbuild.build_host_vectorized(pts, shape, tpn.Euclidean())
    np.testing.assert_array_equal(dev.idx, host.idx)
    np.testing.assert_allclose(dev.radii.numpy(), host.radii, atol=1e-9)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_and_native_reproduce_golden(name):
    case = FIXTURES[name]
    rng = np.random.default_rng(case["seed"])
    pts = np.round(rng.uniform(0, 1, (case["n"], case["dim"])), 6)
    shape = tree_shape(case["n"], None)
    ref = tbuild.build_reference_order(pts, shape, tpn.Euclidean())
    assert ref.idx.tolist() == case["ball_idx"]
    np.testing.assert_allclose(np.round(ref.radii, 6),
                               case["ball_radii_6dp"], atol=2e-6)
    c, r, idx = native.ball_build(pts, shape.n_nodes, tpn.Euclidean())
    assert idx.tolist() == case["ball_idx"]
    np.testing.assert_allclose(r, ref.radii, rtol=1e-12)
    np.testing.assert_allclose(c, ref.centroids, atol=1e-12)
    tree = tpn.BallTree.euclidean(pts, leaf_size=None, builder="reference",
                                  device="cpu")
    assert tree.idx.tolist() == case["ball_idx"]


@pytest.mark.parametrize("name,kw", METRICS[:3])
def test_native_matches_python_reference(name, kw):
    pts = _points(97, 3, np.float64)
    shape = tree_shape(97, None)
    metric = port_metric(name, **kw)
    ref = tbuild.build_reference_order(pts, shape, metric)
    c, r, idx = native.ball_build(pts, shape.n_nodes, metric)
    np.testing.assert_array_equal(idx, ref.idx)
    np.testing.assert_allclose(r, ref.radii, rtol=1e-10, atol=1e-14)
    jref = jbuild.build_reference_order(pts, jax_shape(97, None),
                                        jax_metric(name, **kw))
    np.testing.assert_array_equal(idx, jref.idx)
    c32, r32, idx32 = native.ball_build(pts.astype(np.float32),
                                        shape.n_nodes, metric)
    assert c32.dtype == r32.dtype == np.float32
    assert sorted(idx32.tolist()) == list(range(97))


def test_native_kinds_and_python_fallback():
    assert native.native_kind(tpn.Euclidean()) == 0
    assert native.native_kind(tpn.Minkowski(3.0)) == 2
    assert native.native_kind(tpn.Manhattan()) is None
    with pytest.raises(ValueError):
        native.ball_build(np.zeros((4, 2)), 7, tpn.Chebyshev())
    # a metric with no native kind takes the Python reference builder
    pts = _points(50, 3, np.float64)
    tree = tpn.BallTree(pts, "chebyshev", leaf_size=None,
                        builder="reference", device="cpu")
    ref = tbuild.build_reference_order(pts, tree_shape(50, None),
                                       tpn.Chebyshev())
    np.testing.assert_array_equal(tree.idx, ref.idx)


def test_native_compile_failure_raises(monkeypatch, tmp_path):
    """A failed compile raises; nothing falls back to the Python builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "lib_path",
                        lambda: tmp_path / "x" / "libpetal_native.so")
    monkeypatch.setattr(native, "CXX_FLAGS", ["-DNO_SUCH_FLAG", "-x", "c++",
                                              "-fsyntax-only-bad"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.ball_build(np.zeros((4, 2)), 7, tpn.Euclidean())
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tpn.BallTree.euclidean(np.zeros((4, 2)), leaf_size=None,
                               builder="reference", device="cpu")


def test_auto_builder_rule():
    assert _auto.DEVICE_BUILD_MIN_N == 131072
    assert _auto.use_device_build(131072, torch.device("cuda"))
    assert not _auto.use_device_build(131071, torch.device("cuda"))
    assert not _auto.use_device_build(10 ** 6, torch.device("cpu"))
    tree = tpn.BallTree.euclidean(_points(300, 2, np.float32), device="cpu")
    assert tree.builder == "vectorized"


def test_builder_errors():
    pts = _points(20, 2, np.float64)
    with pytest.raises(ValueError, match="builder"):
        tpn.BallTree.euclidean(pts, builder="nope", device="cpu")
    with pytest.raises(ValueError, match="triangle"):
        tpn.BallTree(pts, "sqeuclidean", device="cpu")
    with pytest.raises(ValueError):
        tpn.BallTree(np.zeros((5, 3)), "haversine", device="cpu")
    with pytest.raises(tpn.EmptyArrayError):
        tpn.BallTree.euclidean(np.zeros((0, 2)), device="cpu")
    with pytest.raises(tpn.NotContiguousError):
        tpn.BallTree.euclidean(np.asfortranarray(pts), device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpn.BallTree.euclidean(_points(20, 2, np.float32))
