"""The port's ``NearestNeighbors`` against the JAX package's adapter,
scikit-learn and f64 oracles, on the CPU: the cases of
tests/test_sklearn_adapter.py (exactness, self-exclusion, object arrays,
CSR graphs, sklearn's errors).

Tolerance: float64 inputs throughout, so distances within rtol 1e-9 of the
oracle (1e-5 of scikit-learn, as the JAX package's tests), and ids equal to
the JAX adapter's; radius ids equal as sets, the uniform inclusive
``d <= r``."""

import numpy as np
import pytest

from petal_neighbors_tpu.sklearn import NearestNeighbors as JaxNN
from petal_neighbors_tpu_torch import BallTree, BruteForce, NearestNeighbors


def NN(**kw):
    return NearestNeighbors(device="cpu", **kw)


def _oracle_d(pts, qs):
    return np.sqrt((((qs[:, None] - pts[None]) ** 2).sum(-1)))


def _same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))


@pytest.mark.parametrize("algorithm", ["auto", "ball_tree", "vp_tree",
                                       "brute"])
def test_kneighbors_exact(rng, algorithm):
    pts = rng.standard_normal((300, 4))
    qs = rng.standard_normal((40, 4))
    nn = NN(n_neighbors=7, algorithm=algorithm).fit(pts)
    d, i = nn.kneighbors(qs)
    od = np.sort(_oracle_d(pts, qs), axis=1)[:, :7]
    np.testing.assert_allclose(d, od, rtol=1e-9)
    assert i.dtype == np.int64 and d.shape == i.shape == (40, 7)
    jd, ji = JaxNN(n_neighbors=7, algorithm=algorithm).fit(pts).kneighbors(qs)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-12)


def test_auto_picks_brute_above_direct_dim_max(rng):
    pts = rng.standard_normal((200, 40)).astype(np.float32)
    assert isinstance(NN().fit(pts)._index, BruteForce)
    assert isinstance(NN().fit(pts[:, :32])._index, BallTree)


def test_self_query_excludes_own_point(rng):
    pts = rng.standard_normal((100, 3))
    nn = NN(n_neighbors=4).fit(pts)
    d, i = nn.kneighbors()
    rows = np.arange(100)
    assert not (i == rows[:, None]).any()
    assert (d > 0).all()
    od = np.sort(_oracle_d(pts, pts), axis=1)[:, 1:5]
    np.testing.assert_allclose(d, od, rtol=1e-9)
    np.testing.assert_array_equal(i, JaxNN(n_neighbors=4).fit(pts)
                                  .kneighbors()[1])


def test_self_query_with_duplicates(rng):
    pts = rng.standard_normal((60, 3))
    pts[10] = pts[20]                     # an exact duplicate pair
    nn = NN(n_neighbors=2).fit(pts)
    d, i = nn.kneighbors()
    assert not (i == np.arange(60)[:, None]).any()
    assert d[10, 0] == 0.0 and i[10, 0] == 20    # the twin, not itself
    assert d[20, 0] == 0.0 and i[20, 0] == 10
    np.testing.assert_array_equal(i, JaxNN(n_neighbors=2).fit(pts)
                                  .kneighbors()[1])


def test_radius_neighbors_inclusive_and_metric_correct(rng):
    pts = rng.standard_normal((200, 3))
    qs = rng.standard_normal((9, 3))
    nn = NN(radius=1.2).fit(pts)
    d, ids = nn.radius_neighbors(qs)
    od = _oracle_d(pts, qs)
    for row in range(9):
        want = set(np.flatnonzero(od[row] <= 1.2).tolist())
        assert set(ids[row].tolist()) == want
        np.testing.assert_allclose(np.sort(d[row]),
                                   np.sort(od[row, ids[row]]), rtol=1e-9)
    _same_rows(ids, JaxNN(radius=1.2).fit(pts).radius_neighbors(qs)[1])


def test_radius_neighbors_cosine(rng):
    pts = rng.standard_normal((150, 5))
    qs = rng.standard_normal((6, 5))
    nn = NN(radius=0.3, metric="cosine", algorithm="brute").fit(pts)
    d, ids = nn.radius_neighbors(qs)
    pn = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    od = 1.0 - qn @ pn.T
    for row in range(6):
        assert set(ids[row].tolist()) == \
            set(np.flatnonzero(od[row] <= 0.3 + 1e-12).tolist())
    _same_rows(ids, JaxNN(radius=0.3, metric="cosine", algorithm="brute")
               .fit(pts).radius_neighbors(qs)[1])


def test_radius_neighbors_high_dim_brute_runs_on_its_resident_copy(rng):
    """f32 at d > 32: the Euclidean kernel layout keeps only its centred
    copy; the radius passes run there, equal to the JAX adapter's."""
    pts = rng.standard_normal((4200, 40)).astype(np.float32)
    qs = pts[:12] + 0.01
    nn = NN(radius=7.0).fit(pts)
    assert nn._index._center is not None
    d, ids = nn.radius_neighbors(qs)
    jd, jids = JaxNN(radius=7.0).fit(pts).radius_neighbors(qs)
    od = _oracle_d(pts.astype(np.float64), qs.astype(np.float64))
    for row in range(12):
        near = np.abs(od[row] - 7.0) <= 1e-5
        want = set(np.flatnonzero((od[row] <= 7.0) & ~near))
        assert want <= set(ids[row].tolist()) <= want | set(
            np.flatnonzero(near))
        assert set(ids[row].tolist()) ^ set(jids[row].tolist()) <= set(
            np.flatnonzero(near))
        np.testing.assert_allclose(d[row], od[row, ids[row]], rtol=1e-5)


def test_graphs(rng):
    pts = rng.standard_normal((80, 3))
    nn = NN(n_neighbors=3, radius=1.0).fit(pts)
    g = nn.kneighbors_graph(pts[:10])
    assert g.shape == (10, 80) and g.nnz == 30
    gd = nn.kneighbors_graph(pts[:10], mode="distance")
    od = np.sort(_oracle_d(pts, pts[:10]), axis=1)[:, :3]
    np.testing.assert_allclose(np.sort(gd.data.reshape(10, 3), axis=1),
                               od, rtol=1e-9)
    rg = nn.radius_neighbors_graph(pts[:10], mode="distance")
    assert rg.shape == (10, 80)
    od_full = _oracle_d(pts, pts[:10])
    assert rg.nnz == int((od_full <= 1.0).sum())
    jn = JaxNN(n_neighbors=3, radius=1.0).fit(pts)
    assert (g != jn.kneighbors_graph(pts[:10])).nnz == 0
    np.testing.assert_allclose(
        rg.toarray(), jn.radius_neighbors_graph(pts[:10], mode="distance")
        .toarray(), rtol=1e-12)


def test_minkowski_p_and_errors(rng):
    pts = rng.standard_normal((90, 3))
    qs = rng.standard_normal((5, 3))
    nn = NN(n_neighbors=3, metric="minkowski", p=3.0,
            algorithm="brute").fit(pts)
    d, i = nn.kneighbors(qs)
    od = (np.abs(qs[:, None] - pts[None]) ** 3).sum(-1) ** (1 / 3)
    np.testing.assert_allclose(d, np.sort(od, axis=1)[:, :3], rtol=1e-9)
    with pytest.raises(ValueError, match="algorithm"):
        NN(algorithm="kd_tree")
    with pytest.raises(ValueError, match="not .*fitted"):
        NN().kneighbors(qs)


class TestContractErrors:
    """Out-of-contract inputs raise sklearn's own errors, as the JAX
    adapter's."""

    def test_self_query_k_equals_n_raises(self, rng):
        pts = rng.standard_normal((5, 3))
        nn = NN(n_neighbors=5).fit(pts)
        with pytest.raises(ValueError, match="n_neighbors <= n_samples_fit"):
            nn.kneighbors()               # needs k+1 = 6 > 5 rows

    def test_explicit_x_k_over_n_raises(self, rng):
        pts = rng.standard_normal((5, 3))
        nn = NN().fit(pts)
        with pytest.raises(ValueError, match="n_neighbors <= n_samples_fit"):
            nn.kneighbors(rng.standard_normal((2, 3)), n_neighbors=6)

    def test_matches_real_sklearn_errors(self, rng):
        from sklearn.neighbors import NearestNeighbors as SkNN
        pts = rng.standard_normal((5, 3))
        sk, ours = SkNN(n_neighbors=5).fit(pts), NN(n_neighbors=5).fit(pts)
        for nn in (sk, ours):
            with pytest.raises(ValueError):
                nn.kneighbors()
            with pytest.raises(ValueError):
                nn.kneighbors(pts[:2], n_neighbors=6)
            with pytest.raises(ValueError):
                nn.kneighbors(pts[:2], n_neighbors=0)

    def test_k_zero_and_negative_raise(self, rng):
        nn = NN(n_neighbors=3).fit(rng.standard_normal((6, 2)))
        with pytest.raises(ValueError, match="Expected n_neighbors > 0"):
            nn.kneighbors(n_neighbors=0)
        with pytest.raises(ValueError, match="Expected n_neighbors > 0"):
            nn.kneighbors(n_neighbors=-2)

    def test_self_query_k_n_minus_one_ok(self, rng):
        pts = rng.standard_normal((6, 2))
        nn = NN(n_neighbors=5).fit(pts)
        d, i = nn.kneighbors()            # k+1 = 6 = n: the legal boundary
        assert d.shape == (6, 5)
        assert not (i == np.arange(6)[:, None]).any()

    def test_n_equals_one_fit(self, rng):
        pts = rng.standard_normal((1, 4))
        nn = NN(n_neighbors=1).fit(pts)
        d, i = nn.kneighbors(rng.standard_normal((3, 4)))
        assert d.shape == (3, 1) and (i == 0).all()
        with pytest.raises(ValueError):
            nn.kneighbors()               # a self-query needs k+1 <= 1

    def test_bogus_graph_mode_raises(self, rng):
        nn = NN(n_neighbors=2).fit(rng.standard_normal((8, 2)))
        with pytest.raises(ValueError, match="Unsupported mode"):
            nn.kneighbors_graph(mode="bogus")
        with pytest.raises(ValueError, match="Unsupported mode"):
            nn.radius_neighbors_graph(mode="bogus")


class TestRadiusStreaming:
    """radius_neighbors through the streamed count and capped passes:
    results equal scikit-learn's."""

    def test_matches_real_sklearn(self, rng):
        from sklearn.neighbors import NearestNeighbors as SkNN
        pts = rng.standard_normal((400, 5))
        qs = rng.standard_normal((37, 5))
        r = 1.8
        d0, i0 = NN(radius=r).fit(pts).radius_neighbors(qs)
        d1, i1 = SkNN(radius=r).fit(pts).radius_neighbors(qs)
        for row in range(len(qs)):
            o = np.argsort(i0[row])
            t = np.argsort(i1[row])
            np.testing.assert_array_equal(i0[row][o], i1[row][t])
            np.testing.assert_allclose(d0[row][o], d1[row][t], rtol=1e-5)

    def test_self_query_matches_sklearn(self, rng):
        from sklearn.neighbors import NearestNeighbors as SkNN
        pts = rng.standard_normal((120, 3))
        _, i0 = NN(radius=1.0).fit(pts).radius_neighbors()
        _, i1 = SkNN(radius=1.0).fit(pts).radius_neighbors()
        _same_rows(i0, i1)
        _same_rows(i0, JaxNN(radius=1.0).fit(pts).radius_neighbors()[1])

    def test_empty_results(self, rng):
        pts = rng.standard_normal((50, 3))
        nn = NN(radius=1e-9).fit(pts)
        d, i = nn.radius_neighbors(rng.standard_normal((4, 3)) + 100.0)
        assert all(len(x) == 0 for x in i)
        assert all(len(x) == 0 for x in d)
        ids_only = nn.radius_neighbors(pts[:2] + 100.0,
                                       return_distance=False)
        assert all(len(x) == 0 for x in ids_only)

    def test_radius_graph_matches_sklearn(self, rng):
        from sklearn.neighbors import NearestNeighbors as SkNN
        pts = rng.standard_normal((80, 4))
        g0 = NN(radius=1.5).fit(pts).radius_neighbors_graph(
            pts[:10], mode="distance")
        g1 = SkNN(radius=1.5).fit(pts).radius_neighbors_graph(
            pts[:10], mode="distance")
        assert g0.shape == g1.shape
        np.testing.assert_allclose(g0.toarray(), g1.toarray(), rtol=1e-5,
                                   atol=1e-7)
