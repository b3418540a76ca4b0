"""The port's sharded search (``petal_neighbors_tpu_torch.parallel``) in an
8-rank gloo world against the JAX package's ``parallel`` on its 8-device
virtual CPU mesh (``tests/conftest.py``), on the same seeded inputs.

One 8-rank world serves the whole file: a module fixture writes every
case's inputs to an ``.npz``, spawns the ranks once
(``torch_parallel_cases.run_all``), and rank 0 writes the outputs back;
each test then compares one case.  The cases mirror
``tests/test_parallel.py`` test for test.

Tolerances: k-NN distances within rtol 1e-12 (f64), ids equal where the
JAX test asks for equal ids and set-equal where it asks for sets; radius
counts and capped ids equal, except pairs whose f64 distance lies within 2
f32 ulp of the radius (two correct reduction orders may decide them
differently); MST sorted weights within 2·(d + 2) f32 ulp of the JAX ones.
Against the single-device port call on the same inputs, every output is
held bit for bit, except feature sharding's distances (another summation
order: rtol 1e-12)."""

import numpy as np
import pytest
import torch

import petal_neighbors_tpu as jpn
from petal_neighbors_tpu import parallel as jpar
from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu.trees import mutual_reachability_mst as jax_mst

import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu_torch.ops import bruteforce as tbf
from petal_neighbors_tpu_torch.parallel import dryrun

import torch_parallel_cases as cases

RANKS_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def inputs():
    data = cases.make_inputs()
    for case, metric in (("tree", jpn.Euclidean()),
                         ("tree_cosine", jpn.Cosine())):
        jt = jpn.BallTree(data[f"{case}.pts"], metric,
                          leaf_size=cases.LEAF_SIZE)
        data[f"{case}.centroids"] = np.asarray(jt.nodes.centroids)
        data[f"{case}.radii"] = np.asarray(jt.nodes.radii)
        data[f"{case}.idx"] = np.asarray(jt.idx)
        if jt._qcenter is not None:
            data[f"{case}.center"] = np.asarray(jt._qcenter)
    return data


@pytest.fixture(scope="module")
def in_path(inputs, tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "in.npz"
    np.savez(path, **inputs)
    return path


@pytest.fixture(scope="module")
def port(in_path):
    """The 8-rank world's outputs, keyed ``"<case>.<i>"``."""
    out = in_path.with_name("out.npz")
    dryrun.run_ranks(cases.run_all, 8, (str(in_path), str(out)),
                     device="cpu", timeout=RANKS_TIMEOUT_S)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def mesh1d():
    return jpar.default_mesh(8, ("shards",))


@pytest.fixture(scope="module")
def mesh2d():
    return jpar.default_mesh(8, ("q", "p"))


def _outputs(port, case, count):
    assert port[f"{case}.agree"] == 1, f"{case}: ranks disagree"
    return [port[f"{case}.{i}"] for i in range(count)]


def _single(inputs, case):
    pts, qs = (torch.from_numpy(inputs[f"{case}.{key}"])
               for key in ("pts", "qs"))
    return [t.numpy() for t in tbf.knn(pts, qs, cases.K[case])]


def _check_knn(port, inputs, case, jax_out, ids="equal", single=None):
    """The port's (distances, ids) against the JAX call's and the
    single-device port call's."""
    d, i = _outputs(port, case, 2)
    jd, ji = (np.asarray(a) for a in jax_out)
    assert d.shape == jd.shape and d.dtype == jd.dtype
    assert i.dtype == np.int32
    np.testing.assert_allclose(d, jd, rtol=1e-12)
    if ids == "equal":
        np.testing.assert_array_equal(i, ji)
    else:
        for r in range(len(i)):
            assert set(i[r].tolist()) == set(ji[r].tolist()), r
    sd, si = single if single is not None else _single(inputs, case)
    np.testing.assert_array_equal(d, sd)
    if ids == "equal":
        np.testing.assert_array_equal(i, si)
    else:
        for r in range(len(i)):
            assert set(i[r].tolist()) == set(si[r].tolist()), r
    return d, i


class TestDeviceSetup:
    def test_eight_devices(self, port, mesh1d, mesh2d):
        assert port["world.size"] == 8
        assert tuple(port["world.mesh1"]) == tuple(mesh1d.devices.shape)
        assert tuple(port["world.mesh2"]) == tuple(mesh2d.devices.shape)
        assert port["world.n_devices_mismatch_raises"] == 1


class TestQuerySharded:
    def test_matches_single_device(self, port, inputs, mesh1d):
        pts, qs = inputs["query.pts"], inputs["query.qs"]
        _check_knn(port, inputs, "query",
                   jpar.knn_query_sharded(pts, qs, 5, mesh=mesh1d))


class TestPointsSharded:
    def test_matches_single_device(self, port, inputs, mesh1d):
        pts, qs = inputs["points.pts"], inputs["points.qs"]
        _check_knn(port, inputs, "points",
                   jpar.knn_points_sharded(pts, qs, 7, mesh=mesh1d),
                   ids="set")

    def test_k_greater_than_shard(self, port, inputs, mesh1d):
        case = "points_k_gt_shard"          # 5 rows a shard < k=20
        pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
        _check_knn(port, inputs, case,
                   jpar.knn_points_sharded(pts, qs, 20, mesh=mesh1d),
                   ids="set")


class TestRing:
    def test_matches_single_device(self, port, inputs, mesh2d):
        pts, qs = inputs["ring.pts"], inputs["ring.qs"]
        _check_knn(port, inputs, "ring",
                   jpar.knn_ring(pts, qs, 6, mesh=mesh2d), ids="set")

    @pytest.mark.parametrize("case", ["ring_nan_padding",
                                      "ring_all_nan_shard"])
    def test_nan_padding_never_selected(self, port, inputs, mesh2d, case):
        """10 points over 4 point shards (3 rows each, the last with two
        NaN rows), and 9 points, whose last shard is NaN padding only."""
        pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
        k = cases.K[case]
        d, i = _check_knn(port, inputs, case,
                          jpar.knn_ring(pts, qs, k, mesh=mesh2d), ids="set")
        assert (i >= 0).all() and (i < len(pts)).all()
        assert np.isfinite(d).all()


class TestTreeQuerySharded:
    @pytest.mark.parametrize("case", ["tree", "tree_cosine"])
    def test_matches_single_device(self, port, inputs, mesh1d, case):
        pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
        k = cases.K[case]
        jt = (jpn.BallTree.euclidean(pts, leaf_size=cases.LEAF_SIZE)
              if case == "tree" else
              jpn.BallTree(pts, jpn.Cosine(), leaf_size=cases.LEAF_SIZE))
        jd, ji = jpar.tree_query_sharded(jt, qs, k, mesh=mesh1d)
        jd1, ji1 = jt.query_batch(qs, k)
        np.testing.assert_allclose(np.asarray(jd), np.asarray(jd1),
                                   rtol=1e-12)
        tree = cases._tree(inputs, case)
        single = [t.numpy() for t in tree.query_batch(
            torch.from_numpy(qs), k, scheme="per_query")]
        _check_knn(port, inputs, case, (jd, ji), single=single)


class TestFeatureSharded:
    def test_matches_single_device(self, port, inputs, mesh1d):
        pts, qs = inputs["feature.pts"], inputs["feature.qs"]
        d, i = _outputs(port, "feature", 2)
        jd, ji = (np.asarray(a) for a in jpar.knn_feature_sharded(
            pts, qs, 6, mesh=mesh1d))
        assert d.dtype == jd.dtype == np.float64
        np.testing.assert_allclose(d, jd, rtol=1e-12)
        od, oi = (np.asarray(a) for a in jbf.knn(pts, qs, 6))
        sd, si = _single(inputs, "feature")
        np.testing.assert_allclose(d, od, rtol=1e-10)
        np.testing.assert_allclose(d, sd, rtol=1e-12)
        for r in range(len(i)):
            assert set(i[r].tolist()) == set(ji[r].tolist()) \
                == set(oi[r].tolist()) == set(si[r].tolist())

    def test_non_euclidean_rejected(self, port, inputs, mesh1d):
        assert _outputs(port, "feature_non_euclidean", 1)[0] == 1
        with pytest.raises(ValueError):
            jpar.knn_feature_sharded(
                inputs["feature_non_euclidean.pts"],
                inputs["feature_non_euclidean.qs"], 2, jpn.Cosine(),
                mesh=mesh1d)


def _near(pts, qs, r):
    """(Q, n) bool: pairs within 2 f32 ulp of the reduced radius."""
    p, q = pts.astype(np.float64), qs.astype(np.float64)
    rd = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    rr = float(np.float32(r) ** 2)
    return np.abs(rd - rr) <= 2.0 * float(np.spacing(np.float32(rr)))


def _check_radius(port, inputs, case, jax_out):
    pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
    r, cap = cases.RADIUS[case]
    near = _near(pts, qs, r).sum(1)
    pt, qt = torch.from_numpy(pts), torch.from_numpy(qs)
    if cap is None:
        (cnt,) = _outputs(port, case, 1)
        jcnt = np.asarray(jax_out)
        single = tbf.radius_counts_streaming(pt, qt, r).numpy()
    else:
        ids, cnt = _outputs(port, case, 2)
        jids, jcnt = (np.asarray(a) for a in jax_out)
        sids, single = (a.numpy() for a in tbf.radius_capped(pt, qt, r,
                                                             cap=cap))
        sids = np.pad(sids, ((0, 0), (0, cap - sids.shape[1])),
                      constant_values=-1)
        assert ids.shape == jids.shape == (len(qs), cap)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids[near == 0], jids[near == 0])
        np.testing.assert_array_equal(ids, sids)
    assert cnt.dtype == np.int32 and cnt.shape == (len(qs),)
    assert (np.abs(cnt.astype(np.int64) - jcnt) <= near).all()
    np.testing.assert_array_equal(cnt, single)


class TestRadiusSharded:
    """Sharded radius search (DBSCAN at mesh scale): counts and capped
    ids must match the JAX mesh's and the single-device forms'."""

    def _run(self, port, inputs, mesh1d, case, **kw):
        pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
        r, cap = cases.RADIUS[case]
        run = (jpar.radius_query_sharded if case.startswith("radius_query")
               else jpar.radius_points_sharded)
        _check_radius(port, inputs, case,
                      run(pts, qs, r, mesh=mesh1d, cap=cap))

    def test_query_dp_counts(self, port, inputs, mesh1d):
        self._run(port, inputs, mesh1d, "radius_query_counts")

    def test_query_dp_capped_ids(self, port, inputs, mesh1d):
        self._run(port, inputs, mesh1d, "radius_query_capped")

    def test_points_sharded_counts(self, port, inputs, mesh1d):
        self._run(port, inputs, mesh1d, "radius_points_counts")

    def test_points_sharded_capped_ids(self, port, inputs, mesh1d):
        self._run(port, inputs, mesh1d, "radius_points_capped")

    def test_points_sharded_cap_spans_shards(self, port, inputs, mesh1d):
        """cap larger than one shard's member count: the first-cap-per-
        shard union must still realize the global first-cap contract."""
        self._run(port, inputs, mesh1d, "radius_points_cap_spans_shards")

    @pytest.mark.parametrize("case", ["radius_query_cap_above_n",
                                      "radius_points_cap_above_n"])
    def test_cap_above_n_pads(self, port, inputs, mesh1d, case):
        """cap above n (and above the 8 shards' capped widths): the ids
        are padded with -1 to the cap, as the JAX call's."""
        self._run(port, inputs, mesh1d, case)

    def test_nan_query_and_strict_boundary(self, port, inputs, mesh1d):
        case = "radius_nan_query_and_strict_boundary"
        cnt_in, cnt_st = _outputs(port, case, 2)
        pts, qs = inputs[f"{case}.pts"], inputs[f"{case}.qs"]
        for got, inclusive in ((cnt_in, True), (cnt_st, False)):
            want = jpar.radius_query_sharded(pts, qs, 0.0, mesh=mesh1d,
                                             inclusive=inclusive)
            np.testing.assert_array_equal(got, np.asarray(want))
        assert cnt_in[0] >= 1               # self at distance 0
        assert cnt_st[0] == 0               # strict d < 0 matches nothing
        assert cnt_in[2] == 0


def _spanning(us, vs, n):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(us, vs):
        parent[find(int(a))] = find(int(b))
    return len({find(i) for i in range(n)}) == 1


class TestShardedMST:
    def _check(self, port, inputs, mesh1d, case):
        pts = inputs[f"{case}.pts"]
        k = cases.K[case]
        us, vs, ws = _outputs(port, case, 3)
        assert len(ws) == len(pts) - 1 and np.isfinite(ws).all()
        assert _spanning(us, vs, len(pts))
        _, _, jws = jpar.mutual_reachability_mst_sharded(pts, k, mesh=mesh1d)
        _, _, jws1 = jax_mst(pts, k, scheme="scan")
        np.testing.assert_allclose(np.sort(jws), np.sort(jws1), rtol=1e-12)
        tol = 2 * (pts.shape[1] + 2) * np.spacing(
            np.float32(np.maximum(np.sort(jws), 1e-30)))
        assert np.all(np.abs(np.sort(ws) - np.sort(jws)) <= tol)
        _, _, ws1 = tpn.mutual_reachability_mst(pts, k, device="cpu")
        np.testing.assert_array_equal(np.sort(ws), np.sort(ws1))

    def test_weights_match_single_device(self, port, inputs, mesh1d):
        self._check(port, inputs, mesh1d, "mst_weights")

    def test_spanning_and_finite(self, port, inputs, mesh1d):
        self._check(port, inputs, mesh1d, "mst_spanning")

    def test_nan_rejected(self, port, inputs, mesh1d):
        assert _outputs(port, "mst_nan", 1)[0] == 1
        with pytest.raises(ValueError, match="finite"):
            jpar.mutual_reachability_mst_sharded(inputs["mst_nan.pts"], 3,
                                                 mesh=mesh1d)
