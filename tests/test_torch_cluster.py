"""The port's HDBSCAN host stages (``cluster.py``, a NumPy copy of the JAX
package's) and its ``hdbscan`` end to end, against the JAX package's.

On one shared MST the stages are the same NumPy code, so the linkage
matrix, the condensed tree, the stabilities, the labels and the
probabilities are equal exactly.  End to end the MSTs come from two
engines whose weights agree within f32 rounding, and an MST is unique only
up to swaps of equal-weight edges; on well-separated clusters with
distinct weights the labels are equal and the probabilities agree within
rtol 1e-5."""

import numpy as np
import pytest

import petal_neighbors_tpu as jpn
import petal_neighbors_tpu_torch as tpn
from petal_neighbors_tpu import cluster as jc
from petal_neighbors_tpu.trees.boruvka import mutual_reachability_mst
from petal_neighbors_tpu_torch import cluster as tc


def _blobs(seed, sizes, d=2, spread=0.3):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, size=(len(sizes), d))
    return np.concatenate([rng.normal(c, spread, size=(m, d))
                           for c, m in zip(centres, sizes)]).astype(
                               np.float32)


@pytest.mark.parametrize("mcs", [3, 5, 12])
def test_host_stages_equal_jax_on_a_shared_mst(mcs):
    pts = _blobs(0, (60, 45, 30, 8))
    us, vs, ws = mutual_reachability_mst(pts, 5)
    n = len(pts)
    z = tc.single_linkage(us, vs, ws, n)
    np.testing.assert_array_equal(z, jc.single_linkage(us, vs, ws, n))
    ct, jct = tc.condense_tree(z, mcs), jc.condense_tree(z, mcs)
    for a, b in zip(ct, jct):
        np.testing.assert_array_equal(a, b)
    assert tc.cluster_stability(ct) == jc.cluster_stability(jct)
    for allow in (False, True):
        got = tc.extract_clusters(ct, allow_single_cluster=allow)
        want = jc.extract_clusters(jct, allow_single_cluster=allow)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("scheme", ["auto", "dual"])
def test_hdbscan_end_to_end_matches_jax(scheme):
    pts = _blobs(1, (80, 60, 50))
    got = tpn.hdbscan(pts, 8, scheme=scheme, device="cpu")
    want = jpn.hdbscan(pts, 8, scheme=scheme)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.probabilities, want.probabilities,
                               rtol=1e-5, atol=0)
    assert got.labels.max() == 2
    assert sorted(got.stabilities) == sorted(want.stabilities)
    np.testing.assert_allclose(sorted(got.stabilities.values()),
                               sorted(want.stabilities.values()), rtol=1e-5)


def test_hdbscan_min_samples_and_single_cluster():
    pts = _blobs(2, (70,), spread=1.0)
    for kw in ({"min_samples": 3}, {"allow_single_cluster": True}):
        got = tpn.hdbscan(pts, 10, device="cpu", **kw)
        want = jpn.hdbscan(pts, 10, **kw)
        np.testing.assert_array_equal(got.labels, want.labels)


def test_hdbscan_small_n_and_bad_sizes():
    pts = np.zeros((4, 2), np.float32)
    res = tpn.hdbscan(pts, 5, device="cpu")
    assert (res.labels == -1).all() and res.probabilities.shape == (4,)
    assert res.condensed.n_points == 4 and res.stabilities == {}
    with pytest.raises(ValueError, match="min_cluster_size"):
        tc.condense_tree(np.zeros((3, 4)), 1)
