"""ops/topk.py of the port against the JAX package's, on shared numpy
inputs (ties, NaN, +inf, k wider than the input).  Top-k selection and
the running max are exact operations: values and ids must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops import topk as jtopk
from petal_neighbors_tpu_torch.ops import topk as ttopk


def _inputs(seed, rows, width, dtype):
    rng = np.random.default_rng(seed)
    # few distinct values: many ties
    d = rng.integers(0, 6, size=(rows, width)).astype(dtype)
    d[rng.random((rows, width)) < 0.1] = np.nan
    d[rng.random((rows, width)) < 0.1] = np.inf
    ids = rng.permutation(rows * width).reshape(rows, width).astype(np.int32)
    return d, ids


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width,k", [(20, 5), (20, 20), (7, 12), (1, 3)])
def test_smallest_k_matches_jax(dtype, width, k):
    d, ids = _inputs(width * 31 + k, 16, width, dtype)
    jd, ji = jtopk.smallest_k(jnp.asarray(d), jnp.asarray(ids), k)
    td, ti = ttopk.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_smallest_k_ties_go_to_earlier_position():
    d = np.array([[1.0, 0.0, 1.0, 0.0, 1.0]], np.float32)
    ids = np.array([[10, 11, 12, 13, 14]], np.int32)
    td, ti = ttopk.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), 3)
    assert ti.tolist() == [[11, 13, 10]]
    assert td.tolist() == [[0.0, 0.0, 1.0]]


@pytest.mark.parametrize("k", [4, 9, 30])
def test_merge_topk_matches_jax(k):
    d1, i1 = _inputs(1, 8, 9, np.float32)
    d2, i2 = _inputs(2, 8, 9, np.float32)
    d1 = np.sort(np.where(np.isnan(d1), np.inf, d1), axis=1)
    d2 = np.sort(np.where(np.isnan(d2), np.inf, d2), axis=1)
    jd, ji = jtopk.merge_topk(jnp.asarray(d1), jnp.asarray(i1),
                              jnp.asarray(d2), jnp.asarray(i2), k)
    td, ti = ttopk.merge_topk(*(torch.from_numpy(a) for a in (d1, i1, d2, i2)),
                              k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_monotone_distances_matches_jax(dtype):
    rng = np.random.default_rng(5)
    d = np.sort(rng.random((6, 12)), axis=1).astype(dtype)
    d[:, 4] = d[:, 5] + 1e-3          # an inversion to clamp
    d[2, 8:] = np.inf
    d[3] = np.nan                     # NaN rows propagate
    want = np.asarray(jtopk.monotone_distances(jnp.asarray(d)))
    got = ttopk.monotone_distances(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    empty = ttopk.monotone_distances(torch.zeros((3, 0)))
    assert empty.shape == (3, 0)


def test_nan_to_inf():
    d = np.array([np.nan, 1.0, np.inf, -2.0], np.float32)
    np.testing.assert_array_equal(
        ttopk.nan_to_inf(torch.from_numpy(d)).numpy(),
        np.asarray(jtopk.nan_to_inf(jnp.asarray(d))))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_rescore_exact_matches_jax(dtype, k):
    """Candidates with missing (-1) and out-of-range ids, a NaN point
    row and duplicate points; rdist to 1 ulp of the dtype's sum order."""
    rng = np.random.default_rng(k)
    n, q, d, kin = 50, 7, 40, 10
    pts = rng.normal(size=(n, d)).astype(dtype)
    pts[3] = np.nan
    pts[9] = pts[8]
    qs = rng.normal(size=(q, d)).astype(dtype)
    idx = rng.integers(0, n, size=(q, kin)).astype(np.int32)
    idx[:, 0] = 8
    idx[:, 1] = 9
    idx[:, 2] = 3
    idx[0, 3] = -1
    idx[1, 4] = n + 5
    jd, ji = jtopk.rescore_exact(jnp.asarray(pts), jnp.asarray(qs),
                                 jnp.asarray(idx), k)
    td, ti = ttopk.rescore_exact(torch.from_numpy(pts), torch.from_numpy(qs),
                                 torch.from_numpy(idx), k)
    rtol = 1e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=rtol)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the NaN row only ever fills a slot at +inf; out-of-range ids never
    assert not np.isin(ti.numpy()[np.isfinite(td.numpy())], [3]).any()
    assert not (ti.numpy() == n + 5).any()
