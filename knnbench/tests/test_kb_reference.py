"""The plain reference against a NumPy brute force at tiny sizes, ties
included, and its control precision."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kb_helpers import CHECKOUT  # noqa: F401  (puts the checkout on sys.path)
from knnbench import spec

ref = spec.reference("euclidean")


def numpy_knn(points, queries, k):
    d = np.sqrt(((queries.astype(np.float64)[:, None, :]
                  - points.astype(np.float64)[None, :, :]) ** 2).sum(-1))
    return np.sort(d, axis=1)[:, :k], d


@pytest.mark.parametrize("n,d,q,k", [(1, 3, 4, 1), (50, 7, 9, 5),
                                     (300, 33, 17, 10), (40, 5, 6, 60)])
def test_reference_matches_numpy(n, d, q, k):
    rng = np.random.default_rng(n * 1000 + d)
    pts = (rng.random((n, d), dtype=np.float32) * 255).astype(np.float32)
    qs = (rng.random((q, d), dtype=np.float32) * 255).astype(np.float32)
    want, full = numpy_knn(pts, qs, k)
    dist, ids = ref.search(torch.from_numpy(pts), torch.from_numpy(qs), k)
    assert dist.dtype == torch.float64 and ids.shape == want.shape
    np.testing.assert_allclose(dist.numpy(), want, rtol=1e-15, atol=0)
    # each id is at the distance it is listed with
    np.testing.assert_allclose(np.take_along_axis(full, ids.numpy(), 1),
                               want, rtol=1e-15, atol=0)
    for row in ids.numpy():
        assert len(set(row.tolist())) == len(row)


def test_ties_and_duplicates():
    """Twenty copies of one point, some at the k-th place: the distances
    are exact and the ids are a set of the tied points."""
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 4, size=(200, 3)).astype(np.float32)
    pts[100:120] = pts[5]
    qs = np.concatenate([pts[5:6], rng.integers(0, 4, (7, 3))]
                        ).astype(np.float32)
    for k in (1, 10, 21, 40):
        want, full = numpy_knn(pts, qs, k)
        dist, ids = ref.search(torch.from_numpy(pts), torch.from_numpy(qs), k)
        # torch's CPU sqrt may differ from numpy's by an ulp
        np.testing.assert_allclose(dist.numpy(), want, rtol=1e-15, atol=0)
        np.testing.assert_allclose(
            np.take_along_axis(full, ids.numpy(), 1), want, rtol=1e-15,
            atol=0)
        assert all(len(set(r.tolist())) == k for r in ids.numpy())


def test_blocks_cover_every_point(monkeypatch):
    """Small blocks: the candidates merge across point chunks, and the
    re-search with more candidates runs where many points tie."""
    monkeypatch.setattr(ref, "BLOCK_ELEMS", 64)
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 3, size=(500, 2)).astype(np.float32)
    qs = rng.integers(0, 3, size=(9, 2)).astype(np.float32)
    want, full = numpy_knn(pts, qs, 30)
    dist, ids = ref.search(torch.from_numpy(pts), torch.from_numpy(qs), 30)
    np.testing.assert_allclose(dist.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(np.take_along_axis(full, ids.numpy(), 1),
                               want, rtol=1e-15, atol=0)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      255.0, 1.0 + 2 ** -12], dtype=torch.float32)
    got = ref.to_tf32(x)
    # ties to even: 1 + 2⁻¹¹ -> 1; 1 + 3·2⁻¹¹ -> 1 + 2⁻⁹
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 255.0,
                            1.0]
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


def test_control_is_less_precise():
    rng = np.random.default_rng(5)
    pts = (rng.random((2000, 40), dtype=np.float32) * 255).astype(np.float32)
    qs = (rng.random((50, 40), dtype=np.float32) * 255).astype(np.float32)
    want, _ = numpy_knn(pts, qs, 10)
    dist, _ = ref.search(torch.from_numpy(pts), torch.from_numpy(qs), 10,
                         precision="tf32")
    gap = np.abs(dist.numpy() - want) / want
    assert gap.max() > 1e-5
    with pytest.raises(ValueError):
        ref.search(torch.from_numpy(pts), torch.from_numpy(qs), 1,
                   precision="bf16")


def test_the_seed_draws_the_order_not_the_data():
    from kb_helpers import TINY
    from knnbench import data
    p1, p2 = data.make_points(TINY, "cpu"), data.make_points(TINY, "cpu")
    assert torch.equal(p1, p2) and p1.shape == (8192, 40)
    assert float(p1.min()) >= 0.0 and float(p1.max()) <= 255.0
    a = data.make_pool(TINY, 2**31 + 5, 500)
    b = data.make_pool(TINY, 2**31 + 5, 500)
    c = data.make_pool(TINY, 2**40 + 6, 500)
    assert a.dtype == np.float32 and a.shape == (500, 40)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # the same queries, in another order
    np.testing.assert_array_equal(np.unique(a, axis=0), np.unique(c, axis=0))
    assert len(np.unique(a, axis=0)) == 500
