"""The port's flat ``knn`` (its JAX signature: centring, ``rescore``,
``backend``, ``assume_centered``) against the JAX package's
``knn(..., backend="xla")`` and an f64 oracle, on shared numpy inputs, on
the CPU.

Tolerance: ids equal to the JAX package's except at ties within rtol 1e-6
(f32) or 1e-12 (f64) of a distance, distances within that rtol; recall
1.0 against the f64 oracle over the same (f32-rounded) values.  Without
the rescore the distances are the matmul form's, held to the JAX
package's within its bound (4 eps (|q|^2 + max |x|^2) in the squared
domain, f32).  A forced "pallas" on CPU tensors runs the kernels' plain
versions and equals the scan bit for bit (both end in the same direct-form
rescore)."""

import numpy as np
import pytest
import torch

from petal_neighbors_tpu.ops import bruteforce as jbf
from petal_neighbors_tpu_torch.distance import SqEuclidean
from petal_neighbors_tpu_torch.ops import bruteforce as bf

from test_torch_ball_tree import assert_knn_match

D = 64


def _data(n, q, offset, dtype, seed=13):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, D)) + offset).astype(dtype)
    qs = (rng.normal(size=(q, D)) + offset).astype(dtype)
    return pts, qs


def _recall(ids, pts, qs, k):
    """Recall of ``ids`` against the f64 oracle over the same values."""
    rd = ((qs[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    want = np.argsort(rd, axis=1, kind="stable")[:, :k]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, want)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4])
def test_knn_off_origin_matches_jax_and_oracle(offset, dtype):
    """The fault this repairs: without centring, the matmul form at
    offset 1e4 kept the wrong candidates (recall 0.0027 at 5,000 points)."""
    pts, qs = _data(3000, 100, offset, dtype)
    k = 5
    tout = bf.knn(torch.from_numpy(pts), torch.from_numpy(qs), k)
    jout = jbf.knn(pts, qs, k, backend="xla")
    assert_knn_match(jout, tout, dtype)
    assert _recall(tout[1].numpy(), pts, qs, k) == 1.0


def test_assume_centered_on_centred_data():
    pts, qs = _data(2000, 60, 0.0, np.float32, seed=3)
    mu = pts.mean(axis=0, dtype=np.float64).astype(np.float32)
    pts, qs = pts - mu, qs - mu
    norms = (pts * pts).sum(-1)
    for point_norms in (None, norms):
        tout = bf.knn(torch.from_numpy(pts), torch.from_numpy(qs), 7,
                      point_norms=None if point_norms is None
                      else torch.from_numpy(point_norms),
                      assume_centered=True, backend="xla")
        jout = jbf.knn(pts, qs, 7, point_norms=point_norms,
                       assume_centered=True, backend="xla")
        assert_knn_match(jout, tout, np.float32)
        assert _recall(tout[1].numpy(), pts, qs, 7) == 1.0


def test_rescore_false_keeps_the_matmul_form():
    pts, qs = _data(2000, 60, 0.0, np.float32, seed=4)
    tp, tq = torch.from_numpy(pts), torch.from_numpy(qs)
    tout = bf.knn(tp, tq, 6, rescore=False, backend="xla")
    jout = jbf.knn(pts, qs, 6, rescore=False, backend="xla")
    mu = pts.mean(axis=0)
    qn, xn = ((qs - mu) ** 2).sum(-1), ((pts - mu) ** 2).sum(-1)
    bound = 4 * 2.0 ** -24 * float(qn.max() + xn.max())
    assert_knn_match(jout, tout, np.float32, rd_atol=4 * bound)
    rescored = bf.knn(tp, tq, 6, backend="xla")[0]
    assert not torch.equal(tout[0], rescored)
    np.testing.assert_allclose(tout[0] ** 2, rescored ** 2, rtol=0,
                               atol=4 * bound)


@pytest.mark.parametrize("k", [1, 10, 700])
@pytest.mark.parametrize("offset", [0.0, 1e4])
def test_forced_pallas_on_cpu_equals_the_scan(offset, k):
    """n >= 4096 and d > 32: "pallas" runs the route's plain versions
    (fold, or merge at k + 8 > 640); "auto" on CPU tensors is the scan."""
    pts, qs = _data(4100, 24, offset, np.float32, seed=5)
    tp, tq = torch.from_numpy(pts), torch.from_numpy(qs)
    kern = bf.knn(tp, tq, k, backend="pallas")
    scan = bf.knn(tp, tq, k, backend="xla")
    auto = bf.knn(tp, tq, k)
    for out in (kern, auto):
        assert torch.equal(out[0], scan[0]) and torch.equal(out[1], scan[1])
    assert _recall(kern[1].numpy(), pts, qs, k) == 1.0


def test_forced_pallas_not_eligible_raises_as_jax():
    pts, qs = _data(300, 8, 0.0, np.float32, seed=6)
    cases = (
        (pts.astype(np.float64), qs.astype(np.float64), 3, None, None),
        (pts, qs, 3, SqEuclidean(), "sqeuclidean"),
        (pts, qs, bf.PALLAS_K_MAX + 1, None, None),
    )
    from petal_neighbors_tpu.distance import get_metric as jget
    for p, q, k, tmetric, jname in cases:
        big = np.concatenate([p] * 15) if k > bf.PALLAS_K_MAX else p
        with pytest.raises(ValueError, match="backend='pallas' requires"):
            jbf.knn(big, q, k, None if jname is None else jget(jname),
                    backend="pallas")
        with pytest.raises(ValueError, match="backend='pallas' requires"):
            bf.knn(torch.from_numpy(big), torch.from_numpy(q), k, tmetric,
                   backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        bf.knn(torch.from_numpy(pts), torch.from_numpy(qs), 3,
               backend="triton")


def test_invalid_rows_stay_on_the_scan_as_jax():
    """``invalid`` keeps even a forced "pallas" on the scan, as the JAX
    package does (the kernel padding cannot honour it)."""
    pts, qs = _data(4100, 10, 0.0, np.float32, seed=7)
    invalid = np.zeros(len(pts), dtype=bool)
    invalid[::3] = True
    tout = bf.knn(torch.from_numpy(pts), torch.from_numpy(qs), 5,
                  backend="pallas", invalid=torch.from_numpy(invalid))
    jout = jbf.knn(pts, qs, 5, backend="pallas", invalid=invalid)
    assert_knn_match(jout, tout, np.float32)
    assert not invalid[tout[1].numpy()].any()
