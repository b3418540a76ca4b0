"""The plain reference of exact cosine k-NN.

The distance is ``1 − Σ q_i x_i / (‖q‖·‖x‖)``, the crate's ``Cosine``
(distance.rs:76-122): 0 for one direction, 1 at right angles, 2 for
opposite ones.  Plain PyTorch, in float64, in blocks of queries and points
so that it fits beside nothing else on the card.  It imports nothing of
the program under test and takes nothing it made: the harness hands it the
raw points, made again from the seed, and the raw queries.

``search`` normalises the rows in float64 and picks each query's
candidates by the product form ``1 − q̂·x̂``, keeps ``k + SLACK`` of them,
and re-scores those in the crate's form ``1 − Σqx/(‖q‖‖x‖)``, also in
float64.  The result is exact: a query is accepted only where its k-th
re-scored distance lies below the smallest product-form value left out by
more than the float64 bound of the two forms; any other query is searched
again with twice the candidates.

Departures from the crate: the arithmetic is float64 where the crate
computes in the points' own type; a zero-norm point divides 0/0 there and
here alike, and its NaN is taken as farthest (the crate's sort puts NaN
last), so it is never picked ahead of a point with a distance; a NaN or
zero-norm query, whose distance to every point is NaN, is accepted as
first searched, its answer NaN whatever ids it lists (the program answers
such a query with (+inf, −1); the benchmark's data holds none).

``precision="tf32"`` is the control: the rows normalised in float32 and
rounded to TensorFloat-32's 10-bit mantissa, the products summed in
float32, and the answers' distances taken from that product form with no
re-score.  It is the precision just below the float32 that the
configurations state, and a sound comparison has to call its answers
wrong.
"""

from __future__ import annotations

import contextlib

import torch

#: candidates kept beyond k before the re-score
SLACK = 16
#: elements of one (queries × points) block of the product form
BLOCK_ELEMS = 1 << 28


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32: the card's matmul may otherwise round
    its inputs to TF32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to even
    (finite inputs)."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0x0FFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def _unit(x: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``x`` in ``dtype`` over their norms: NaN for a zero-norm
    row."""
    x = x.to(dtype)
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


def _err(d: int) -> float:
    """Twice the float64 bound of either form at width d, to first order.
    A norm carries at most (d/2 + 2) units of 2⁻⁵³ of relative error, so a
    unit row's elements (d/2 + 3); their products and the d-term sum add
    at most (2d + 8)·2⁻⁵³ of Σ|q̂_i x̂_i| ≤ 1 to ``1 − q̂·x̂``, and the
    same holds of ``1 − Σqx/(‖q‖‖x‖)``.  The doubling is margin."""
    return 2.0 * 2.0 * (2 * d + 8) * 2.0 ** -53


def _blocks(q: int, n: int) -> tuple[int, int]:
    bn = min(n, 1 << 16)
    bq = max(1, min(q, BLOCK_ELEMS // bn))
    return bq, bn


def _product_topk(points, qhat, m: int, dtype, round_tf32: bool):
    """The m smallest ``1 − q̂·x̂`` of each unit query row (ascending; a
    zero-norm or NaN point as +inf) and their ids, over point chunks."""
    n = points.shape[0]
    q = to_tf32(qhat) if round_tf32 else qhat
    _, bn = _blocks(q.shape[0], n)
    best_u = best_i = None
    for s in range(0, n, bn):
        x = _unit(points[s:s + bn], dtype)
        if round_tf32:
            x = to_tf32(x)
        u = 1.0 - q @ x.T
        u = torch.where(torch.isnan(u), torch.inf, u)
        v, j = torch.topk(u, min(m, u.shape[1]), dim=1, largest=False)
        j = j + s
        if best_u is not None:
            v, sel = torch.topk(torch.cat([best_u, v], 1),
                                min(m, best_u.shape[1] + v.shape[1]),
                                dim=1, largest=False)
            j = torch.gather(torch.cat([best_i, j], 1), 1, sel)
        best_u, best_i = v, j
    return best_u, best_i


def distances(points, queries, ids) -> torch.Tensor:
    """The crate's form in float64 from each query to its (k) ids:
    ``1 − Σ q_i x_i / (‖q‖·‖x‖)``.  ``ids`` must be valid rows."""
    x = points[ids].to(torch.float64)
    q = queries.to(torch.float64)
    dot = torch.sum(x * q[:, None, :], dim=-1)
    xn = torch.sqrt(torch.sum(x * x, dim=-1))
    qn = torch.sqrt(torch.sum(q * q, dim=-1))[:, None]
    return 1.0 - dot / (qn * xn)


def _exact_block(points, queries, k: int):
    n, d = points.shape
    m = min(n, k + SLACK)
    qhat = _unit(queries, torch.float64)
    # a NaN or zero-norm query is NaN against every point
    nan_q = torch.isnan(qhat).any(dim=1)
    err = _err(d)
    while True:
        u, ids = _product_topk(points, qhat, m, torch.float64, False)
        dist = distances(points, queries, ids)
        dist, order = torch.sort(dist, dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        if m >= n:
            return dist[:, :k], ids[:, :k]
        kth = dist[:, k - 1]
        if bool(torch.all((kth < u[:, -1] - err) | nan_q)):
            return dist[:, :k], ids[:, :k]
        m = min(n, 2 * m)


def search(points: torch.Tensor, queries: torch.Tensor, k: int, *,
           precision: str = "float64"):
    """The k nearest points of each query by cosine distance: (distances
    (Q, k) ascending, ids (Q, k) int64), k clipped to the number of
    points.  Ties at equal distance may come in any order.  ``precision``
    is "float64" (the reference) or "tf32" (the control)."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    n = points.shape[0]
    k = min(int(k), n)
    bq, _ = _blocks(queries.shape[0], n)
    outs = []
    with _no_tf32():
        for s in range(0, queries.shape[0], bq):
            qb = queries[s:s + bq]
            if precision == "float64":
                outs.append(_exact_block(points, qb, k))
            else:
                outs.append(_product_topk(points, _unit(qb, torch.float32),
                                          k, torch.float32, True))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
