"""The plain reference of exact Euclidean k-NN.

Plain PyTorch, in float64, in blocks of queries and points so that it fits
beside nothing else on the card.  It imports nothing of the program under
test and takes nothing it made: the harness hands it the raw points, made
again from the seed, and the raw queries.

``search`` picks each query's candidates by the product form
``‖q‖² + ‖x‖² − 2 q·x`` in float64, keeps ``k + SLACK`` of them, and
re-scores those in the direct form ``Σ (q_i − x_i)²``.  The result is
exact: a query is accepted only where its k-th direct-form distance lies
below the smallest product-form value left out by more than the float64
bound of that form; any other query is searched again with twice the
candidates.

``precision="tf32"`` is the control: the same search computed as
TensorFloat-32 would, the inputs rounded to TF32's 10-bit mantissa, the
products summed in float32, and the answers' distances taken from that
product form with no re-score.  It is the precision just below the
float32 that the configurations state, and a sound comparison has to call
its answers wrong.
"""

from __future__ import annotations

import contextlib

import torch

#: candidates kept beyond k before the direct-form re-score
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


def _blocks(q: int, n: int) -> tuple[int, int]:
    bn = min(n, 1 << 16)
    bq = max(1, min(q, BLOCK_ELEMS // bn))
    return bq, bn


def _product_topk(points, queries, m: int, dtype, round_tf32: bool):
    """The m smallest product-form values of each query (ascending) and
    their ids, over point chunks."""
    n = points.shape[0]
    q = queries.to(dtype)
    if round_tf32:
        q = to_tf32(q)
    qn = torch.sum(q * q, dim=1)
    _, bn = _blocks(q.shape[0], n)
    best_u = best_i = None
    for s in range(0, n, bn):
        x = points[s:s + bn].to(dtype)
        if round_tf32:
            x = to_tf32(x)
        xn = torch.sum(x * x, dim=1)
        u = qn[:, None] + xn[None, :] - 2.0 * (q @ x.T)
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
    """Direct-form float64 distances from each query to its (k) ids:
    ``sqrt(Σ (q_i − x_i)²)``.  ``ids`` must be valid rows."""
    x = points[ids].to(torch.float64)
    diff = x - queries.to(torch.float64)[:, None, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _exact_block(points, queries, k: int, xn_max):
    n, d = points.shape
    m = min(n, k + SLACK)
    qd = queries.to(torch.float64)
    qn = torch.sum(qd * qd, dim=1)
    while True:
        u, ids = _product_topk(points, queries, m, torch.float64, False)
        dist = distances(points, queries, ids)
        dist, order = torch.sort(dist, dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        if m >= n:
            return dist[:, :k], ids[:, :k]
        # |u − Σ(q−x)²| ≤ (2d + 4)·2⁻⁵³·(‖q‖² + ‖x‖²) for the product form
        err = (2 * d + 4) * 2.0 ** -53 * (qn + xn_max)
        kth = dist[:, k - 1] ** 2
        if bool(torch.all(kth < u[:, -1] - err)):
            return dist[:, :k], ids[:, :k]
        m = min(n, 2 * m)


def _max_norm(points) -> torch.Tensor:
    out = None
    for s in range(0, points.shape[0], 1 << 16):
        x = points[s:s + (1 << 16)].to(torch.float64)
        v = torch.max(torch.sum(x * x, dim=1))
        out = v if out is None else torch.maximum(out, v)
    return out


def search(points: torch.Tensor, queries: torch.Tensor, k: int, *,
           precision: str = "float64"):
    """The k nearest points of each query: (distances (Q, k) ascending,
    ids (Q, k) int64), k clipped to the number of points.  Ties at equal
    distance may come in any order.  ``precision`` is "float64" (the
    reference) or "tf32" (the control)."""
    n = points.shape[0]
    k = min(int(k), n)
    bq, _ = _blocks(queries.shape[0], n)
    xn_max = _max_norm(points) if precision == "float64" else None
    outs = []
    with _no_tf32():
        for s in range(0, queries.shape[0], bq):
            qb = queries[s:s + bq]
            if precision == "float64":
                outs.append(_exact_block(points, qb, k, xn_max))
            elif precision == "tf32":
                u, ids = _product_topk(points, qb, k, torch.float32, True)
                outs.append((torch.sqrt(torch.clamp(u, min=0.0)), ids))
            else:
                raise ValueError(f"unknown precision {precision!r}")
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
