"""Distance metrics (parity with the reference ``src/distance.rs``).

The reference defines a 4-method ``Metric`` trait (distance.rs:9-14):
``distance``, ``rdistance`` (a cheaper monotone surrogate — squared
distance for Euclidean), and the two conversions between them.  The
reduced squared distance is one ``‖q‖² + ‖x‖² − 2·q·xᵀ`` matrix product;
the sqrt happens only at output boundaries.

Each metric exposes two API tiers:

* **pair tier** (reference trait parity): ``distance(x1, x2)`` /
  ``rdistance`` / ``rdistance_to_distance`` / ``distance_to_rdistance``
  on 1-D vectors;
* **batch tier**: ``rdist(Q, X) -> (q, n)`` reduced distances,
  ``rowwise_rdist(X, Y) -> (n,)``, plus the same conversions applied
  elementwise.

This slice carries ``Euclidean`` and ``SqEuclidean``; the other metric
names of the JAX package raise ``NotImplementedError``.

Precision: a float32 product on the card runs in full float32 —
``torch.backends.cuda.matmul.allow_tf32`` is set to False before every
product here (TF32 keeps about three decimal digits, which would break
the exactness contract).
"""

from __future__ import annotations

import abc

import torch

__all__ = ["Metric", "Euclidean", "SqEuclidean", "get_metric",
           "DIRECT_DIM_MAX"]

# Below this dimension the squared-distance matmul form is a net loss: it
# suffers catastrophic cancellation in f32 when distances are tiny
# relative to the norms, while the direct (q-x)^2 form is exact to
# rounding.  High-dim callers keep the matmul form and rescore top-k
# candidates with the direct form (ops.bruteforce).
DIRECT_DIM_MAX = 32


def _cross(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q @ x.T`` in full precision (no TF32 on the card)."""
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return q @ x.T


class Metric(abc.ABC):
    """Distance-metric interface (reference trait: distance.rs:9-14)."""

    name: str = "metric"

    # -- pair tier (1-D vectors), reference trait parity ------------------
    @abc.abstractmethod
    def distance(self, x1, x2):
        ...

    @abc.abstractmethod
    def rdistance(self, x1, x2):
        ...

    @abc.abstractmethod
    def rdistance_to_distance(self, rd):
        ...

    @abc.abstractmethod
    def distance_to_rdistance(self, d):
        ...

    # -- batch tier ---------------------------------------------------------
    @abc.abstractmethod
    def rdist(self, q, x):
        """Reduced distances between rows of ``q`` (m, d) and ``x`` (n, d),
        returned as an (m, n) matrix."""

    def dist(self, q, x):
        return self.rdistance_to_distance(self.rdist(q, x))

    @abc.abstractmethod
    def rowwise_rdist(self, x, y):
        """Reduced distance between matched rows of ``x`` and ``y`` -> (n,)."""

    def rowwise_dist(self, x, y):
        return self.rdistance_to_distance(self.rowwise_rdist(x, y))

    # Metrics compare equal per class, like the reference's unit structs
    # (``#[derive(Eq, PartialEq)]``, distance.rs:16, :76).
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))

    def __repr__(self):
        return f"{type(self).__name__}()"

    def validate_dim(self, dim: int) -> None:
        """Hook for metrics with dimensionality requirements (index
        constructors call this before building)."""

    def invalid_queries(self, q):
        """(Q,) bool: query rows whose distance to EVERY point is NaN
        (-> +inf).  Such rows get (+inf, -1) results on all backends.
        Rule: any NaN coordinate."""
        return torch.isnan(torch.as_tensor(q)).any(dim=-1)


class Euclidean(Metric):
    """Euclidean metric (distance.rs:16-55).

    ``rdistance`` is the squared distance (no sqrt, distance.rs:37-45);
    the batched path computes it as ``‖q‖² + ‖x‖² − 2 q·xᵀ`` and clamps
    tiny negative rounding residue to zero.
    """

    name = "euclidean"

    def distance(self, x1, x2):
        return torch.sqrt(self.rdistance(x1, x2))

    def rdistance(self, x1, x2):
        d = torch.as_tensor(x1) - torch.as_tensor(x2)
        return torch.sum(d * d)

    def rdistance_to_distance(self, rd):
        return torch.sqrt(rd)

    def distance_to_rdistance(self, d):
        return torch.square(torch.as_tensor(d))

    def rdist(self, q, x):
        if q.shape[-1] <= DIRECT_DIM_MAX:
            diff = q[:, None, :] - x[None, :, :]
            return torch.sum(diff * diff, dim=-1)
        qn = torch.sum(q * q, dim=-1, keepdim=True)           # (m, 1)
        xn = torch.sum(x * x, dim=-1)                          # (n,)
        return torch.clamp_min(qn + xn[None, :] - 2.0 * _cross(q, x), 0.0)

    def rdist_with_norms(self, q, x, qn, xn):
        """rdist when ‖·‖² terms are precomputed (index-resident norms)."""
        if q.shape[-1] <= DIRECT_DIM_MAX:
            diff = q[:, None, :] - x[None, :, :]
            return torch.sum(diff * diff, dim=-1)
        return torch.clamp_min(
            qn[:, None] + xn[None, :] - 2.0 * _cross(q, x), 0.0)

    def rowwise_rdist(self, x, y):
        d = torch.as_tensor(x) - torch.as_tensor(y)
        return torch.sum(d * d, dim=-1)


class SqEuclidean(Euclidean):
    """Squared Euclidean: reported distances stay in the squared
    (rdistance) domain; both conversions are the identity.  Served by
    ``BruteForce`` only (it violates the triangle inequality)."""

    name = "sqeuclidean"

    def distance(self, x1, x2):
        return self.rdistance(x1, x2)

    def rdistance_to_distance(self, rd):
        return rd

    def distance_to_rdistance(self, d):
        return d


_REGISTRY = {
    "euclidean": Euclidean,
    "sqeuclidean": SqEuclidean,
}

#: metric names of the JAX package that a later slice of the port carries
_LATER = ("cosine", "minkowski", "manhattan", "cityblock", "l1",
          "chebyshev", "linf", "haversine")


def get_metric(name_or_metric, **kwargs) -> Metric:
    """Resolve a metric by instance or registry name."""
    if isinstance(name_or_metric, Metric):
        return name_or_metric
    name = str(name_or_metric).lower()
    if name in _LATER:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet; it comes in a later slice")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name_or_metric!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)
