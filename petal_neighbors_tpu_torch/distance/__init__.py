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

Every metric of the JAX package is here: ``Euclidean``, ``SqEuclidean``,
``Cosine``, ``Minkowski``, ``Manhattan``, ``Chebyshev`` and ``Haversine``.
``pairwise(x, metric)`` replicates distance.rs:58-74: an (n, n) symmetric
matrix with a zero diagonal, zeros for n < 2.

Precision: a float32 product on the card runs in full float32 —
``torch.backends.cuda.matmul.allow_tf32`` is set to False before every
product here (TF32 keeps about three decimal digits, which would break
the exactness contract).
"""

from __future__ import annotations

import abc

import torch

__all__ = ["Metric", "Euclidean", "SqEuclidean", "Cosine", "Minkowski",
           "Manhattan", "Chebyshev", "Haversine", "pairwise", "get_metric",
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


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


class Metric(abc.ABC):
    """Distance-metric interface (reference trait: distance.rs:9-14)."""

    name: str = "metric"

    #: distances depend only on coordinate differences, so data may be
    #: translated (centered) without changing any distance — the numeric
    #: fix for the matmul form's cancellation (see ``pairwise`` and
    #: ``ops.bruteforce.center_of``).
    translation_invariant: bool = False

    #: metric-tree pruning bounds (``max(d(q,c) − r, 0)``,
    #: ball_tree.rs:463-481) require the triangle inequality; metrics that
    #: violate it (squared Euclidean) are served by ``BruteForce`` only.
    tree_compatible: bool = True

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
        Rule: any NaN coordinate; Cosine adds zero-norm rows (0/0 division,
        distance.rs:93-105)."""
        return torch.isnan(_t(q)).any(dim=-1)


class Euclidean(Metric):
    """Euclidean metric (distance.rs:16-55).

    ``rdistance`` is the squared distance (no sqrt, distance.rs:37-45);
    the batched path computes it as ``‖q‖² + ‖x‖² − 2 q·xᵀ`` and clamps
    tiny negative rounding residue to zero.
    """

    name = "euclidean"
    translation_invariant = True

    def distance(self, x1, x2):
        return torch.sqrt(self.rdistance(x1, x2))

    def rdistance(self, x1, x2):
        d = _t(x1) - _t(x2)
        return torch.sum(d * d)

    def rdistance_to_distance(self, rd):
        return torch.sqrt(_t(rd))

    def distance_to_rdistance(self, d):
        return torch.square(_t(d))

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
        d = _t(x) - _t(y)
        return torch.sum(d * d, dim=-1)


class SqEuclidean(Euclidean):
    """Squared Euclidean: reported distances stay in the squared
    (rdistance) domain; both conversions are the identity.  Served by
    ``BruteForce`` only (it violates the triangle inequality)."""

    name = "sqeuclidean"
    tree_compatible = False

    def distance(self, x1, x2):
        return self.rdistance(x1, x2)

    def rdistance_to_distance(self, rd):
        return _t(rd)

    def distance_to_rdistance(self, d):
        return _t(d)


class Cosine(Metric):
    """Cosine distance, ``1 − dot/(‖x1‖·‖x2‖)`` (distance.rs:76-122).

    ``rdistance`` is identical to ``distance`` and both conversions are the
    identity (distance.rs:110-121).  Zero-norm rows produce NaN, exactly as
    the reference's division does; the top-k layer's NaN policy (NaN sorts
    as farthest) then applies.
    """

    name = "cosine"

    def distance(self, x1, x2):
        x1, x2 = _t(x1), _t(x2)
        dot = torch.sum(x1 * x2)
        n1 = torch.sqrt(torch.sum(x1 * x1))
        n2 = torch.sqrt(torch.sum(x2 * x2))
        return 1.0 - dot / (n1 * n2)

    def rdistance(self, x1, x2):
        return self.distance(x1, x2)

    def rdistance_to_distance(self, rd):
        return _t(rd)

    def distance_to_rdistance(self, d):
        return _t(d)

    def rdist(self, q, x):
        q, x = _t(q), _t(x)
        dot = _cross(q, x)
        qn = torch.sqrt(torch.sum(q * q, dim=-1))[:, None]
        xn = torch.sqrt(torch.sum(x * x, dim=-1))[None, :]
        return 1.0 - dot / (qn * xn)

    def rowwise_rdist(self, x, y):
        x, y = _t(x), _t(y)
        dot = torch.sum(x * y, dim=-1)
        nx = torch.sqrt(torch.sum(x * x, dim=-1))
        ny = torch.sqrt(torch.sum(y * y, dim=-1))
        return 1.0 - dot / (nx * ny)

    def invalid_queries(self, q):
        # zero-norm queries divide 0/0 -> NaN against every point; same
        # (+inf, -1) policy as the kernel route's normalize-to-NaN
        q = _t(q)
        return torch.isnan(q).any(dim=-1) | (torch.sum(q * q, dim=-1) == 0.0)


class Minkowski(Metric):
    """Minkowski L_p metric (an extension beyond the reference; the JAX
    package's config #5 exercises it at 960-d).

    ``rdistance`` is the p-th-power sum (a monotone surrogate, like the
    Euclidean squared distance).  Integral ``p <= 64`` takes a multiply
    chain, and even powers skip the ``abs``.
    """

    name = "minkowski"
    translation_invariant = True

    def __init__(self, p: float = 2.0):
        if not p >= 1.0:
            raise ValueError("Minkowski requires p >= 1")
        self.p = float(p)
        self._p_int = int(p) if float(p).is_integer() and p <= 64 else None

    def _pow_sum(self, diff, dim=None):
        """sum(|diff| ** p) with the integer-p multiply-chain path."""
        if self._p_int is not None:
            base = diff if self._p_int % 2 == 0 else torch.abs(diff)
            terms = torch.pow(base, self._p_int)
        else:
            terms = torch.abs(diff) ** self.p
        return torch.sum(terms) if dim is None else torch.sum(terms, dim=dim)

    def distance(self, x1, x2):
        return self.rdistance(x1, x2) ** (1.0 / self.p)

    def rdistance(self, x1, x2):
        return self._pow_sum(_t(x1) - _t(x2))

    def rdistance_to_distance(self, rd):
        return _t(rd) ** (1.0 / self.p)

    def distance_to_rdistance(self, d):
        return _t(d) ** self.p

    def rdist(self, q, x):
        q, x = _t(q), _t(x)
        return self._pow_sum(q[:, None, :] - x[None, :, :], dim=-1)

    def rowwise_rdist(self, x, y):
        return self._pow_sum(_t(x) - _t(y), dim=-1)

    def __repr__(self):
        return f"Minkowski(p={self.p})"


class Manhattan(Minkowski):
    """L1 / city-block metric (Minkowski p=1, with no pow)."""

    name = "manhattan"

    def __init__(self):
        super().__init__(1.0)

    def rdistance(self, x1, x2):
        return torch.sum(torch.abs(_t(x1) - _t(x2)))

    def rdist(self, q, x):
        return torch.sum(torch.abs(_t(q)[:, None, :] - _t(x)[None, :, :]),
                         dim=-1)

    def rowwise_rdist(self, x, y):
        return torch.sum(torch.abs(_t(x) - _t(y)), dim=-1)

    def rdistance_to_distance(self, rd):
        return _t(rd)

    def distance_to_rdistance(self, d):
        return _t(d)

    def __repr__(self):
        return "Manhattan()"


class Chebyshev(Metric):
    """L-infinity metric: max coordinate difference (NaN propagates, as
    ``jnp.max``)."""

    name = "chebyshev"
    translation_invariant = True

    def distance(self, x1, x2):
        return torch.amax(torch.abs(_t(x1) - _t(x2)))

    def rdistance(self, x1, x2):
        return self.distance(x1, x2)

    def rdistance_to_distance(self, rd):
        return _t(rd)

    def distance_to_rdistance(self, d):
        return _t(d)

    def rdist(self, q, x):
        return torch.amax(torch.abs(_t(q)[:, None, :] - _t(x)[None, :, :]),
                          dim=-1)

    def rowwise_rdist(self, x, y):
        return torch.amax(torch.abs(_t(x) - _t(y)), dim=-1)


class Haversine(Metric):
    """Great-circle distance on the unit sphere for (lat, lon) in radians
    (multiply results by the sphere radius for physical units).

    rdistance is the haversine value ``sin²(dlat/2) + cos(lat1) cos(lat2)
    sin²(dlon/2)``, a monotone surrogate as the Euclidean squared distance
    is.
    """

    name = "haversine"

    def validate_dim(self, dim: int) -> None:
        if dim != 2:
            raise ValueError(
                f"haversine requires (lat, lon) pairs: got dim {dim}, "
                "expected 2")

    @staticmethod
    def _check_dim(x):
        if x.shape[-1] != 2:
            raise ValueError(
                f"haversine requires (lat, lon) pairs: got dim "
                f"{x.shape[-1]}, expected 2")
        return x

    @staticmethod
    def _hav(lat1, lon1, lat2, lon2):
        dlat = lat2 - lat1
        dlon = lon2 - lon1
        return (torch.sin(dlat / 2) ** 2
                + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2)

    def distance(self, x1, x2):
        return self.rdistance_to_distance(self.rdistance(x1, x2))

    def rdistance(self, x1, x2):
        x1 = self._check_dim(_t(x1))
        x2 = self._check_dim(_t(x2))
        return self._hav(x1[0], x1[1], x2[0], x2[1])

    def rdistance_to_distance(self, rd):
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(_t(rd), 0.0, 1.0)))

    def distance_to_rdistance(self, d):
        return torch.sin(_t(d) / 2.0) ** 2

    def rdist(self, q, x):
        q = self._check_dim(_t(q))
        x = self._check_dim(_t(x))
        return self._hav(q[:, None, 0], q[:, None, 1],
                         x[None, :, 0], x[None, :, 1])

    def rowwise_rdist(self, x, y):
        x = self._check_dim(_t(x))
        y = self._check_dim(_t(y))
        return self._hav(x[..., 0], x[..., 1], y[..., 0], y[..., 1])


def pairwise(x, metric: Metric | None = None):
    """Symmetric (n, n) distance matrix (distance.rs:58-74).

    The reference computes the strict upper triangle and mirrors it,
    leaving the diagonal zero; n < 2 returns all zeros.  Here the whole
    matrix comes from ``metric.rdist`` and is then made exactly symmetric
    the same way (upper triangle mirrored), so ``D[i,j] == D[j,i]`` bit for
    bit and ``D[i,i] == 0``.

    Translation-invariant metrics are centered first (``x − nanmean(x)``):
    the ``‖a‖²+‖b‖²−2abᵀ`` form's absolute error scales with ``eps·‖x‖²``,
    and centering shrinks the norms to data-variance scale without
    changing any distance (the scheme of ``ops.bruteforce.center_of``).
    """
    metric = metric or Euclidean()
    x = _t(x)
    n = x.shape[0]
    if n < 2:
        return torch.zeros((n, n), dtype=x.dtype, device=x.device)
    if metric.translation_invariant:
        x = x - torch.nan_to_num(torch.nanmean(x, dim=0))
    d = metric.rdistance_to_distance(metric.rdist(x, x))
    upper = torch.triu(d, diagonal=1)
    return upper + upper.T


_REGISTRY = {
    "euclidean": Euclidean,
    "sqeuclidean": SqEuclidean,
    "cosine": Cosine,
    "minkowski": Minkowski,
    "manhattan": Manhattan,
    "cityblock": Manhattan,
    "l1": Manhattan,
    "chebyshev": Chebyshev,
    "linf": Chebyshev,
    "haversine": Haversine,
}


def get_metric(name_or_metric, **kwargs) -> Metric:
    """Resolve a metric by instance or registry name."""
    if isinstance(name_or_metric, Metric):
        return name_or_metric
    try:
        cls = _REGISTRY[str(name_or_metric).lower()]
    except KeyError:
        raise ValueError(
            f"unknown metric {name_or_metric!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)
