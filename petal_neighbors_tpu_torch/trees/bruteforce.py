"""BruteForce: the flat exact index.

Counterpart of ``petal_neighbors_tpu/trees/bruteforce.py``.  The
reference's own test oracle (ball_tree.rs:873-894
``naive_k_nearest_neighbors``) promoted to an index: at high dimension
metric trees cannot prune, and a tiled distance product is the exact
search at the speed of the card.

Two layouts, chosen at build:

* **kernel** — float32 Euclidean, any size: the index holds
  ``prepare_euclidean_index``'s arrays on the device (center, padded
  centered points with +inf norms on NaN and padding rows, NaN-row mask);
  queries with ``1 <= k <= PALLAS_K_MAX = 4088`` run the bcap, capped, fold
  or merge kernel and a direct-form rescore, proved and repaired where
  the scheme needs it (``ops.bruteforce.knn_prepadded``).  Larger k takes
  the scan over the same arrays.
* **scan** — everything else (f64, SqEuclidean): the streamed scan
  ``ops.bruteforce.knn``.

``last_backend`` names the route that served the latest ``query_batch``:
``"kernel"`` or ``"scan"``; ``last_scheme`` the kernel scheme ("bcap",
"capped", "fold", "merge"), or None after the scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import DIRECT_DIM_MAX, Euclidean, Metric, get_metric
from ..ops import bruteforce as bf
from ..utils.validation import (check_points, check_points_host, check_query,
                                check_query_batch, resolve_device)

__all__ = ["BruteForce"]


class BruteForce:
    """Exact k-NN index over streamed distance tiles.

    ``device=None`` means ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` to run on the CPU (the kernel route then runs
    the kernels' plain PyTorch versions)."""

    def __init__(self, points, metric: Metric | str = "euclidean", *,
                 device=None):
        self.metric = get_metric(metric)
        self.device = resolve_device(device)
        #: route and kernel scheme that served the most recent
        #: ``query_batch`` call (None before the first query)
        self.last_backend = self.last_scheme = None
        self._center = None
        self.point_norms = None
        self._pts = self._norms = self._invalid = None
        probe = check_points_host(points)
        self.metric.validate_dim(probe.shape[1])
        self.points = probe
        if (type(self.metric) is Euclidean
                and self._dtype() == torch.float32):
            # only DERIVED arrays are resident (padded centered points +
            # norms + NaN mask); the original stays where it was given
            (self._center, self._pts, self._norms,
             self._invalid) = bf.prepare_euclidean_index(
                 check_points(probe, self.device))
            self._qpoints = None               # scan slices _pts[:n]
        else:
            self.points = check_points(probe, self.device)
            self._qpoints = self.points        # what queries run against
            if isinstance(self.metric, Euclidean):
                if probe.shape[1] > DIRECT_DIM_MAX:
                    self._center = bf.center_of(self.points)
                    self._qpoints = self.points - self._center
                self.point_norms = torch.sum(self._qpoints * self._qpoints,
                                             dim=-1)

    @classmethod
    def euclidean(cls, points, *, device=None) -> "BruteForce":
        return cls(points, Euclidean(), device=device)

    @classmethod
    def _from_prepared(cls, points, center, ppad, pnorm, bad, *,
                       device=None) -> "BruteForce":
        """A kernel-layout Euclidean index from arrays that
        ``prepare_euclidean_index`` made (by either package), with no
        rebuild.  ``ppad`` may be padded to any row count >= n; one that
        is not a multiple of ``PAD_ROWS`` gets more +inf-norm rows, so the
        bcap rescore reads whole blocks."""
        self = cls.__new__(cls)
        self.metric = Euclidean()
        self.device = resolve_device(device)
        self.last_backend = self.last_scheme = None
        self.point_norms = None
        self.points = check_points_host(points)
        n, d = self.points.shape
        dev = self.device

        def on_device(a, dtype):
            a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
            return a.to(dev, dtype).contiguous()

        self._center = on_device(center, torch.float32)
        self._pts = on_device(ppad, torch.float32)
        self._norms = on_device(pnorm, torch.float32)
        self._invalid = on_device(bad, torch.bool)
        if (self._center.shape != (d,) or self._pts.ndim != 2
                or self._pts.shape[0] < n or self._pts.shape[1] != d
                or self._norms.shape != (self._pts.shape[0],)
                or self._invalid.shape != (n,)):
            raise ValueError("prepared arrays do not match the points: "
                             f"points {tuple(self.points.shape)}, center "
                             f"{tuple(self._center.shape)}, ppad "
                             f"{tuple(self._pts.shape)}, pnorm "
                             f"{tuple(self._norms.shape)}, bad "
                             f"{tuple(self._invalid.shape)}")
        if self._pts.shape[0] % bf.PAD_ROWS:
            self._pts, self._norms = bf.pad_for_pallas(self._pts, self._norms)
        self._qpoints = None
        return self

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    def _q(self, qs):
        """Center queries to match the index's centered representation."""
        return qs if self._center is None else qs - self._center

    def _scan_points(self):
        """Points and norms for the scan.  In kernel layout only the
        padded (centered, NaN-zeroed) copy is resident: slice it; the NaN
        rows' exclusion lives in their +inf norms and the invalid mask."""
        if self._qpoints is not None:
            return self._qpoints, self.point_norms
        n = self.num_points
        return self._pts[:n], self._norms[:n]

    # -- single-query API (reference-shaped) ------------------------------
    def query_nearest(self, point):
        """(index, distance) of the nearest point (ball_tree.rs:80-87)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        d, i = self.query_batch(q[None, :], 1)
        return int(i[0, 0]), float(d[0, 0])

    def query(self, point, k: int):
        """(indices, distances) as numpy, ascending; k=0 -> empty; k>n ->
        n results (ball_tree.rs:102-121)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        d, i = self.query_batch(q[None, :], k)
        return i[0].cpu().numpy(), d[0].cpu().numpy()

    def _dtype(self) -> torch.dtype:
        if torch.is_tensor(self.points):
            return self.points.dtype
        return torch.float64 if self.points.dtype == np.float64 \
            else torch.float32

    # -- batched API ---------------------------------------------------------
    def query_batch(self, queries, k: int, *, chunk: int | None = None):
        """(distances, ids) tensors on the index's device, (Q, min(k, n)),
        ascending.  NaN queries give (+inf, -1); NaN points are never
        selected."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        n = self.num_points
        k_eff = min(int(k), n)
        if self._pts is not None and 1 <= k_eff <= bf.PALLAS_K_MAX:
            scheme = bf.pick_scheme(k_eff, n)
            d, i = bf.knn_prepadded(self._pts, self._norms, qs, k_eff, n,
                                    self._center, scheme=scheme)
            self.last_backend, self.last_scheme = "kernel", scheme
            return d, i
        pts, norms = self._scan_points()
        d, i = bf.knn(pts, self._q(qs), k, self.metric, chunk=chunk,
                      point_norms=norms, invalid=self._invalid)
        self.last_backend, self.last_scheme = "scan", None
        return d, i

    # -- later slices --------------------------------------------------------
    def query_radius(self, point, distance):
        raise NotImplementedError("radius search comes in a later slice")

    def query_radius_batch(self, queries, distance, **kw):
        raise NotImplementedError("radius search comes in a later slice")

    def query_radius_count_batch(self, queries, distance, **kw):
        raise NotImplementedError("radius search comes in a later slice")
