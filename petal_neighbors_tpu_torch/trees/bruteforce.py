"""BruteForce: the flat exact index.

Counterpart of ``petal_neighbors_tpu/trees/bruteforce.py``.  The
reference's own test oracle (ball_tree.rs:873-894
``naive_k_nearest_neighbors``) promoted to an index: at high dimension
metric trees cannot prune, and a tiled distance product is the exact
search at the speed of the card.

Four layouts, chosen at build (the JAX package's, trees/bruteforce.py:
79-128):

* **Lp kernel** — float32 Minkowski, Manhattan or Chebyshev at d > 32 and
  n >= 4096: the index holds ``prepare_lp_index``'s arrays (NaN-zeroed
  padded points, the additive +inf mask, the NaN-row mask); queries with
  ``1 <= k <= 4096`` run the Lp kernel, whose direct power sums are final
  (``ops.bruteforce.lp_knn_prepadded``).
* **cosine kernel** — float32 Cosine at d > 32 and n >= 4096: the index
  holds ``prepare_cosine_index``'s L2-normalized padded rows (zero-norm
  rows join the NaN rows), and queries with ``1 <= k <= PALLAS_K_MAX``
  take the Euclidean route on normalized queries, reporting ``rd / 2``.
* **Euclidean kernel** — float32 Euclidean, any size: the index holds
  ``prepare_euclidean_index``'s arrays on the device (center, padded
  centered points with +inf norms on NaN and padding rows, NaN-row mask);
  queries with ``1 <= k <= PALLAS_K_MAX = 4088`` run the bcap, capped, fold
  or merge kernel and a direct-form rescore, proved and repaired where
  the scheme needs it (``ops.bruteforce.knn_prepadded``).

On the card both of the last two also hold the padded rows' piece planes
(``ops.cuda.tc_planes.index_planes``, made once at build or at
``_from_prepared``, never saved: 1.5 times the padded rows' bytes at d a
multiple of 32), which the tensor-core kernels (bcap, capped, merge) read;
only each call's queries are split again.  On the CPU they hold none.
* **scan** — everything else (f64, SqEuclidean, Haversine, low
  dimensions, small corpora): the streamed scan ``ops.bruteforce.knn``.
  A kernel layout answers k beyond its kernels with the scan over its own
  resident copy and NaN-row mask.

Radius search (``query_radius``, ``query_radius_batch``,
``query_radius_count_batch``) runs the ``ops.bruteforce`` radius family on
the same resident copy, the NaN rows never matching.

``last_backend`` names the route that served the latest ``query_batch``:
``"kernel"`` or ``"scan"``; ``last_scheme`` the kernel scheme ("bcap",
"capped", "fold", "merge", "lp"; ``pick_scheme``'s, as the JAX package
names it), or None after the scan.  On the card a bcap or capped call of
1 to a few queries runs the fold route on the few-query kernel, where
``knn_fold`` would take it (``ops.bruteforce.knn_prepadded``).  Unlike the
JAX package, a kernel failure raises: nothing falls back quietly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import DIRECT_DIM_MAX, Cosine, Euclidean, Metric, get_metric
from ..ops import bruteforce as bf
from ..ops.cuda.lp_kernel import LP_K_MAX, lp_spec_for
from ..ops.cuda.tc_planes import index_planes
from ..utils.profiling import span
from ..utils.validation import (check_points, check_points_host, check_query,
                                check_query_batch, resolve_device)

__all__ = ["BruteForce"]

#: smallest corpus the Lp and cosine kernel layouts take
#: (trees/bruteforce.py:76-84)
KERNEL_MIN_N = 4096


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
        self._pts = self._norms = self._invalid = self._mask = None
        self._planes = None
        self._lp_spec = None
        self._cosine = self._bcap = False
        probe = check_points_host(points)
        n, d = probe.shape
        self.metric.validate_dim(d)
        self.points = probe
        f32 = self._dtype() == torch.float32
        kernel_ok = f32 and d > DIRECT_DIM_MAX and n >= KERNEL_MIN_N
        lp_spec = lp_spec_for(self.metric)
        # only DERIVED arrays are resident in the kernel layouts; the
        # original stays where it was given, and the scan slices _pts[:n]
        self._qpoints = None
        if lp_spec is not None and kernel_ok:
            self._lp_spec = lp_spec
            self._pts, self._mask, self._invalid = bf.prepare_lp_index(
                check_points(probe, self.device))
        elif type(self.metric) is Cosine and kernel_ok:
            self._cosine = True
            self._pts, self._norms, self._invalid = bf.prepare_cosine_index(
                check_points(probe, self.device))
            self._planes = index_planes(self._pts)
        elif type(self.metric) is Euclidean and f32:
            (self._center, self._pts, self._norms,
             self._invalid) = bf.prepare_euclidean_index(
                 check_points(probe, self.device))
            self._planes = index_planes(self._pts)
            self._bcap = bf.with_bcap_planes(n, d)
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
    def _from_prepared(cls, points, ppad, bad, *, metric=None, center=None,
                       pnorm=None, mask=None, device=None) -> "BruteForce":
        """A kernel-layout index from the arrays that either package's
        ``prepare_*_index`` made, with no rebuild: Euclidean (``center``,
        ``ppad``, ``pnorm``, ``bad``), cosine (``ppad``, ``pnorm``,
        ``bad``) or Lp (``ppad``, ``mask``, ``bad``; a Minkowski,
        Manhattan or Chebyshev ``metric``).  ``ppad`` may be padded to any
        row count >= n; a Euclidean or cosine one that is not a multiple
        of ``PAD_ROWS`` gets more +inf-norm rows, so the bcap rescore reads
        whole blocks."""
        self = cls.__new__(cls)
        self.metric = get_metric(metric if metric is not None
                                 else "euclidean")
        self.device = resolve_device(device)
        self.last_backend = self.last_scheme = None
        self.point_norms = None
        self.points = check_points_host(points)
        n, d = self.points.shape
        dev = self.device

        def on_device(a, dtype):
            if a is None:
                return None
            a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
            return a.to(dev, dtype).contiguous()

        self._lp_spec = lp_spec_for(self.metric)
        self._cosine = type(self.metric) is Cosine
        self._center = on_device(center, torch.float32)
        self._pts = on_device(ppad, torch.float32)
        self._norms = on_device(pnorm, torch.float32)
        self._mask = on_device(mask, torch.float32)
        self._invalid = on_device(bad, torch.bool)
        # the Lp layout's row values are its mask, the others' their norms
        row = self._mask if self._lp_spec is not None else self._norms
        needs_center = type(self.metric) is Euclidean
        if (row is None or (self._center is not None) != needs_center
                or self._pts.ndim != 2 or self._pts.shape[0] < n
                or self._pts.shape[1] != d
                or row.shape != (self._pts.shape[0],)
                or self._invalid.shape != (n,)
                or (self._center is not None
                    and self._center.shape != (d,))):
            raise ValueError(
                f"prepared arrays do not match the points and "
                f"{self.metric!r}: points {tuple(self.points.shape)}, "
                + ", ".join(f"{k} {None if a is None else tuple(a.shape)}"
                            for k, a in (("center", self._center),
                                         ("ppad", self._pts),
                                         ("pnorm", self._norms),
                                         ("mask", self._mask),
                                         ("bad", self._invalid))))
        if self._lp_spec is None and self._pts.shape[0] % bf.PAD_ROWS:
            self._pts, self._norms = bf.pad_for_pallas(self._pts, self._norms)
        self._planes = (index_planes(self._pts) if self._lp_spec is None
                        else None)
        self._bcap = (type(self.metric) is Euclidean
                      and bf.with_bcap_planes(n, d))
        self._qpoints = None
        return self

    def save(self, path) -> None:
        """Checkpoint the index to an ``.npz`` (``utils.serialize``): its
        points and metric; a load prepares the layout again."""
        from ..utils.serialize import save_index
        save_index(self, path)

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
        """Points and norms for the scan.  In a kernel layout only the
        padded (centered or normalized, NaN-zeroed) copy is resident:
        slice it; the NaN rows' exclusion lives in the invalid mask (and
        the Euclidean layout's +inf norms).  Cosine is scale-invariant, so
        the scan's Cosine.rdist on the normalized copy answers as on the
        original."""
        if self._qpoints is not None:
            return self._qpoints, self.point_norms
        n = self.num_points
        norms = None if self._norms is None else self._norms[:n]
        return self._pts[:n], norms

    # -- single-query API (reference-shaped) ------------------------------
    def query_nearest(self, point):
        """(index, distance) of the nearest point (ball_tree.rs:80-87)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        d, i = self.query_batch(q[None, :], 1)
        return int(i[0, 0]), float(d[0, 0])

    def query(self, point, k: int):
        """(indices, distances) as numpy, ascending; k=0 -> empty; k>n ->
        n results (ball_tree.rs:102-121).  Recorded in the ``petal.query``
        span, its copies to the host in ``petal.query.to_host``."""
        with span("petal.query"):
            q = check_query(point, self.dim, self._dtype(), self.device)
            d, i = self.query_batch(q[None, :], k)
            with span("petal.query.to_host"):
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
        selected.  Recorded in the ``petal.query_batch`` span."""
        with span("petal.query_batch"):
            qs = check_query_batch(queries, self.dim, self._dtype(),
                                   self.device)
            n = self.num_points
            k_eff = min(int(k), n)
            if self._lp_spec is not None and 1 <= k_eff <= LP_K_MAX:
                d, i = bf.lp_knn_prepadded(self._pts, self._mask, qs, k_eff,
                                           n, spec=self._lp_spec,
                                           metric=self.metric)
                self.last_backend, self.last_scheme = "kernel", "lp"
                return d, i
            if self._norms is not None and 1 <= k_eff <= bf.PALLAS_K_MAX:
                scheme = bf.pick_scheme(k_eff, n, self._bcap)
                d, i = bf.knn_prepadded(self._pts, self._norms, qs, k_eff, n,
                                        self._center, scheme=scheme,
                                        normalize_q=self._cosine,
                                        out_rdist=self._cosine,
                                        planes=self._planes)
                if self._cosine:
                    # ‖q̂−x̂‖²/2 == 1 − q̂·x̂; /2 is exact and keeps the order
                    d = d * 0.5
                self.last_backend, self.last_scheme = "kernel", scheme
                return d, i
            pts, norms = self._scan_points()
            d, i = bf.knn(pts, self._q(qs), k, self.metric, chunk=chunk,
                          point_norms=norms, assume_centered=True,
                          backend="xla", invalid=self._invalid)
            self.last_backend, self.last_scheme = "scan", None
            return d, i

    # -- radius search --------------------------------------------------------
    def _radius_args(self, qs):
        """The scan's points, the centred queries and the NaN-row mask:
        radius search runs on the index's resident copy, where the
        ``invalid`` rows never match."""
        return self._scan_points()[0], self._q(qs), self._invalid

    def query_radius(self, point, distance):
        """Indices with distance <= ``distance`` as numpy int64, ascending
        (ball_tree.rs:123-142).  The flat index has no subtree take, so
        the boundary rule is the reference's documented inclusive
        ``d <= r`` (ball_tree.rs:123-124)."""
        q = check_query(point, self.dim, self._dtype(), self.device)
        pts, qc, invalid = self._radius_args(q[None, :])
        mask = bf.radius_mask(pts, qc, distance, self.metric,
                              invalid=invalid)
        return np.flatnonzero(mask[0].cpu().numpy()).astype(np.int64)

    def query_radius_batch(self, queries, distance, *, cap: int | None = None,
                           inclusive: bool = True):
        """Batched radius search: the (Q, n) mask, or with ``cap`` the
        streamed (ids (Q, min(cap, n)), counts (Q,)) of ``bf.radius_capped``,
        ids ascending and -1 padded, counts exact past the cap.
        ``inclusive`` picks ``d <= r`` (default) or the strict ``d < r``
        (the reference's leaf-scan rule, ball_tree.rs:277)."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        pts, qc, invalid = self._radius_args(qs)
        if cap is None:
            return bf.radius_mask(pts, qc, distance, self.metric,
                                  inclusive=inclusive, invalid=invalid)
        return bf.radius_capped(pts, qc, distance, self.metric, cap=cap,
                                inclusive=inclusive, invalid=invalid)

    def query_radius_count_batch(self, queries, distance, *,
                                 inclusive: bool = True):
        """Per-query counts only: one streamed pass, no (Q, n) mask
        (``bf.radius_counts_streaming``)."""
        qs = check_query_batch(queries, self.dim, self._dtype(), self.device)
        pts, qc, invalid = self._radius_args(qs)
        return bf.radius_counts_streaming(pts, qc, distance, self.metric,
                                          inclusive=inclusive,
                                          invalid=invalid)
