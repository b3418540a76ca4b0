"""DynamicIndex: inserts and deletes over an immutable tree (the JAX
package's ``trees/dynamic.py``).

The reference's indexes are built once.  This wrapper adds a mutable
layer in the manner of a log-structured merge tree:

* the **base segment**: a ``BallTree`` over the live rows at the last
  rebuild, on the index's device, with a table from its row ids to the
  stable ids;
* the **delta segment**: the rows added since, scanned whole
  (``ops.bruteforce.knn``, ``radius_capped``), exact with no build;
* **tombstones**: pending deletes, masked out of the results.

Queries fetch the top (k + tombstones) of each segment, mask the
tombstones and take the k best of the union, exact at every moment.  When
the mutation load passes ``rebuild_threshold`` of the base, the index
compacts (``rebuild``): dead rows are dropped for good, and ids stay
stable, never reused.  The side tables are padded to powers of two
(``_pow2_pad``), as the JAX package pads them for its compiles; the
padding also sets the over-fetch widths, which decide the ids kept at
ties and when a radius count signals overflow, so the port keeps it.

``device=None`` means ``"cuda"`` and raises without a card; pass
``device="cpu"`` to run on the CPU.  ``save`` checkpoints the base tree
and the pending mutations (``utils.serialize``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import Metric, get_metric
from ..ops import bruteforce as bf
from ..ops.topk import smallest_k
from ..utils.validation import check_query, check_query_batch, resolve_device
from . import ball_query
from .ball import BallTree

__all__ = ["DynamicIndex"]


def _pow2_pad(n: int) -> int:
    """The next power of two (0 -> 0)."""
    return 0 if n == 0 else 1 << (n - 1).bit_length()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _fused_knn(points_perm, perm_norms, orig_ids, leaf_c, leaf_r, center,
               base_map, delta_rows, delta_map, tomb, qs, *,
               k_eff: int, kb: int, kd: int, shape, metric: Metric):
    """The two-segment k-NN (dynamic.py:48-79): the base tree's k-NN, the
    delta scan, the tombstone mask and one exact merge.

    ``kb`` and ``kd`` over-fetch each segment by the padded tombstone
    count, so dead rows cannot crowd out live candidates; padded delta
    rows are NaN (farthest) with id -1, and padded tombstone slots are -1,
    which only ever mask entries already -1."""
    d, i = ball_query.knn_query(points_perm, perm_norms, orig_ids, leaf_c,
                                leaf_r, qs, center, k=kb, shape=shape,
                                metric=metric)
    i = torch.where(i >= 0, base_map[i.clamp_min(0).long()], -1)
    if kd:
        dd, di = bf.knn(delta_rows, qs, kd, metric, backend="xla")
        di = torch.where(di >= 0, delta_map[di.clamp_min(0).long()], -1)
        d = torch.cat([d, dd], dim=1)
        i = torch.cat([i, di], dim=1)
    if tomb is not None:
        dead = torch.isin(i, tomb)
        d = torch.where(dead, torch.inf, d)
        i = torch.where(dead, -1, i)
    return smallest_k(d, i, k_eff)


def _fused_radius(points_perm, orig_ids, centroids, radii, base_map,
                  delta_rows, delta_map, tomb, qs, r, *, cap: int,
                  fetch: int, shape, metric: Metric, point_chunk: int):
    """The two-segment capped radius search (dynamic.py:82-123): the base
    tree's capped search (the ball tree's boundary rules), the strict
    ``d < r`` delta scan, the tombstone filter and a compaction.

    Each segment is over-fetched to ``fetch = cap + tombstone slots`` so
    dead rows cannot crowd out live ones; a segment count beyond even
    ``fetch`` forces the returned count above ``cap`` (the enlarge-and-
    retry signal), because the capped list would be incomplete."""
    bi, bc = ball_query.radius_query_capped(
        points_perm, orig_ids, centroids, radii, qs, r, shape=shape,
        metric=metric, cap=fetch, point_chunk=point_chunk)
    overflow = bc > fetch
    bi = torch.where(bi >= 0, base_map[bi.clamp_min(0).long()], -1)
    cnt = bc
    if delta_rows is not None:
        di, dc = bf.radius_capped(delta_rows, qs, r, metric, cap=fetch,
                                  inclusive=False)
        overflow = overflow | (dc > fetch)
        di = torch.where(di >= 0, delta_map[di.clamp_min(0).long()], -1)
        bi = torch.cat([bi, di], dim=1)
        cnt = cnt + dc
    if tomb is not None:
        dead = torch.isin(bi, tomb) & (bi >= 0)
        cnt = cnt - torch.sum(dead, dim=1, dtype=cnt.dtype)
        bi = torch.where(dead, -1, bi)
    # compact: live ids first, in order (a stable sort on "is -1")
    order = torch.sort((bi < 0).to(torch.uint8), dim=1, stable=True).indices
    bi = torch.gather(bi, 1, order)[:, :cap]
    cnt = torch.where(overflow, torch.clamp_min(cnt, cap + 1), cnt)
    return bi, cnt


class DynamicIndex:
    """Exact k-NN index supporting add/remove between rebuilds."""

    def __init__(self, points, metric: Metric | str = "euclidean", *,
                 leaf_size: int | None = 128,
                 rebuild_threshold: float = 0.25, device=None):
        self.metric = get_metric(metric)
        self.device = resolve_device(device)
        self._leaf_size = leaf_size
        self.rebuild_threshold = float(rebuild_threshold)
        pts = _host(points)
        self._base = BallTree(pts, self.metric, leaf_size=leaf_size,
                              device=self.device)
        self._base_rows = self._base.points.cpu().numpy()
        self._base_ids = np.arange(pts.shape[0], dtype=np.int64)
        self._delta_rows: list[np.ndarray] = []
        self._delta_ids: list[np.ndarray] = []
        self._tombstones: set[int] = set()         # pending deletes
        self._next_id = pts.shape[0]
        self._mut_cache = None                     # device mutation state
        self._base_map_dev = None

    @classmethod
    def _from_state(cls, base_rows, metric, leaf_size, centroids, radii,
                    idx, base_ids, delta_rows, delta_ids, tombstones,
                    next_id, rebuild_threshold, *, device=None):
        """An index from its state (dynamic.py:145-167): the base tree from
        its arrays, with no rebuild, and the pending mutations (delta
        rows, tombstones) where they were."""
        self = cls.__new__(cls)
        self.metric = get_metric(metric)
        self.device = resolve_device(device)
        self._leaf_size = leaf_size
        self.rebuild_threshold = float(rebuild_threshold)
        self._base = BallTree._from_arrays(base_rows, self.metric,
                                           leaf_size, centroids, radii, idx,
                                           device=self.device)
        self._base_rows = self._base.points.cpu().numpy()
        self._base_ids = np.asarray(base_ids, dtype=np.int64)
        delta_rows = np.asarray(delta_rows)
        self._delta_rows = [delta_rows] if len(delta_rows) else []
        self._delta_ids = ([np.asarray(delta_ids, dtype=np.int64)]
                           if len(delta_rows) else [])
        self._tombstones = set(int(t) for t in np.asarray(tombstones))
        self._next_id = int(next_id)
        self._mut_cache = None
        self._base_map_dev = None
        return self

    def save(self, path) -> None:
        """Checkpoint the index to an ``.npz`` (``utils.serialize``)."""
        from ..utils.serialize import save_index
        save_index(self, path)

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self._base.dim

    @property
    def num_points(self) -> int:
        """Live points (added minus removed)."""
        return (len(self._base_ids)
                + sum(len(r) for r in self._delta_rows)
                - len(self._tombstones))

    def _live_ids(self) -> np.ndarray:
        ids = np.concatenate([self._base_ids] + self._delta_ids)
        if self._tombstones:
            ids = np.setdiff1d(
                ids, np.fromiter(self._tombstones, dtype=np.int64,
                                 count=len(self._tombstones)))
        return ids

    def add(self, new_points) -> np.ndarray:
        """Insert rows; returns their stable ids (never reused)."""
        new = np.ascontiguousarray(
            np.asarray(_host(new_points), dtype=self._base_rows.dtype))
        if new.ndim == 1:
            new = new[None, :]
        ids = np.arange(self._next_id, self._next_id + len(new))
        self._next_id += len(new)
        self._delta_rows.append(new)
        self._delta_ids.append(ids)
        self._invalidate_caches()
        self._maybe_rebuild()
        return ids

    def remove(self, ids) -> None:
        """Tombstone live ids.  Removing an id already removed (or never
        live) is a no-op; out-of-range ids raise ``IndexError``, and
        removing every live row raises ``ValueError``."""
        live = set(self._live_ids().tolist())
        pend = set()
        for i in np.atleast_1d(_host(ids)):
            i = int(i)
            if not 0 <= i < self._next_id:
                raise IndexError(f"id {i} out of range")
            if i in live:
                pend.add(i)
        if len(pend) >= self.num_points and pend:
            raise ValueError(
                "cannot remove every remaining point: the index requires "
                "at least one live row (reference Empty contract)")
        self._tombstones.update(pend)
        self._invalidate_caches()
        self._maybe_rebuild()

    def rebuild(self) -> None:
        """Compact delta and tombstones into a fresh base tree.  Dead rows
        are dropped for good; ids stay stable."""
        rows = np.concatenate([self._base_rows] + self._delta_rows, axis=0)
        ids = np.concatenate([self._base_ids] + self._delta_ids)
        if self._tombstones:
            gone = np.fromiter(self._tombstones, dtype=np.int64,
                               count=len(self._tombstones))
            alive = ~np.isin(ids, gone)
            rows, ids = rows[alive], ids[alive]
        self._base = BallTree(rows, self.metric, leaf_size=self._leaf_size,
                              device=self.device)
        self._base_rows = rows
        self._base_ids = ids
        self._delta_rows = []
        self._delta_ids = []
        self._tombstones = set()
        self._invalidate_caches()

    def _maybe_rebuild(self) -> None:
        base_n = len(self._base_ids)
        load = (sum(len(r) for r in self._delta_rows)
                + len(self._tombstones))
        if base_n and load / base_n > self.rebuild_threshold:
            self.rebuild()

    # ------------------------------------------------------------------
    def _padded_mutation_state(self):
        """(delta_rows, delta_map, tomb) on the device, padded to
        power-of-two lengths with NaN rows, -1 ids and -1 tombstones;
        kept until the next add, remove or rebuild."""
        if self._mut_cache is not None:
            return self._mut_cache
        dtype = self._base_rows.dtype
        if self._delta_rows:
            rows = np.concatenate(self._delta_rows, axis=0)
            ids = np.concatenate(self._delta_ids)
            m = _pow2_pad(len(rows))
            if m != len(rows):
                rows = np.concatenate(
                    [rows, np.full((m - len(rows), rows.shape[1]), np.nan,
                                   dtype=dtype)])
                ids = np.concatenate(
                    [ids, np.full(m - len(ids), -1, dtype=ids.dtype)])
            delta_rows = torch.from_numpy(rows).to(self.device)
            delta_map = torch.from_numpy(ids.astype(np.int32)).to(self.device)
        else:
            delta_rows = delta_map = None
        t = len(self._tombstones)
        if t:
            tomb_np = np.full(_pow2_pad(t), -1, dtype=np.int32)
            tomb_np[:t] = sorted(self._tombstones)
            tomb = torch.from_numpy(tomb_np).to(self.device)
        else:
            tomb = None
        self._mut_cache = (delta_rows, delta_map, tomb)
        return self._mut_cache

    def _base_map(self):
        if self._base_map_dev is None:
            self._base_map_dev = torch.from_numpy(
                self._base_ids.astype(np.int32)).to(self.device)
        return self._base_map_dev

    def _invalidate_caches(self) -> None:
        self._mut_cache = None
        self._base_map_dev = None

    def query_batch(self, queries, k: int):
        """Exact k nearest among the live points: (distances, ids
        (int32)), each (Q, min(k, live)), ascending (``_fused_knn``)."""
        dtype = self._base.points.dtype
        qs = check_query_batch(queries, self.dim, dtype, self.device)
        k_eff = min(int(k), self.num_points)
        if k_eff == 0:
            return (torch.zeros((qs.shape[0], 0), dtype=dtype,
                                device=self.device),
                    torch.zeros((qs.shape[0], 0), dtype=torch.int32,
                                device=self.device))
        delta_rows, delta_map, tomb = self._padded_mutation_state()
        t_pad = 0 if tomb is None else tomb.shape[0]
        kb = min(k_eff + t_pad, len(self._base_ids))
        kd = 0 if delta_rows is None \
            else min(k_eff + t_pad, delta_rows.shape[0])
        base = self._base
        return _fused_knn(
            base._points_perm, base._perm_norms, base._orig_ids,
            base._leaf_centroids, base._leaf_radii, base._qcenter,
            self._base_map(), delta_rows, delta_map, tomb, qs,
            k_eff=k_eff, kb=kb, kd=kd, shape=base.shape, metric=self.metric)

    def query(self, point, k: int):
        """k nearest live points as numpy (ids, distances)."""
        qs = check_query(point, self.dim, self._base.points.dtype,
                         self.device)
        d, i = self.query_batch(qs[None, :], k)
        return i[0].cpu().numpy(), d[0].cpu().numpy()

    def query_nearest(self, point):
        i, d = self.query(point, 1)
        return int(i[0]), float(d[0])

    def query_radius_batch(self, queries, distance, *, cap: int):
        """Capped radius search over the live points: (ids (Q, cap) int32,
        counts (Q,) int32), tombstones filtered (``_fused_radius``).

        Boundary rule: delta rows are scanned with the strict ``d < r`` of
        the base tree's leaf scan (a whole scan is a leaf scan), so a point
        keeps its membership when ``rebuild()`` moves it into the base,
        except through the base's own inclusive whole-subtree take
        (``ub <= r``, ball_tree.rs:271-277), which holds for every
        ``BallTree`` point.  A segment whose count passes even the
        over-fetched width forces the count above ``cap``."""
        base = self._base
        qs = check_query_batch(queries, self.dim, base.points.dtype,
                               self.device)
        delta_rows, delta_map, tomb = self._padded_mutation_state()
        t_pad = 0 if tomb is None else tomb.shape[0]
        chunk = bf._pick_chunk(base.n, qs.shape[0], base.dim, None,
                               direct=True)
        return _fused_radius(
            base._points_perm, base._orig_ids, base._centroids,
            base._radii, self._base_map(), delta_rows, delta_map, tomb,
            qs, distance, cap=cap, fetch=cap + t_pad, shape=base.shape,
            metric=self.metric, point_chunk=chunk)

    def query_radius(self, point, distance):
        """Live ids within ``distance`` as numpy int64, ascending."""
        qs = check_query(point, self.dim, self._base.points.dtype,
                         self.device)
        ids, _ = self.query_radius_batch(qs[None, :], distance,
                                         cap=self.num_points)
        out = ids[0].cpu().numpy()
        return np.sort(out[out >= 0]).astype(np.int64)
