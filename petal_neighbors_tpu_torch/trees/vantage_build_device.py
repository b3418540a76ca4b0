"""The level-synchronous vantage-point-tree build on the index's device (the
JAX package's ``trees/vantage_build_device.py``).

The reference builds the VP tree recursively (vantage_point_tree.rs:
146-197), but its shape is static: the vantage point is the last element
of each slice and the near/far split is at ``len(rest) // 2``, so every
level's segment ranges depend on ``n`` alone (``vp_shape``, NumPy, a copy
of the JAX package's).  The recursion becomes one step per level, over
every segment of the level at once:

  the distance of each member to its segment's vantage point (one
  rowwise pass), then two stable sorts, by that distance and then by
  segment (``lax.sort((block, key, iota), num_keys=2)`` in the JAX
  package), which order every segment's rest at once, and a gather of the
  median radii.

Positions outside the level's segments (vantage points fixed at earlier
levels) are blocks of their own, so the sorts leave them in place; within
a segment the vantage row carries a NaN key, which ``torch.sort`` places
last, as the XLA total order does, so it stays at the segment's end.

Node numbering is level order (the host builders number in the
reference's pre-order); the tree is the same: vantage = slice-last,
radius = median distance, near = the closer half.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..distance import Metric

__all__ = ["VpShape", "vp_shape", "build_device"]

NULL = -1


@dataclass(frozen=True, eq=False)
class VpShape:
    """Static VP-tree geometry for n points (node ids in level order).

    Per level: ``(starts, ends, node_ids, vp_positions, rad_positions)`` of
    its segments, in position order."""

    n: int
    depth: int
    n_nodes: int
    levels: tuple = field(repr=False, default=())
    near: np.ndarray = None
    far: np.ndarray = None
    is_leaf: np.ndarray = None


@lru_cache(maxsize=8)
def vp_shape(n: int) -> VpShape:
    """Mirrors create_node's slicing (vantage_point_tree.rs:169-195):
    segment [s, e) has vantage at e-1; rest [s, e-1) splits at
    half = (e-1-s)//2 into near [s, s+half) and far [s+half, e-1)."""
    near_l, far_l, leaf = [], [], []
    levels = []
    frontier = [(0, n, 0)]        # (start, end, node_id), position-ordered
    next_id = 1
    depth = 0
    while frontier:
        starts = np.array([s for s, _, _ in frontier])
        ends = np.array([e for _, e, _ in frontier])
        node_ids = np.array([i for _, _, i in frontier])

        vp_positions = (ends - 1).astype(np.int32)
        # median position of the sorted rest; singletons point at e-1
        # (unused: their radius stays MAX)
        halves = np.maximum(ends - 1 - starts, 0) // 2
        rad_positions = (starts + halves).astype(np.int32)

        levels.append((starts.astype(np.int64), ends.astype(np.int64),
                       node_ids, vp_positions, rad_positions))

        nxt = []
        for (s, e, node) in frontier:
            assert node == len(near_l)
            if e - s == 1:
                near_l.append(NULL)
                far_l.append(NULL)
                leaf.append(True)
                continue
            leaf.append(False)
            half = (e - 1 - s) // 2
            for cs, ce, out_list in ((s, s + half, near_l),
                                     (s + half, e - 1, far_l)):
                if ce - cs == 0:
                    out_list.append(NULL)
                else:
                    out_list.append(next_id)
                    nxt.append((cs, ce, next_id))
                    next_id += 1
        frontier = nxt
        if frontier:
            depth += 1

    return VpShape(
        n=n, depth=depth, n_nodes=next_id,
        levels=tuple(levels),
        near=np.array(near_l, dtype=np.int64),
        far=np.array(far_l, dtype=np.int64),
        is_leaf=np.array(leaf, dtype=bool),
    )


def _level_maps(starts, ends, n: int, iota):
    """Per-position maps of one level, on the device: ``block``, the sort
    block of each position (each segment one block, each position outside
    the segments a block of its own), and ``vpp``, the position of its
    segment's vantage point (its own position outside the segments)."""
    dev = iota.device
    s = torch.from_numpy(starts).to(dev)
    e = torch.from_numpy(ends).to(dev)
    ones = torch.ones_like(s)
    mark = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    mark.index_add_(0, s, ones).index_add_(0, e, -ones)
    in_seg = torch.cumsum(mark, 0)[:n] > 0            # segments are disjoint
    bnd = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    bnd[s] = True
    bnd[e] = True
    out = torch.nonzero(~in_seg).flatten()
    bnd[out] = True
    bnd[out + 1] = True
    block = torch.cumsum(bnd[:n], 0) - 1
    seg = torch.clamp_min(torch.searchsorted(s, iota, right=True) - 1, 0)
    vpp = torch.where(in_seg, e[seg] - 1, iota)
    return block, vpp


def _build(points: torch.Tensor, shape: VpShape, metric: Metric):
    n = points.shape[0]
    dev, dtype = points.device, points.dtype
    fmax = torch.finfo(dtype).max
    iota = torch.arange(n, device=dev)
    ids = iota.clone()
    vp = torch.zeros((shape.n_nodes,), dtype=torch.int64, device=dev)
    radius = torch.full((shape.n_nodes,), fmax, dtype=dtype, device=dev)

    for starts, ends, node_ids, vp_positions, rad_positions in shape.levels:
        block, vpp = _level_maps(starts, ends, n, iota)
        # distance of every member to its segment's vantage point
        dist = metric.rowwise_dist(points[ids], points[ids[vpp]])
        nodes = torch.from_numpy(node_ids.astype(np.int64)).to(dev)
        vp[nodes] = ids[torch.from_numpy(vp_positions.astype(np.int64)).to(
            dev)]
        # the two-key sort, both stable: by distance, then by block; the
        # vantage rows (and pinned rows, vpp == own position) carry NaN,
        # which sorts last, so they keep their places
        key = torch.where(vpp == iota, torch.nan, dist).to(dtype)
        by_key = torch.sort(key, stable=True).indices
        perm = by_key[torch.sort(block[by_key], stable=True).indices]
        ids = ids[perm]
        key_sorted = key[perm]
        # radius = median of the sorted rest (vantage_point_tree.rs:180-182);
        # NaN medians (NaN data) stay NaN like the host builder's
        leaf = torch.from_numpy(shape.is_leaf[node_ids]).to(dev)
        med = key_sorted[torch.from_numpy(rad_positions.astype(np.int64)).to(
            dev)]
        radius[nodes] = torch.where(leaf, fmax, med)
    return vp, radius


def build_device(points: torch.Tensor, metric: Metric):
    """Build on ``points.device``.  Returns (vp, radius, near, far, root,
    depth) as NumPy, with the host builders' structure (vantage =
    slice-last, median radius, near = the closer half) in level-order
    node numbering."""
    shape = vp_shape(int(points.shape[0]))
    vp, radius = _build(points, shape, metric)
    return (vp.cpu().numpy(), radius.cpu().numpy(), shape.near.copy(),
            shape.far.copy(), 0, shape.depth)
