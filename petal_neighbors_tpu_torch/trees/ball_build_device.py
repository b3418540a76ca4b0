"""The level-synchronous ball-tree build on the index's device (the JAX
package's ``trees/ball_build_device.py``).

The recursive host build (ball_tree.rs:504-538) becomes one step per
level, each over every node of the level at once:

  segment sums, minima and maxima over the permuted points
  (``index_add_``, ``scatter_reduce``) give each node's centroid, radius
  and per-column spread; ``argmax`` picks the split column; and two
  stable sorts, by the split-column value and then by segment, partition
  every segment of the level around its median (``lax.sort((seg, key,
  iota), num_keys=2)`` in the JAX package).

Ranges and segment ids are static (``utils.tree_math``); the host drives
only the level loop.  Same geometry rules as the host builders: mean
centroid, the IEEE-maxNum radius fold (NaN distances count as 0),
first-wins max spread with NaN spreads never winning, and NaN last in the
partition order; ``idx`` equals ``build_host_vectorized``'s.  Centroid
sums accumulate in f64, as the host builders' do (the JAX package's device
build sums in the points' dtype): ``index_add_`` adds in no fixed order
on the card, and in f64 that order moves an f32 centroid by an ulp at
most, where in f32 it moved the 1M-point build's centroids by up to
6.8e-5 on an H100.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distance import Metric
from ..utils.tree_math import TreeShape
from .ball_build import BallTreeData

__all__ = ["build_device"]


def build_device(points: torch.Tensor, shape: TreeShape,
                 metric: Metric) -> BallTreeData:
    """Build on ``points.device``; centroids and radii stay there."""
    n, d = points.shape
    dev, dtype = points.device, points.dtype
    idx = torch.arange(n, device=dev)
    centroids = torch.zeros((shape.n_nodes, d), dtype=dtype, device=dev)
    radii = torch.zeros((shape.n_nodes,), dtype=dtype, device=dev)
    pp = points                      # points in the current permutation

    for level in range(shape.height):
        lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
        nseg = hi - lo
        seg = torch.from_numpy(
            shape.node_of_pos[level].astype(np.int64) - lo).to(dev)
        counts = torch.from_numpy(
            shape.range_end[lo:hi] - shape.range_start[lo:hi]).to(dev)

        # centroid = segment mean (ball_tree.rs:445-456)
        sums = torch.zeros((nseg, d), dtype=torch.float64,
                           device=dev).index_add_(0, seg, pp.double())
        cent = (sums / counts[:, None]).to(dtype)
        centroids[lo:hi] = cent

        # radius = IEEE-maxNum fold of the metric distances (:458-460)
        dist = metric.rowwise_dist(pp, cent[seg])
        dist = torch.where(torch.isnan(dist), 0.0, dist)
        radii[lo:hi] = torch.empty((nseg,), dtype=dtype, device=dev
                                   ).scatter_reduce_(0, seg, dist, "amax",
                                                     include_self=False)
        if level == shape.height - 1:
            break

        # split column: max spread, first wins; a NaN spread never wins
        # (:577-613).  A column with a NaN member has a NaN spread on the
        # host; the flag keeps that so whether or not the device's
        # reductions propagate NaN.
        seg_d = seg[:, None].expand(n, d)
        empty = torch.empty((nseg, d), dtype=dtype, device=dev)
        mins = empty.scatter_reduce(0, seg_d, pp, "amin", include_self=False)
        maxs = empty.scatter_reduce(0, seg_d, pp, "amax", include_self=False)
        has_nan = torch.zeros((nseg, d), dtype=torch.int32,
                              device=dev).index_add_(
                                  0, seg, torch.isnan(pp).to(torch.int32))
        spread = maxs - mins
        spread = torch.where(torch.isnan(spread) | (has_nan > 0), -torch.inf,
                             spread)
        cols = torch.argmax(spread, dim=1)

        # the two-key sort: by the value in the segment's split column,
        # then by segment, both stable (NaN last, +0 and -0 equal)
        key = torch.gather(pp, 1, cols[seg][:, None])[:, 0]
        by_key = torch.sort(key, stable=True).indices
        perm = by_key[torch.sort(seg[by_key], stable=True).indices]
        idx = idx[perm]
        pp = pp[perm]

    return BallTreeData(centroids=centroids, radii=radii,
                        idx=idx.cpu().numpy(), shape=shape)
