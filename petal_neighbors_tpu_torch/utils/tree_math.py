"""Static complete-binary-tree geometry (a copy of the JAX package's
``utils/tree_math.py``: NumPy only).

The reference ball tree stores nodes in a flat array with the implicit
children-of-``i``-are-``2i+1, 2i+2`` layout and splits every range at the
exact midpoint (ball_tree.rs:51-56, :535).  A crucial consequence: **the
tree shape — node count, every node's point range, leaf flags, and the
mapping from point position to owning node at each level — is a pure
function of ``n`` (and the leaf-size policy)**.  Nothing here depends on
the data, so all of it is computed once on the host as plain NumPy and
treated as static metadata by the query and build code.

Sizing policies
---------------
* ``leaf_size=None`` (reference parity): ``height = n.bit_length()``,
  ``n_nodes = 2**height - 1`` — identical to ball_tree.rs:51-52, leaves
  hold 1-2 points.
* ``leaf_size=L``: smallest height whose leaves hold at most ``L``
  points.  Batched leaf scans want L ~ 128-256, not 2 (SURVEY.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

__all__ = ["TreeShape", "tree_shape"]


def _ceil_log2(x: int) -> int:
    return int(x - 1).bit_length() if x > 1 else 0


@dataclass(frozen=True, eq=False)  # eq=False: identity hash — instances are
# interned per (n, leaf_size) by the lru_cache below.
class TreeShape:
    """All static geometry for a complete ball tree over ``n`` points."""

    n: int
    height: int                      # number of levels (root = level 0)
    n_nodes: int                     # 2**height - 1
    n_leaves: int                    # 2**(height-1)
    range_start: np.ndarray          # (n_nodes,) int64
    range_end: np.ndarray            # (n_nodes,) int64
    is_leaf: np.ndarray              # (n_nodes,) bool
    # node_of_pos[l][p] = node id owning point-position p at level l
    node_of_pos: tuple = field(repr=False, default=())
    max_leaf_points: int = 0

    @property
    def leaf_offset(self) -> int:
        """Node id of the first leaf (leaves are the last level)."""
        return self.n_leaves - 1

    def level_slice(self, level: int) -> slice:
        """Node ids at ``level`` occupy [2**level - 1, 2**(level+1) - 1)."""
        return slice((1 << level) - 1, (1 << (level + 1)) - 1)


@lru_cache(maxsize=256)
def tree_shape(n: int, leaf_size: int | None = None) -> TreeShape:
    """Compute the static tree geometry for ``n`` points.

    ``leaf_size=None`` reproduces the reference sizing exactly
    (ball_tree.rs:51-52): height = floor(log2 n) + 1.
    """
    if n < 1:
        raise ValueError("tree requires at least one point")
    if leaf_size is None:
        height = n.bit_length()
    else:
        if leaf_size < 1:
            raise ValueError("leaf_size must be >= 1")
        # leaf_size >= 2 guarantees every leaf is non-empty under minimal
        # height (n >= n_leaves); leaf_size == 1 could strand empty leaves.
        leaf_size = max(leaf_size, 2)
        # smallest h with ceil(n / 2**(h-1)) <= leaf_size
        height = 1 + max(0, _ceil_log2(-(-n // leaf_size)))
    n_nodes = (1 << height) - 1
    n_leaves = 1 << (height - 1)

    range_start = np.zeros(n_nodes, dtype=np.int64)
    range_end = np.zeros(n_nodes, dtype=np.int64)
    range_start[0], range_end[0] = 0, n
    # children split at mid = (start + end) // 2  (ball_tree.rs:535)
    for i in range(n_leaves - 1):  # internal nodes only
        s, e = range_start[i], range_end[i]
        mid = (s + e) // 2
        l, r = 2 * i + 1, 2 * i + 2
        range_start[l], range_end[l] = s, mid
        range_start[r], range_end[r] = mid, e

    is_leaf = np.zeros(n_nodes, dtype=bool)
    is_leaf[n_leaves - 1:] = True

    node_of_pos = []
    for level in range(height):
        lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
        m = np.zeros(n, dtype=np.int32)
        for node in range(lo, hi):
            m[range_start[node]:range_end[node]] = node
        node_of_pos.append(m)

    sizes = range_end[n_leaves - 1:] - range_start[n_leaves - 1:]
    return TreeShape(
        n=n,
        height=height,
        n_nodes=n_nodes,
        n_leaves=n_leaves,
        range_start=range_start,
        range_end=range_end,
        is_leaf=is_leaf,
        node_of_pos=tuple(node_of_pos),
        max_leaf_points=int(sizes.max()),
    )
