"""Top-k primitives with the reference's NaN/total-order policy.

The reference gets a total order from ``OrderedFloat`` (NaN sorts greater
than every number, CHANGELOG.md:111-115), so a NaN-coordinate point is
"farther than everything" instead of poisoning comparisons.  Here the same
policy is a single ``where(isnan, +inf)`` applied before selection.

All functions operate on the **last axis** and return results sorted
ascending by distance (the reference's ``query`` contract,
ball_tree.rs:117-120).
"""

from __future__ import annotations

import torch

from .cuda.rescore_kernel import rescore_rd

__all__ = ["nan_to_inf", "smallest_k", "merge_topk", "monotone_distances",
           "rescore_exact"]


def nan_to_inf(d: torch.Tensor) -> torch.Tensor:
    """Map NaN distances to +inf (OrderedFloat NaN-is-greatest policy)."""
    return torch.where(torch.isnan(d), torch.inf, d)


def monotone_distances(d: torch.Tensor) -> torch.Tensor:
    """Running max along the last axis: restore the ascending contract
    after an rd -> distance conversion.

    Results are sorted in the rdistance domain; a sqrt that is not
    monotone at the ulp level could convert two rds 1-2 ulps apart into
    inverted distances.  The running max clamps such inversions within
    the conversion's own error band.  +inf tails are fixed points."""
    if d.shape[-1] == 0:
        return d
    return torch.cummax(d, dim=-1).values


def smallest_k(dists: torch.Tensor, indices: torch.Tensor, k: int):
    """Smallest-``k`` (values ascending) along the last axis.

    ``indices`` carries the payload (original point ids) selected alongside.
    Ties are broken toward the earlier position — a stable sort, since
    ``torch.topk`` promises no tie order (the reference's heap tie order is
    arbitrary; only distances are part of its contract,
    ball_tree.rs:396-421).
    """
    d = nan_to_inf(dists)
    width = d.shape[-1]
    if width < k:  # fewer candidates than k: pad with +inf / -1
        pad = (0, k - width)
        d = torch.nn.functional.pad(d, pad, value=float("inf"))
        indices = torch.nn.functional.pad(indices, pad, value=-1)
    vals, pos = torch.sort(d, dim=-1, stable=True)
    pos = pos[..., :k]
    return vals[..., :k], torch.gather(indices, -1, pos)


def merge_topk(d1, i1, d2, i2, k: int):
    """Merge two ascending top-k lists into one ascending top-k list."""
    return smallest_k(torch.cat([d1, d2], dim=-1),
                      torch.cat([i1, i2], dim=-1), k)


def rescore_exact(points, queries, idx, k: int):
    """Re-score candidate ids with the direct (q-x)^2 form and re-rank.

    The matmul distance form loses absolute accuracy ~eps*(|q|^2+|x|^2) to
    cancellation; every matmul-candidate path funnels its top-(k+slack)
    through this single helper to restore exact-to-rounding distances
    (``rescore_rd``: one gather-and-score kernel on the card).  ``idx``
    (Q, k_in) entries < 0 (or >= len(points)) are treated as missing.

    Returns (rdist, idx) ascending, shapes (Q, k).
    """
    n = points.shape[0]
    rd = rescore_rd(points, queries, idx)
    return smallest_k(rd, torch.where((idx >= 0) & (idx < n), idx, -1), k)
