"""Counting-rank row sort of (f32 key, int32 payload) pairs on the card.

Counterpart of ``petal_neighbors_tpu/ops/pallas/rank_sort_kernel.py``: the
re-rank of ``ops.bruteforce._rescore_large`` at widths above 2048.
``rank_sort_pairs`` launches ``csrc/row_sort.cu``'s counting-rank kernel
(one block per row) for CUDA tensors and runs ``rank_sort_pairs_reference``
for CPU tensors; a CUDA tensor launches the kernel or raises.

Contract: keys NaN-free; each row sorts ascending; the payload follows its
key; ties break by input position, so the output equals a stable sort bit
for bit.
"""

from __future__ import annotations

from .sort_kernel import check_pairs, launch_sort, sort_pairs_reference

__all__ = ["rank_sort_pairs", "rank_sort_pairs_reference"]

rank_sort_pairs_reference = sort_pairs_reference


def rank_sort_pairs(keys, vals):
    """Sort each row of ``keys`` (R, W) float32 ascending, carrying
    ``vals`` (R, W) int32, ties by input position; returns arrays of the
    original shape.  The TPU kernel pads rows to a multiple of 128 with
    (+inf, -1); padding ranks after every entry of the row, so the card
    ranks the row as it is.  W <= 8192.  CUDA tensors launch the
    counting-rank kernel (counted in ``rank_sort_pairs.launches``); CPU
    tensors run ``rank_sort_pairs_reference``."""
    check_pairs(keys, vals, "rank_sort_pairs")
    if keys.device.type == "cpu":
        return rank_sort_pairs_reference(keys, vals)
    out = launch_sort("rank_sort_launch", keys, vals, "rank_sort_pairs")
    rank_sort_pairs.launches += 1
    return out


#: kernel launches (plain-version calls do not count)
rank_sort_pairs.launches = 0
