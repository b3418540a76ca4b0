"""Row sort of (f32 key, int32 payload) pairs on the card, in the place of
the counting rank.

Counterpart of ``petal_neighbors_tpu/ops/pallas/rank_sort_kernel.py``: the
re-rank of ``ops.bruteforce._rescore_large`` and ``_bcap_rescore_large`` at
widths above 2048.  The TPU kernel ranks every element against the whole
row; the card computes the same order with the block sort of
``csrc/row_sort.cu`` that ``bitonic_sort_pairs`` launches too (a register
bitonic network per warp, then merge-path merges of the warps' runs), with
its own launch count.  CPU tensors run ``rank_sort_pairs_reference``; a CUDA
tensor launches the kernel or raises.

Contract: keys NaN-free (-0.0 ties with +0.0); each row sorts ascending; the
payload follows its key; ties go by input position, so the output equals a
stable sort and a gather, bit for bit, payloads included.
"""

from __future__ import annotations

from .sort_kernel import check_pairs, launch_sort, sort_pairs_reference

__all__ = ["rank_sort_pairs", "rank_sort_pairs_reference"]

rank_sort_pairs_reference = sort_pairs_reference


def rank_sort_pairs(keys, vals):
    """Sort each row of ``keys`` (R, W) float32 ascending, carrying
    ``vals`` (R, W) int32, ties by input position; returns arrays of the
    original shape.  The TPU kernel pads rows to a multiple of 128 with
    (+inf, -1), and padding ranks after every entry of the row; the card
    pads to a multiple of 256 with words above every real one, so both
    return the row's own entries.  W <= 8192.  CUDA tensors launch the
    block sort of ``csrc/row_sort.cu`` (counted in
    ``rank_sort_pairs.launches``); CPU tensors run
    ``rank_sort_pairs_reference``."""
    check_pairs(keys, vals, "rank_sort_pairs")
    if keys.device.type == "cpu":
        return rank_sort_pairs_reference(keys, vals)
    out = launch_sort("rank_sort_launch", keys, vals, "rank_sort_pairs")
    rank_sort_pairs.launches += 1
    return out


#: kernel launches (plain-version calls do not count)
rank_sort_pairs.launches = 0
