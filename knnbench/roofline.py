"""The least time of an exact flat k-NN search on one NVIDIA H100.

This counts the work of the search itself, whatever implements it: a
product of Q queries against N points of d features (2·Q·N·d operations)
at the card's dense bf16 tensor-core peak, and each input byte read once
plus each answer written once at its memory bandwidth.  The least time is
the larger of the two.  The port computes its products on bf16 tensor
cores already, so the float32 peak (67 TFLOP/s) would be beaten by a
correct implementation and is no bound.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at the full
700 W power limit.
"""

from __future__ import annotations

#: dense bf16 tensor-core operations a second
PEAK_FLOPS = 989e12
#: HBM3 bytes a second
PEAK_BYTES = 3.35e12

#: an answer is a float32 distance and an int64 id
ANSWER_BYTES = 4 + 8


def search_flops(q: int, n: int, d: int) -> float:
    return 2.0 * q * n * d


def search_bytes(q: int, n: int, d: int, k: int, itemsize: int = 4) -> float:
    """The points and queries read once, the (q, k) answers written once."""
    return float((n + q) * d * itemsize + q * min(k, n) * ANSWER_BYTES)


def least_seconds(q: int, n: int, d: int, k: int) -> float:
    return max(search_flops(q, n, d) / PEAK_FLOPS,
               search_bytes(q, n, d, k) / PEAK_BYTES)

