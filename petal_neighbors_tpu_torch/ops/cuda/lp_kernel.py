"""Exact Lp / Chebyshev k-NN on the card: the Lp kernel and its plain
version.

Counterpart of ``petal_neighbors_tpu/ops/pallas/lp_kernel.py``: the score
of a (query, point) pair is the direct reduced distance, ``sum |q − x|^p``
(Minkowski, Manhattan) or ``max |q − x|`` (Chebyshev), plus the row's
additive mask (0, or +inf on NaN and padding rows, ``pad_for_lp``).  The
power sum has no cancellation, so the kernel's scores are final: callers
take the p-th root and need no rescore and no proof.

``lp_knn`` launches ``csrc/lp_knn.cu`` (the merge kernel of
``csrc/knn_tiles.cuh`` over an Lp score operation) for CUDA tensors and
runs ``lp_knn_reference`` for CPU tensors.  Nothing else selects between
them: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["LpSpec", "lp_spec_for", "pad_for_lp", "lp_knn",
           "lp_knn_reference", "LP_K_MAX"]

#: largest k the kernel serves (lp_kernel.py:201)
LP_K_MAX = 4096


class LpSpec:
    """How one coordinate difference contributes (lp_kernel.py:42-80).

    ``p``: the exponent (integer ``p <= 64`` takes a multiply chain);
    ``reduce``: "sum" (Minkowski / Manhattan) or "max" (Chebyshev)."""

    def __init__(self, p: float, reduce: str = "sum"):
        self.p = float(p)
        self.p_int = int(p) if float(p).is_integer() and p <= 64 else None
        self.reduce = reduce

    def __eq__(self, other):
        return (type(other) is LpSpec and self.p == other.p
                and self.reduce == other.reduce)

    def __hash__(self):
        return hash((self.p, self.reduce))

    def __repr__(self):
        return f"LpSpec(p={self.p}, reduce={self.reduce!r})"

    def elem(self, diff):
        """``|diff| ** p`` with the integer multiply-chain fast path; even
        powers skip the ``abs``."""
        if self.reduce == "max" or self.p == 1.0:
            return torch.abs(diff)
        if self.p_int is not None:
            base = diff if self.p_int % 2 == 0 else torch.abs(diff)
            return torch.pow(base, self.p_int)
        return torch.abs(diff) ** self.p

    def accum(self, contrib):
        """Reduce the contributions over the last axis."""
        if self.reduce == "max":
            # NaN propagates, as jnp.max does
            return torch.amax(contrib, dim=-1)
        return torch.sum(contrib, dim=-1)

    def op(self) -> int:
        """The kernel's operation code (``csrc/lp_knn.cu`` OP_*)."""
        if self.reduce == "max":
            return 1
        if self.p == 1.0:
            return 0
        if self.p_int == 3:
            return 2
        return 3 if self.p_int is not None else 4


def lp_spec_for(metric) -> LpSpec | None:
    """LpSpec for a metric the kernel serves, else None
    (lp_kernel.py:83-92)."""
    from ...distance import Chebyshev, Manhattan, Minkowski
    if isinstance(metric, Chebyshev):
        return LpSpec(1.0, "max")
    if isinstance(metric, Manhattan):
        return LpSpec(1.0, "sum")
    if type(metric) is Minkowski:
        return LpSpec(metric.p, "sum")
    return None


def pad_for_lp(points: torch.Tensor, *, tn: int, bad=None):
    """(points_padded, mask) for the Lp kernel (lp_kernel.py:95-108): NaN
    rows zeroed; the mask is 0.0 on live rows and +inf on NaN and padding
    rows (added to the scores: the exclusion).  Rows pad to a multiple of
    ``tn``."""
    n = points.shape[0]
    if bad is None:
        bad = torch.isnan(points).any(dim=-1)
    points = torch.where(bad[:, None], 0.0, points)
    mask = torch.where(bad, torch.inf, 0.0).to(torch.float32)
    npad = (-n) % tn
    if npad:
        points = torch.nn.functional.pad(points, (0, 0, 0, npad))
        mask = torch.nn.functional.pad(mask, (0, npad), value=float("inf"))
    return points, mask


def _check(points, mask, queries, k: int, spec: LpSpec) -> None:
    if not 1 <= k <= LP_K_MAX:
        raise ValueError(f"lp_knn takes 1 <= k <= {LP_K_MAX}, got {k}")
    if points.ndim != 2 or queries.ndim != 2 or mask.ndim != 1:
        raise ValueError("lp_knn wants points (N, d), mask (N,) and queries "
                         "(Q, d)")
    n, d = points.shape
    if queries.shape[1] != d or mask.shape[0] != n or n == 0:
        raise ValueError(
            f"shape mismatch: points {tuple(points.shape)}, mask "
            f"{tuple(mask.shape)}, queries {tuple(queries.shape)}")
    for what, t in (("points", points), ("mask", mask),
                    ("queries", queries)):
        if t.dtype != torch.float32:
            raise TypeError(f"lp_knn wants float32 {what}, got {t.dtype}")
        if t.device != points.device:
            raise ValueError("lp_knn wants all inputs on one device")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lp_knn runs on CUDA or CPU, not {points.device}")
    if spec.reduce not in ("sum", "max") or not spec.p >= 1.0:
        raise ValueError(f"lp_knn takes p >= 1 and reduce sum or max, got "
                         f"{spec}")


def lp_knn_reference(points, mask, queries, *, k: int, spec: LpSpec):
    """Plain PyTorch version of the Lp kernel: the direct power sum (or
    max) over chunks of queries and points, plus the mask, with a running
    stable sort.

    The running set goes before each chunk's candidates, so a candidate
    enters only if it is strictly below the k-th kept value (the kernel's
    ``s < tau``), ties go to the smaller id, and +inf never displaces an
    empty (+inf, -1) slot.  NaN scores count as +inf.  Returns (rdist (Q,
    k) float32 ascending, ids (Q, k) int32)."""
    _check(points, mask, queries, k, spec)
    nq, d = queries.shape
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    qc = min(nq, 256)
    # about 16M elements of the (queries, rows, d) difference per step
    rows = max(1, (1 << 24) // max(1, qc * d))
    for q0 in range(0, nq, qc):
        qs = queries[q0:q0 + qc]
        best_d = torch.full((qs.shape[0], k), torch.inf, dtype=torch.float32,
                            device=dev)
        best_i = torch.full((qs.shape[0], k), -1, dtype=torch.int32,
                            device=dev)
        for s in range(0, points.shape[0], rows):
            diff = qs[:, None, :] - points[None, s:s + rows, :]
            sc = spec.accum(spec.elem(diff)) + mask[None, s:s + rows]
            sc = torch.where(torch.isnan(sc), torch.inf, sc)
            ids = torch.arange(s, s + sc.shape[1], dtype=torch.int32,
                               device=dev).expand(qs.shape[0], -1)
            cat_d = torch.cat([best_d, sc], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            best_d, pos = torch.sort(cat_d, dim=1, stable=True)
            best_d = best_d[:, :k]
            best_i = torch.gather(cat_i, 1, pos[:, :k])
        out_d[q0:q0 + qc] = torch.where(best_i < 0, torch.inf, best_d)
        out_i[q0:q0 + qc] = best_i
    return out_d, out_i


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("lp_knn")
    p = ctypes.POINTER(ctypes.c_int)
    lib.lp_constants.argtypes = [p, p]
    lib.lp_constants.restype = None
    lib.lp_plan.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, p]
    lib.lp_plan.restype = ctypes.c_int
    lib.lp_launch.argtypes = [ctypes.c_int, ctypes.c_float] + [
        ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.lp_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tq() -> int:
    tq, max_k = ctypes.c_int(0), ctypes.c_int(0)
    _lib().lp_constants(ctypes.byref(tq), ctypes.byref(max_k))
    if max_k.value != LP_K_MAX:
        raise RuntimeError(f"csrc/lp_knn.cu takes k <= {max_k.value}, this "
                           f"module {LP_K_MAX}")
    return tq.value


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, op: int, n: int, q: int, d: int) -> int:
    splits = ctypes.c_int(1)
    err = _lib().lp_plan(op, n, q, d, ctypes.byref(splits))
    if err != 0:
        raise RuntimeError(f"lp kernel planning failed: cudaError {err}")
    return splits.value


def lp_plan(spec: LpSpec, n: int, q: int, d: int) -> int:
    """The CUDA kernel's row-range splits on the current card."""
    return _plan(torch.cuda.current_device(), spec.op(), n, q, d)


def lp_knn(points, mask, queries, *, k: int, spec: LpSpec):
    """Exact Lp / Chebyshev k-NN over an index padded by ``pad_for_lp``
    (the ``lp_knn_pallas`` contract, lp_kernel.py:186-242).

    ``points`` (N, d), ``mask`` (N,) and ``queries`` (Q, d), float32 on one
    device; ``1 <= k <= 4096``.  Returns ``(rdist (Q, k) float32
    ascending, ids (Q, k) int32)``: rdist in the reduced domain (the p-th
    power sum, or max |diff|), ties in id order on the CPU (either way on
    the card's row ranges); NaN query rows and slots past the finite scores
    are (+inf, -1); masked rows never appear.

    CUDA tensors launch ``csrc/lp_knn.cu`` (counted in
    ``lp_knn.launches``); CPU tensors run ``lp_knn_reference``.
    """
    _check(points, mask, queries, k, spec)
    if points.device.type == "cpu":
        return lp_knn_reference(points, mask, queries, k=k, spec=spec)
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError("lp_knn ids are int32: N and Q must be < 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    mask = mask.contiguous()
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    op = spec.op()
    with torch.cuda.device(dev):
        s = _plan(dev.index if dev.index is not None
                  else torch.cuda.current_device(), op, n, nq, d)
        # scratch as the merge kernel's: each range's sorted set in two
        # slots, its fill and slot, the shared bound (all ones), counters
        part_d = torch.empty((s, nq, 2, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((s, nq, 2, k), dtype=torch.int32, device=dev)
        part_f = torch.empty((s, nq), dtype=torch.int32, device=dev)
        bound = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        counters = torch.zeros((-(-nq // _tq()),), dtype=torch.int32,
                               device=dev)
        err = _lib().lp_launch(
            op, spec.p, points.data_ptr(), queries.data_ptr(),
            mask.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), part_f.data_ptr(),
            bound.data_ptr(), counters.data_ptr(), n, nq, d, k, s,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lp_knn kernel launch failed: cudaError {err}")
    lp_knn.launches += 1
    return out_d, out_i


#: kernel launches (plain-version calls do not count)
lp_knn.launches = 0
