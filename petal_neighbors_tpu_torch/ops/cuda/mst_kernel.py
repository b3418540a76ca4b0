"""The Borůvka scan round's minimum outgoing edge per row on the card, and
its plain version.

Counterpart of ``_scan_minout`` (``petal_neighbors_tpu/trees/
boruvka.py:330``), which the JAX package leaves to XLA: for each query row
i, over corpus rows j whose label differs (``comp[j] != compq[i]``),

    w(i, j) = max(max(rd(i, j), cq_rd[i]), core_rd[j]),
    rd(i, j) = the sum over features f, in order, of (q[i, f] − x[j, f])²,

``bw[i]`` is the least w and ``bj[i]`` the least j that reaches it;
``(+inf, −1)`` where no j gives a finite w (one component, or +inf cores).
The sum's arithmetic, the kernel's to the bit: in float32 each difference
is rounded, the first square is ``t*t`` and each next step is the fused
``fma(t, t, acc)``, rounded once (``_fma_rn``: the sum in float64, then
float32, with the float64 sum rounded to odd where it fell on a float32
tie); in float64 every difference, square and sum is rounded on its own.
Inputs are finite: the MST raises on NaN points.

``scan_minout`` launches ``csrc/mst_scan.cu`` for CUDA tensors and runs
``scan_minout_reference`` for CPU tensors.  Nothing else selects between
them: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["scan_minout", "scan_minout_reference", "QCHUNK", "NCHUNK"]

#: the JAX package's tile walk (boruvka.py:330-331): query rows and corpus
#: rows per (qchunk x nchunk) tile of the plain version
QCHUNK, NCHUNK = 4096, 16384

#: the kernel's fixed sizes (csrc/mst_scan.cu): query rows per block,
#: corpus rows per stage of the direct kernel (the tile kernel's 64 divide
#: it)
TQ, TN = 64, 256


def _check(pts, core_rd, comp, q, cq_rd, compq) -> None:
    if pts.ndim != 2 or q.ndim != 2 or q.shape[1] != pts.shape[1]:
        raise ValueError(f"scan_minout wants pts (n, d) and q (nq, d), got "
                         f"{tuple(pts.shape)} and {tuple(q.shape)}")
    n, nq = pts.shape[0], q.shape[0]
    if (core_rd.shape != (n,) or comp.shape != (n,)
            or cq_rd.shape != (nq,) or compq.shape != (nq,)):
        raise ValueError("scan_minout wants core_rd, comp (n,) and cq_rd, "
                         "compq (nq,)")
    if pts.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scan_minout takes float32 or float64, got "
                        f"{pts.dtype}")
    for name, t, want in (("core_rd", core_rd, pts.dtype),
                          ("q", q, pts.dtype), ("cq_rd", cq_rd, pts.dtype),
                          ("comp", comp, torch.int32),
                          ("compq", compq, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"scan_minout wants {want} {name}, got {t.dtype}")
        if t.device != pts.device:
            raise ValueError("scan_minout wants all inputs on one device")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan_minout runs on CUDA or CPU, not {pts.device}")
    if n >= 2 ** 31 - TN or nq >= 2 ** 31 - TQ:
        raise ValueError("scan_minout: n and nq must be below 2^31 - 256")


def _rd_unrolled(q, p):
    """(qc, nc) squared Euclidean distances summed over the features in
    order, each term rounded on its own (boruvka.py:287-298)."""
    acc = None
    for dd in range(q.shape[1]):
        t = q[:, dd][:, None] - p[:, dd][None, :]
        acc = t * t if acc is None else acc + t * t
    return acc


def _fma_rn(t, acc):
    """float32 ``fma(t, t, acc)``: the exact ``t*t + acc`` rounded once.

    ``t*t`` of a float32 is exact in float64, so ``s = t*t + acc`` taken
    in float64 is the exact sum rounded once, and rounding ``s`` to
    float32 gives the fused bits unless ``s`` is a float32 tie (halfway
    between two float32 values) that the float64 rounding made: then the
    second rounding may go the wrong way.  Only those elements, which
    ``_ties`` finds (with every ``s`` under 2^-126, whose ties it does not
    test), are rounded to odd: where the TwoSum error of ``s`` is not
    zero, ``s`` steps one float64 bit toward the exact sum, off the tie
    (53 >= 24 + 2 bits).  Any float32 ``t`` and ``acc``, infinities
    included, on any device; the float64 sum is the one full-size
    temporary, since the plain version calls this on its largest tiles."""
    s = t.double()
    s.mul_(s).add_(acc)
    idx = _ties(s).nonzero(as_tuple=True)
    if idx[0].numel():
        p = t[idx].double()
        p.mul_(p)
        a = acc[idx].double()
        st = s[idx]
        z = st - p                   # TwoSum: p + a == st + err, exactly
        err = (p - (st - z)) + (a - z)
        inexact = (err != 0) & torch.isfinite(st)
        above = inexact & (torch.signbit(err) != torch.signbit(st))
        bits = st.view(torch.int64)  # |st| > |exact| above: one step down
        bits.sub_(above.long()).bitwise_or_(inexact.long())
        s[idx] = st
    return s.to(torch.float32)


def _ties(s):
    """Where float64 ``s`` may be a float32 tie: its 29 bits below a
    normal float32's last bit are 1 then 28 zeros, or ``|s| < 2^-126``."""
    tie = s.view(torch.int64).bitwise_and(0x1FFFFFFF) == 0x10000000
    return tie.logical_or_(s.abs() < 2.0 ** -126)


def _rd_fused(q, p):
    """(qc, nc) squared Euclidean distances summed over the features in
    order as the kernel sums them: float32 ``t*t``, then ``fma(t, t,
    acc)`` a feature (``_fma_rn``); float64 as ``_rd_unrolled``."""
    if q.dtype != torch.float32:
        return _rd_unrolled(q, p)
    acc = None
    for dd in range(q.shape[1]):
        t = q[:, dd][:, None] - p[:, dd][None, :]
        acc = t * t if acc is None else _fma_rn(t, acc)
    return acc


def scan_minout_reference(pts, core_rd, comp, q, cq_rd, compq, *,
                          qchunk: int = QCHUNK, nchunk: int = NCHUNK):
    """Plain PyTorch version of ``scan_minout``, over the JAX package's
    (qchunk x nchunk) tiles: within a tile the first least w, across tiles
    a strict ``<``, so the lowest j wins a tie.  A ragged last tile is
    left short instead of padded with +inf columns (the same winners)."""
    _check(pts, core_rd, comp, q, cq_rd, compq)
    n, nq = pts.shape[0], q.shape[0]
    dev, dt = pts.device, pts.dtype
    bw = torch.full((nq,), torch.inf, dtype=dt, device=dev)
    bj = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    for s in range(0, nq, qchunk):
        qq, cq, cmpq = q[s:s + qchunk], cq_rd[s:s + qchunk], \
            compq[s:s + qchunk]
        tw = torch.full((qq.shape[0],), torch.inf, dtype=dt, device=dev)
        tj = torch.full((qq.shape[0],), -1, dtype=torch.int32, device=dev)
        for base in range(0, n, nchunk):
            rd = _rd_fused(qq, pts[base:base + nchunk])
            w = torch.maximum(torch.maximum(rd, cq[:, None]),
                              core_rd[base:base + nchunk][None, :])
            w = torch.where(comp[base:base + nchunk][None, :]
                            == cmpq[:, None], torch.inf, w)
            m, a = torch.min(w, dim=1)
            better = m < tw
            tw = torch.where(better, m, tw)
            tj = torch.where(better, a.to(torch.int32) + base, tj)
        bw[s:s + qchunk], bj[s:s + qchunk] = tw, tj
    return bw, bj


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("mst_scan")
    p = ctypes.POINTER(ctypes.c_int)
    lib.mst_constants.argtypes = [p] * 4
    lib.mst_constants.restype = None
    lib.mst_scan_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mst_scan_launch.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(4)]
    lib.mst_constants(*(ctypes.byref(v) for v in vals))
    if (vals[0].value, vals[1].value) != (TQ, TN):
        raise RuntimeError("csrc/mst_scan.cu disagrees with this module: "
                           f"{[v.value for v in vals]}")
    return lib


def scan_minout(pts, core_rd, comp, q, cq_rd, compq):
    """Per-row minimum outgoing mutual-reachability edge (``_scan_minout``,
    boruvka.py:330), in the rd (squared) domain.

    ``pts`` (n, d), ``core_rd`` (n,) and int32 labels ``comp`` (n,) are
    the corpus; ``q`` (nq, d), ``cq_rd`` (nq,) and ``compq`` (nq,) the
    query rows; float32 or float64 (one type), all on one device.  Returns
    ``(bw (nq,), bj (nq,) int32)``: the least w and the least corpus row
    reaching it, or (+inf, -1).  CUDA tensors launch ``csrc/mst_scan.cu``
    once (counted in ``scan_minout.launches``), ``pts`` copied first where
    it is not contiguous or not 16-byte aligned; CPU tensors run
    ``scan_minout_reference``."""
    _check(pts, core_rd, comp, q, cq_rd, compq)
    if pts.device.type == "cpu":
        return scan_minout_reference(pts, core_rd, comp, q, cq_rd, compq)
    n, d = pts.shape
    nq = q.shape[0]
    bw = torch.empty((nq,), dtype=pts.dtype, device=pts.device)
    bj = torch.empty((nq,), dtype=torch.int32, device=pts.device)
    if nq == 0:
        return bw, bj
    if n == 0:
        return bw.fill_(torch.inf), bj.fill_(-1)
    args = [t.contiguous() for t in (pts, core_rd, comp, q, cq_rd, compq)]
    if args[0].data_ptr() % 16:  # a view: the kernel copies 16-byte planes
        args[0] = args[0].clone()
    with torch.cuda.device(pts.device):
        err = _lib().mst_scan_launch(
            int(pts.dtype == torch.float64),
            *(t.data_ptr() for t in args), bw.data_ptr(), bj.data_ptr(),
            n, nq, d, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mst scan kernel launch failed: cudaError {err}")
    scan_minout.launches += 1
    return bw, bj


#: kernel launches made by the wrapper (plain-version calls do not count)
scan_minout.launches = 0
