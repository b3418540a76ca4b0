"""Row-block minima of the u-domain score on the card: the kernels of the
opt-in "two_phase" and "bcap2" schemes and their plain versions.

Counterpart of ``subchunk_minima`` and ``bcap_minima`` in
``petal_neighbors_tpu/ops/pallas/knn_kernel.py``.  For each query q and
each block of ``rows`` contiguous point rows,

    out[q, c] = min over rows [rows*c, rows*c + rows) of u = ‖x‖² − 2·q·x,

* ``subchunk_minima``: 128-row subchunks (``_minima_kernel``), the
  candidate phase of two_phase;
* ``bcap_minima``: 16-row blocks (``_bcap_minima_kernel``), the candidate
  phase of bcap2, the same product and block minima as the bcap kernel's,
  bit for bit.  The TPU kernel reads block-interleaved planes so that a
  block minimum is a lane-wise minimum; here the product reduces each
  block in the mma registers, so the kernel reads the padded points' piece
  planes (``split_planes``) as they are.

Both compute u on the tensor-core tier (``_u_tc``, the TPU kernels'
``precision="highest"``), on one product loop: a subchunk is one 128-row
tile of it, and its minimum is the minimum of the tile's eight block
minima, so ``subchunk_minima``'s columns are the minima of
``bcap_minima``'s over each 8, bit for bit.  ``tc_probe`` runs before the
first launch of either on a device.

Rows past N count as +inf, so a ragged last block is the minimum of its
real rows.  NaN and padding rows carry +inf norms (``pad_for_pallas``), so
their u is +inf for a finite query; a NaN query scores NaN everywhere and
its minima are NaN (the minimum propagates NaN, as ``jnp.min`` does).

Each launches a hand-written CUDA kernel of ``csrc/knn_minima.cu`` for CUDA
tensors and runs its plain PyTorch version for CPU tensors.  Nothing else
selects between them: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .knn_kernel import (BCAP_BLOCK, _points_planes, _u_tc, check_arrays,
                         tc_probe)
from .tc_planes import split_planes

__all__ = ["subchunk_minima", "subchunk_minima_reference", "bcap_minima",
           "bcap_minima_reference", "minima_plan", "SUBCHUNK"]

#: rows per two_phase subchunk (knn_kernel.py:801); bcap2's blocks are the
#: bcap kernel's BCAP_BLOCK = 16 rows
SUBCHUNK = 128

_MODES = {"subchunk": 0, "block": 1}


def _minima_reference(points, queries, point_norms, rows: int):
    """Chunked u of the tensor-core tier (``_u_tc``), then ``amin`` over
    each block of ``rows`` rows; the last block padded with +inf.  ``amin``
    propagates NaN.  Both minima take u in the same chunks, so they see
    the same u bits."""
    n = points.shape[0]
    nq = queries.shape[0]
    ncols = -(-n // rows)
    out = torch.empty((nq, ncols), dtype=torch.float32, device=queries.device)
    chunk = 32768   # whole blocks of 16 and subchunks of 128 alike
    for s in range(0, n, chunk):
        u = _u_tc(points, queries, point_norms, s, s + chunk)
        cols = -(-u.shape[1] // rows)
        short = cols * rows - u.shape[1]
        if short:
            u = torch.nn.functional.pad(u, (0, short), value=float("inf"))
        out[:, s // rows:s // rows + cols] = torch.amin(
            u.reshape(nq, cols, rows), dim=2)
    return out


def subchunk_minima_reference(points, queries, point_norms):
    """Plain PyTorch version of ``subchunk_minima``, on the tensor-core
    tier's u (``_u_tc``)."""
    check_arrays(points, queries, point_norms, "subchunk_minima")
    return _minima_reference(points, queries, point_norms, SUBCHUNK)


def bcap_minima_reference(points, queries, point_norms):
    """Plain PyTorch version of ``bcap_minima``, on the tensor-core tier's
    u (``_u_tc``)."""
    check_arrays(points, queries, point_norms, "bcap_minima")
    return _minima_reference(points, queries, point_norms, BCAP_BLOCK)


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("knn_minima")
    p = ctypes.POINTER(ctypes.c_int)
    lib.minima_constants.argtypes = [p] * 4
    lib.minima_constants.restype = None
    lib.minima_plan.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, p]
    lib.minima_plan.restype = ctypes.c_int
    lib.minima_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.minima_launch.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(4)]
    lib.minima_constants(*(ctypes.byref(v) for v in vals))
    if (vals[2].value, vals[3].value) != (SUBCHUNK, BCAP_BLOCK):
        raise RuntimeError("csrc/knn_minima.cu disagrees with this module: "
                           f"{[v.value for v in vals]}")
    return lib


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, mode: int, n: int, q: int, d: int) -> int:
    splits = ctypes.c_int(1)
    err = _lib().minima_plan(mode, n, q, d, ctypes.byref(splits))
    if err != 0:
        raise RuntimeError(f"minima kernel planning failed: cudaError {err}")
    return splits.value


def minima_plan(kind: str, n: int, q: int, d: int) -> int:
    """The CUDA kernel's row-range splits on the current card; ``kind`` is
    "subchunk" or "block"."""
    return _plan(torch.cuda.current_device(), _MODES[kind], n, q, d)


def _launch(kind: str, points, queries, point_norms, rows: int,
            point_planes=None):
    """One launch of ``csrc/knn_minima.cu`` on the points' piece planes
    (split here when None) and the queries', split here."""
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError(f"{kind} minima: N and Q must be < 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    point_norms = point_norms.contiguous()
    dev = queries.device
    out = torch.empty((nq, -(-n // rows)), dtype=torch.float32, device=dev)
    if nq == 0:
        return out
    with torch.cuda.device(dev):
        s = _plan(dev.index if dev.index is not None
                  else torch.cuda.current_device(), _MODES[kind], n, nq, d)
        if point_planes is None:
            point_planes = split_planes(points)
        query_planes = split_planes(queries)
        err = _lib().minima_launch(
            _MODES[kind], point_planes.data_ptr(), query_planes.data_ptr(),
            point_norms.data_ptr(), out.data_ptr(), n, nq, d, s,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} minima kernel launch failed: "
                           f"cudaError {err}")
    return out


def subchunk_minima(points, queries, point_norms, *, point_planes=None):
    """Per-subchunk u-domain minima (``_minima_kernel``, knn_kernel.py:804):
    ``(Q, ceil(N / 128))`` float32, column c the minimum of u over rows
    [128c, 128c + 128), on the tensor-core tier (``_u_tc``; ``tc_probe``
    runs before the first launch on a device).

    ``points`` (N, d), ``point_norms`` (N,) as made by ``pad_for_pallas``;
    ``queries`` (Q, d); all float32 on one device; ``point_planes`` the
    points' piece planes (``split_planes(points)``, as an index holds them;
    split here when None).  CUDA tensors launch ``csrc/knn_minima.cu``
    (counted in ``subchunk_minima.launches``); CPU tensors run
    ``subchunk_minima_reference``.
    """
    check_arrays(points, queries, point_norms, "subchunk_minima")
    point_planes = _points_planes(points, point_planes, "subchunk_minima")
    if points.device.type == "cpu":
        return subchunk_minima_reference(points, queries, point_norms)
    tc_probe(points.device)
    out = _launch("subchunk", points, queries, point_norms, SUBCHUNK,
                  point_planes)
    subchunk_minima.launches += 1
    return out


def bcap_minima(points, queries, point_norms, *, point_planes=None):
    """Per-block u-domain minima (``_bcap_minima_kernel``,
    knn_kernel.py:706): ``(Q, ceil(N / 16))`` float32, column b the minimum
    of u over rows [16b, 16b + 16), the bcap kernel's block ids, on the
    tensor-core tier (``_u_tc``; ``tc_probe`` runs before the first launch
    on a device).

    Inputs as ``subchunk_minima``.  CUDA tensors launch
    ``csrc/knn_minima.cu`` (counted in ``bcap_minima.launches``); CPU
    tensors run ``bcap_minima_reference``.
    """
    check_arrays(points, queries, point_norms, "bcap_minima")
    point_planes = _points_planes(points, point_planes, "bcap_minima")
    if points.device.type == "cpu":
        return bcap_minima_reference(points, queries, point_norms)
    tc_probe(points.device)
    out = _launch("block", points, queries, point_norms, BCAP_BLOCK,
                  point_planes)
    bcap_minima.launches += 1
    return out


#: kernel launches made by each wrapper (plain-version calls do not count)
subchunk_minima.launches = 0
bcap_minima.launches = 0
