"""The direct-form rescore: ``rescore_rd`` and its plain version.

Every route that ranks candidates by a product-form score rescores them in
the direct form, ``Σ (q_i − x_i)²``, exact to rounding (``ops/topk.py``
``rescore_exact``, ``ops/bruteforce.py`` ``_rescore_large`` and
``_block_rd``).  ``rescore_rd(points, queries, ids, block=B, norms=...)``
gives that rdist for every candidate row, (Q, W·B), in candidate order: id
``b`` of ``ids`` (Q, W) stands for rows [b·B, b·B + B) (B = 1: the id is
the row).  A candidate is +inf where its id is negative, its row lies at
or past ``points.shape[0]``, ``norms`` are given and its norm is not
finite (the padding and NaN rows that ``pad_for_pallas`` zeroes), or its
sum is NaN.

CUDA tensors launch ``csrc/rescore.cu``, one kernel that reads each
candidate row once and sums it in registers (counted in
``rescore_rd.launches`` and, pair by pair, in the profiling counter
``rescore.pairs``); CPU tensors run ``rescore_rd_reference``, the gather,
difference, square and ``torch.sum`` over query chunks.  Nothing else
selects between them: a CUDA tensor launches the kernel or raises.  The
kernel's sums are in another order than ``torch.sum``'s; its rounding
bound is ``rescore_rounding``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import count

__all__ = ["rescore_rd", "rescore_rd_reference", "rescore_plan",
           "rescore_rounding"]

#: threads a block (one query and a tile of its candidates)
THREADS = 256

#: rows a lane group keeps in flight
UNROLL = 4

#: most passes of a block over its rows, and the blocks a streaming
#: multiprocessor should get before a block takes more than one pass
_MAX_PASSES = 8
_BLOCKS_PER_SM = 16

#: the plain version's chunk: about 256 MB of float32 gathered rows
_PLAIN_ELEMS = 1 << 26


def _lanes(d: int, itemsize: int, vec: bool) -> int:
    """Lanes a row: the largest power of two up to 32 that leaves each lane
    at least one piece (16 bytes with ``vec``, else one element)."""
    pieces = d * itemsize // 16 if vec else d
    return 1 << min(5, max(pieces, 1).bit_length() - 1)


def rescore_plan(q: int, rows: int, d: int, itemsize: int, vec: bool,
                 sms: int) -> tuple[int, int, int]:
    """The kernel's launch for ``q`` queries of ``rows`` candidates each:
    (lanes a row, rows a block, blocks a query).  A block passes over
    THREADS / lanes · UNROLL rows at a time; it takes more than one pass
    (up to ``_MAX_PASSES``, the passes shared evenly between a query's
    blocks) only where the launch still gives every streaming
    multiprocessor ``_BLOCKS_PER_SM`` blocks."""
    lanes = _lanes(d, itemsize, vec)
    step = THREADS // lanes * UNROLL
    passes = -(-rows // step)
    per_block = max(1, min(_MAX_PASSES, q * passes // (_BLOCKS_PER_SM * sms)))
    tiles = -(-passes // per_block)
    return lanes, -(-passes // tiles) * step, tiles


def rescore_rounding(d: int, dtype, vec: bool) -> float:
    """The kernel's bound on a result's relative error against the exact
    sum of its rounded differences' squares: (t + log2 lanes) units of
    the type's unit roundoff, t the terms one lane sums."""
    itemsize = torch.finfo(dtype).bits // 8
    lanes = _lanes(d, itemsize, vec)
    per_piece = 16 // itemsize if vec else 1
    terms = per_piece * -(-(d // per_piece) // lanes)
    return (terms + lanes.bit_length() - 1) * torch.finfo(dtype).eps / 2


def rescore_rd_reference(points, queries, ids, *, block: int = 1,
                         norms=None):
    """Plain PyTorch version of ``rescore_rd`` (module docstring): the
    rows gathered, differenced, squared and summed over the last axis by
    ``torch.sum``, over query chunks of about ``_PLAIN_ELEMS`` gathered
    elements."""
    q, width = ids.shape
    n, dim = points.shape
    off = torch.arange(block, dtype=ids.dtype, device=ids.device)
    rows = (ids[:, :, None] * block + off).reshape(q, width * block)
    ok = (ids >= 0).repeat_interleave(block, dim=1) & (rows < n)
    safe = torch.where(ok, rows, 0).long()
    if norms is not None:
        ok &= torch.isfinite(norms[safe])
    rd = torch.empty((q, width * block),
                     dtype=torch.promote_types(points.dtype, queries.dtype),
                     device=points.device)
    step = max(1, _PLAIN_ELEMS // max(1, width * block * dim))
    for s in range(0, q, step):
        diff = queries[s:s + step, None, :] - points[safe[s:s + step]]
        rd[s:s + step] = torch.sum(diff * diff, dim=-1)
    rd = torch.where(torch.isnan(rd), torch.inf, rd)
    return torch.where(ok, rd, torch.inf)


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("rescore")
    p = ctypes.POINTER(ctypes.c_int)
    lib.rescore_constants.argtypes = [p, p]
    lib.rescore_constants.restype = None
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rescore_launch.argtypes = [i, i, i, vp, ll, i, vp, vp, ll, i, i, vp,
                                   vp, i, i, i, i, vp]
    lib.rescore_launch.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(2)]
    lib.rescore_constants(*(ctypes.byref(v) for v in vals))
    if (vals[0].value, vals[1].value) != (THREADS, UNROLL):
        raise RuntimeError("csrc/rescore.cu disagrees with this module: "
                           f"{[v.value for v in vals]}")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rescore_rd(points, queries, ids, *, block: int = 1, norms=None):
    """The direct-form rdist (Q, W·block) of the candidate rows of ``ids``
    (Q, W) against ``queries`` (Q, d) over ``points`` (n, d), in the
    promoted type of the two (module docstring).  CUDA tensors launch
    ``csrc/rescore.cu``; CPU tensors run ``rescore_rd_reference``."""
    if (points.ndim != 2 or queries.ndim != 2 or ids.ndim != 2
            or queries.shape[1] != points.shape[1]
            or ids.shape[0] != queries.shape[0] or block < 1):
        raise ValueError(
            f"rescore_rd wants points (n, d), queries (Q, d), ids (Q, W) and "
            f"block >= 1, got {tuple(points.shape)}, {tuple(queries.shape)}, "
            f"{tuple(ids.shape)}, block {block}")
    if points.device.type == "cpu":
        return rescore_rd_reference(points, queries, ids, block=block,
                                    norms=norms)
    # the plain version's arithmetic: queries and points in their promoted
    # type (an exact upcast of the narrower)
    dtype = torch.promote_types(points.dtype, queries.dtype)
    if (dtype not in (torch.float32, torch.float64)
            or ids.dtype not in (torch.int32, torch.int64)
            or (norms is not None and norms.shape != points.shape[:1])
            or any(t is not None and t.device != points.device
                   for t in (queries, ids, norms))):
        raise ValueError(
            "rescore_rd wants float32 or float64 points and queries, int32 "
            "or int64 ids and (n,) norms, on one device; got "
            f"{points.dtype}, {queries.dtype}, {ids.dtype}, "
            f"{None if norms is None else tuple(norms.shape)}")
    (q, width), (n, d) = ids.shape, points.shape
    out = torch.empty((q, width * block), dtype=dtype, device=points.device)
    if out.numel() == 0:
        return out
    points = points.to(dtype).contiguous()
    queries = queries.to(dtype).contiguous()
    if ids.stride(1) != 1:
        ids = ids.contiguous()
    if norms is not None and norms.dtype != dtype:
        # only their finiteness is read: keep it through the cast
        norms = torch.where(torch.isfinite(norms), 0.0, torch.inf).to(dtype)
    if norms is not None:
        norms = norms.contiguous()
    itemsize = points.element_size()
    vec = d * itemsize % 16 == 0 and points.data_ptr() % 16 == 0
    dev = points.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    lanes, tile_rows, tiles = rescore_plan(q, width * block, d, itemsize,
                                           vec, _sms(dev))
    with torch.cuda.device(points.device):
        err = _lib().rescore_launch(
            int(itemsize == 8), int(ids.dtype == torch.int64), int(vec),
            points.data_ptr(), n, d, queries.data_ptr(), ids.data_ptr(),
            ids.stride(0), width, block,
            None if norms is None else norms.data_ptr(), out.data_ptr(), q,
            lanes, tile_rows, tiles, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rescore kernel launch failed: cudaError {err}")
    rescore_rd.launches += 1
    count("rescore.pairs", q * width * block)
    return out


#: kernel launches (plain-version calls do not count)
rescore_rd.launches = 0
