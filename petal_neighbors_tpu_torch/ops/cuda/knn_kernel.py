"""Fused k-NN on the card: the fold, fold_lazy, capped, bcap and merge
kernels and their plain versions.

Counterpart of ``petal_neighbors_tpu/ops/pallas/knn_kernel.py``.  The
u-domain score ``u = ‖x‖² − 2·q·x`` is the squared distance minus the
per-query ``‖q‖²``, which is constant along a row, so every comparison is
order-identical in u; ``‖q‖²`` is added back once at the output.

* ``knn_fold``: the exact k smallest u per query (``_knn_kernel``).
* ``knn_fold_lazy``: fold's results bit for bit, with one fused test per
  tile before any per-candidate work (``_knn_kernel_lazy``, the opt-in
  "fold_lazy" scheme).
* ``knn_capped``: at most ``passes`` extractions per tile of rows, and a
  per-query threshold ``thr`` that lower-bounds every point left out
  (``_knn_kernel_capped``).  Misses are possible; the caller proves.
* ``knn_bcap``: the capped scheme over the minima of blocks of
  ``BCAP_BLOCK`` contiguous rows; returns block ids (``_knn_kernel_bcap``).
* ``knn_merge``: the exact k smallest u per query for k up to 4096,
  sorted (``_knn_kernel_merge`` + ``_bitonic_merge_sorted``).

Each launches a hand-written CUDA kernel of ``csrc/knn_fold.cu`` (one
template with a mode each for the first four, a kernel of its own on the
same tile product for merge) for CUDA tensors and runs its plain PyTorch
version for CPU tensors.  Nothing else selects between them: a CUDA tensor
launches the kernel or raises.

NaN policy is enforced at padding time (``ops.bruteforce.pad_for_pallas``):
NaN rows are zeroed with +inf norms, so their u is +inf and they are never
selected.  A NaN query row keeps its init state (+inf, -1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["knn_fold", "knn_fold_reference", "knn_fold_lazy",
           "knn_fold_lazy_reference", "knn_capped",
           "knn_capped_reference", "knn_bcap", "knn_bcap_reference",
           "knn_merge", "knn_merge_reference", "kernel_plan", "FOLD_K_MAX",
           "MERGE_K_MAX", "PASSES_MAX", "BCAP_BLOCK"]

#: largest working set the kernels take (knn_kernel.py:1011-1012)
FOLD_K_MAX = 1024

#: largest working set of the merge kernel (knn_kernel.py:1011-1012)
MERGE_K_MAX = 4096

#: largest ``passes`` of the capped and bcap kernels: the sorted list of a
#: tile's passes + 1 smallest candidates spans one half-warp
PASSES_MAX = 15

#: rows per bcap block: its ids map to rows [id*16, id*16 + 16), the
#: granule of 2048 rows over 128 lanes of the TPU kernel (bcap_tile_n)
BCAP_BLOCK = 16

_MODES = {"fold": 0, "capped": 1, "bcap": 2, "merge": 3, "fold_lazy": 4}

#: the schemes that keep the exact top k (no seed, no threshold)
_FOLDS = ("fold", "fold_lazy")


def _check(points, queries, point_norms, k: int, name: str,
           k_max: int = FOLD_K_MAX) -> None:
    if not 1 <= k <= k_max:
        raise ValueError(f"{name} takes 1 <= k <= {k_max}, got {k}")
    check_arrays(points, queries, point_norms, name)


def check_arrays(points, queries, point_norms, name: str) -> None:
    """The u-domain kernels' inputs: points (N, d) with N >= 1, queries
    (Q, d), point_norms (N,), all float32 on one CUDA or CPU device."""
    if points.ndim != 2 or queries.ndim != 2 or point_norms.ndim != 1:
        raise ValueError(f"{name} wants points (N, d), queries (Q, d) and "
                         "point_norms (N,)")
    n, d = points.shape
    if queries.shape[1] != d or point_norms.shape[0] != n or n == 0:
        raise ValueError(
            f"shape mismatch: points {tuple(points.shape)}, queries "
            f"{tuple(queries.shape)}, norms {tuple(point_norms.shape)}")
    for what, t in (("points", points), ("queries", queries),
                    ("point_norms", point_norms)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} wants float32 {what}, got {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} wants all inputs on one device")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU, not {points.device}")


def _check_capped(k: int, tile: int, passes: int, name: str) -> None:
    if tile < k:
        raise ValueError(f"{name}: the first tile seeds the working set, so "
                         f"k={k} must not exceed tile={tile}")
    if not 0 <= passes <= PASSES_MAX:
        raise ValueError(f"{name} takes 0 <= passes <= {PASSES_MAX}, got "
                         f"{passes}")


def _u(points, queries, point_norms, s: int, e: int):
    if points.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return point_norms[s:e][None, :] - 2.0 * (queries @ points[s:e].T)


def knn_fold_reference(points, queries, point_norms, *, k: int):
    """Plain PyTorch version of the fold kernel: a chunked
    ``u = xn − 2·q·xᵀ`` with a running top-k.

    The running set goes before each chunk's candidates in a stable sort,
    so a candidate enters only if it is strictly below the k-th kept value
    (the kernel's ``u < tau``), ties inside a chunk go to the smaller id,
    and +inf never displaces an empty (+inf, -1) slot.  NaN scores count
    as +inf.  Returns (rdist (Q, k) float32, ids (Q, k) int32), ascending.
    """
    _check(points, queries, point_norms, k, "knn_fold")
    return _running_topk(points, queries, point_norms, k)


def knn_fold_lazy_reference(points, queries, point_norms, *, k: int):
    """Plain PyTorch version of the fold_lazy kernel: its results are the
    fold kernel's, so it is fold's plain version (``knn_fold_reference``)."""
    _check(points, queries, point_norms, k, "knn_fold_lazy")
    return _running_topk(points, queries, point_norms, k)


def knn_merge_reference(points, queries, point_norms, *, k: int):
    """Plain PyTorch version of the merge kernel: the fold kernel's plain
    version (the same exact top-k) at k up to ``MERGE_K_MAX``.  Its output
    is sorted ascending, ties in id order, as the kernel's."""
    _check(points, queries, point_norms, k, "knn_merge", MERGE_K_MAX)
    return _running_topk(points, queries, point_norms, k)


def _running_topk(points, queries, point_norms, k: int):
    nq = queries.shape[0]
    best_u = torch.full((nq, k), torch.inf, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    chunk = 4096
    for s in range(0, points.shape[0], chunk):
        u = _u(points, queries, point_norms, s, s + chunk)
        u = torch.where(torch.isnan(u), torch.inf, u)
        ids = torch.arange(s, s + u.shape[1], dtype=torch.int32,
                           device=queries.device).expand(nq, -1)
        cat_u = torch.cat([best_u, u], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        best_u, pos = torch.sort(cat_u, dim=1, stable=True)
        best_u = best_u[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    rd = torch.where(best_i < 0, torch.inf, torch.clamp_min(best_u + qn, 0.0))
    return rd, best_i


def _capped_select(scores, ncols: int, nq: int, device, *, k: int,
                   tile: int, passes: int, splits: int):
    """The capped scheme over ``ncols`` candidate columns, as the TPU
    kernels run it tile by tile (knn_kernel.py:429-527).  ``scores(s, e)``
    gives the (Q, e - s) u of columns [s, e), NaN for NaN queries.

    The columns split into ``splits`` ranges of whole tiles, as the CUDA
    kernel's launch plan splits them; each range seeds its working set
    with its first k columns ((+inf, -1) for a NaN query), then folds the
    ``passes`` smallest remaining candidates of each tile (ties to the
    smaller column) while each is below the set's maximum (ties to the
    smaller slot); miss is the least (passes+1)-th candidate of a tile.
    The ranges' sets merge into their k smallest.  Returns (u (Q, k),
    ids (Q, k), thr_u (Q,)) with thr_u = min(max u, miss)."""
    units = -(-ncols // tile)
    per = -(-units // splits) * tile
    rows = torch.arange(nq, device=device)
    sets, misses = [], []
    for r in range(splits):
        c_begin = min(ncols, r * per)
        c_end = min(ncols, c_begin + per)
        bd = torch.full((nq, k), torch.inf, dtype=torch.float32,
                        device=device)
        bi = torch.full((nq, k), -1, dtype=torch.int32, device=device)
        miss = torch.full((nq,), torch.inf, dtype=torch.float32,
                          device=device)
        for c0 in range(c_begin, c_end, tile):
            c1 = min(c0 + tile, c_end)
            u = scores(c0, c1)
            nan = torch.isnan(u)
            rem = torch.where(nan, torch.inf, u)
            ids = torch.arange(c0, c1, dtype=torch.int32, device=device)
            if c0 == c_begin:
                ns = min(k, c1 - c0)
                bd[:, :ns] = rem[:, :ns]
                bi[:, :ns] = torch.where(nan[:, :ns], -1, ids[:ns])
                rem[:, :ns] = torch.inf
            for _ in range(passes):
                m, am = torch.min(rem, dim=1)
                rem[rows, am] = torch.inf
                cur_max, amax = torch.max(bd, dim=1)
                take = m < cur_max
                bd[rows[take], amax[take]] = m[take]
                bi[rows[take], amax[take]] = ids[am[take]]
            miss = torch.minimum(miss, torch.min(rem, dim=1).values)
        sets.append((bd, bi))
        misses.append(miss)
    if splits > 1:
        bd, pos = torch.sort(torch.cat([s[0] for s in sets], dim=1), dim=1,
                             stable=True)
        bd = bd[:, :k]
        bi = torch.gather(torch.cat([s[1] for s in sets], dim=1), 1,
                          pos[:, :k])
    miss = torch.stack(misses).min(dim=0).values
    thr = torch.minimum(torch.max(bd, dim=1).values, miss)
    return bd, bi, thr


def _capped_out(queries, bd, bi, thr):
    qn = torch.sum(queries * queries, dim=1)
    rd = torch.where(bi < 0, torch.inf,
                     torch.clamp_min(bd + qn[:, None], 0.0))
    return rd, bi, thr + qn


def knn_capped_reference(points, queries, point_norms, *, k: int, tile: int,
                         passes: int, splits: int = 1):
    """Plain PyTorch version of the capped kernel (see ``knn_capped``);
    ``splits`` reproduces a launch plan's row ranges."""
    _check(points, queries, point_norms, k, "knn_capped")
    _check_capped(k, tile, passes, "knn_capped")

    def scores(s, e):
        return _u(points, queries, point_norms, s, e)

    bd, bi, thr = _capped_select(scores, points.shape[0], queries.shape[0],
                                 queries.device, k=k, tile=tile,
                                 passes=passes, splits=splits)
    return _capped_out(queries, bd, bi, thr)


def knn_bcap_reference(points, queries, point_norms, *, k: int, tile: int,
                       passes: int, splits: int = 1):
    """Plain PyTorch version of the bcap kernel (see ``knn_bcap``);
    ``tile`` counts blocks, ``splits`` reproduces a launch plan's row
    ranges."""
    _check(points, queries, point_norms, k, "knn_bcap")
    _check_capped(k, tile, passes, "knn_bcap")
    n = points.shape[0]
    b = BCAP_BLOCK

    def scores(s, e):
        u = _u(points, queries, point_norms, s * b, e * b)
        short = (e - s) * b - u.shape[1]      # the last block's missing rows
        if short:
            u = torch.nn.functional.pad(u, (0, short), value=float("inf"))
        # amin propagates NaN: a NaN query's minima stay NaN
        return torch.amin(u.reshape(u.shape[0], e - s, b), dim=2)

    bd, bi, thr = _capped_select(scores, -(-n // b), queries.shape[0],
                                 queries.device, k=k, tile=tile,
                                 passes=passes, splits=splits)
    return _capped_out(queries, bd, bi, thr)


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("knn_fold")
    p = ctypes.POINTER(ctypes.c_int)
    lib.knn_constants.argtypes = [p] * 6
    lib.knn_constants.restype = None
    lib.knn_plan.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, p, p]
    lib.knn_plan.restype = ctypes.c_int
    lib.knn_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_merge_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.knn_merge_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _constants() -> dict[str, int]:
    """The kernels' fixed sizes, as the CUDA source defines them."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    _lib().knn_constants(*(ctypes.byref(v) for v in vals))
    out = dict(zip(("tq", "tn", "block", "max_passes", "max_k",
                    "merge_max_k"), (v.value for v in vals)))
    if (out["block"], out["max_passes"], out["max_k"],
            out["merge_max_k"]) != (BCAP_BLOCK, PASSES_MAX, FOLD_K_MAX,
                                    MERGE_K_MAX):
        raise RuntimeError(f"csrc/knn_fold.cu disagrees with this module: "
                           f"{out}")
    return out


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, mode: int, n: int, q: int, d: int, k: int,
          tile_tiles: int) -> tuple[int, bool]:
    splits, ws_smem = ctypes.c_int(1), ctypes.c_int(0)
    err = _lib().knn_plan(mode, n, q, d, k, tile_tiles, ctypes.byref(splits),
                          ctypes.byref(ws_smem))
    if err != 0:
        raise RuntimeError(f"knn kernel planning failed: cudaError {err}")
    return splits.value, bool(ws_smem.value)


def _tile_tiles(scheme: str, tile: int) -> int:
    if scheme in _FOLDS + ("merge",):
        return 1
    rows = tile * BCAP_BLOCK if scheme == "bcap" else tile
    tn = _constants()["tn"]
    if rows % tn:
        raise ValueError(f"knn_{scheme}: a tile of {rows} rows is not a "
                         f"multiple of the kernel's {tn}-row tile")
    return rows // tn


def kernel_plan(scheme: str, n: int, q: int, d: int, k: int,
                tile: int = 1) -> tuple[int, bool]:
    """The CUDA kernel's launch plan on the current card: (row-range
    splits, working set in shared memory).  ``tile`` as the scheme's
    wrapper takes it (rows for capped, blocks for bcap)."""
    return _plan(torch.cuda.current_device(), _MODES[scheme], n, q, d, k,
                 _tile_tiles(scheme, tile))


def _launch(scheme: str, points, queries, point_norms, k: int, tile: int = 1,
            passes: int = 0):
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError(f"knn_{scheme} ids are int32: N and Q must be "
                         "< 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    point_norms = point_norms.contiguous()
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    out_t = torch.empty((0 if scheme in _FOLDS else nq,),
                        dtype=torch.float32, device=dev)
    if nq == 0:
        return out_d, out_i, out_t
    with torch.cuda.device(dev):
        tt = _tile_tiles(scheme, tile)
        s, ws_smem = _plan(dev.index if dev.index is not None
                           else torch.cuda.current_device(),
                           _MODES[scheme], n, nq, d, k, tt)
        # scratch: the working sets (each range's, or the only one when
        # it is not in shared memory), each range's miss, and one zeroed
        # arrival counter per query tile
        part = (s, nq, k) if (s > 1 or not ws_smem) else (0,)
        part_d = torch.empty(part, dtype=torch.float32, device=dev)
        part_i = torch.empty(part, dtype=torch.int32, device=dev)
        part_m = torch.empty((s, nq) if scheme not in _FOLDS and s > 1
                             else (0,), dtype=torch.float32, device=dev)
        counters = torch.zeros((-(-nq // _constants()["tq"]),),
                               dtype=torch.int32, device=dev)
        err = _lib().knn_launch(
            _MODES[scheme], points.data_ptr(), queries.data_ptr(),
            point_norms.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            out_t.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
            part_m.data_ptr(), counters.data_ptr(), n, nq, d, k, tt, passes,
            s, int(ws_smem), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_{scheme} kernel launch failed: "
                           f"cudaError {err}")
    return out_d, out_i, out_t


def knn_fold(points, queries, point_norms, *, k: int):
    """Exact streaming top-k of u over padded points (the fold contract,
    knn_kernel.py:969-991).

    ``points`` (N, d), ``point_norms`` (N,) as made by ``pad_for_pallas``
    (NaN and padding rows zeroed with +inf norms); ``queries`` (Q, d);
    all float32 on one device; ``1 <= k <= 1024``.  Returns
    ``(rdist (Q, k) float32, ids (Q, k) int32)``, rows in no promised
    order: rdist is ``u + ‖q‖²`` clamped at 0; empty slots and NaN query
    rows are (+inf, -1); ids of +inf-norm rows never appear.

    CUDA tensors launch ``csrc/knn_fold.cu`` (counted in
    ``knn_fold.launches``); CPU tensors run ``knn_fold_reference``.
    """
    _check(points, queries, point_norms, k, "knn_fold")
    if points.device.type == "cpu":
        return knn_fold_reference(points, queries, point_norms, k=k)
    out_d, out_i, _ = _launch("fold", points, queries, point_norms, k)
    knn_fold.launches += 1
    return out_d, out_i


def knn_fold_lazy(points, queries, point_norms, *, k: int):
    """The fold contract with the lazy kernel (``_knn_kernel_lazy``,
    knn_kernel.py:116, ``knn_pallas(scheme="fold_lazy")``): a tile whose
    scores all miss their queries' working-set maxima costs one warp vote
    and no per-candidate work.  Inputs, ``1 <= k <= 1024`` and outputs as
    ``knn_fold``, with which its results agree bit for bit.

    CUDA tensors launch ``csrc/knn_fold.cu``'s ``MODE_FOLD_LAZY`` (counted
    in ``knn_fold_lazy.launches``); CPU tensors run
    ``knn_fold_lazy_reference``.
    """
    _check(points, queries, point_norms, k, "knn_fold_lazy")
    if points.device.type == "cpu":
        return knn_fold_lazy_reference(points, queries, point_norms, k=k)
    out_d, out_i, _ = _launch("fold_lazy", points, queries, point_norms, k)
    knn_fold_lazy.launches += 1
    return out_d, out_i


def knn_capped(points, queries, point_norms, *, k: int, tile: int,
               passes: int):
    """Capped-pass streaming top-k (``_knn_kernel_capped``,
    knn_kernel.py:429): each tile of ``tile`` rows folds at most
    ``passes`` of its candidates into the working set, so true top-k
    members may be skipped; ``thr`` lower-bounds every point outside the
    set.

    Inputs as ``knn_fold``; ``k <= tile`` (the first tile seeds the set),
    ``0 <= passes <= 15``; on the card ``tile`` is a multiple of 64 rows.
    Returns ``(rdist (Q, k), ids (Q, k), thr (Q,))``, unsorted, thr in the
    rdist domain (NaN for a NaN query).  Seed slots of +inf-norm rows may
    hold (+inf, id).  CUDA tensors launch ``csrc/knn_fold.cu`` (counted in
    ``knn_capped.launches``); CPU tensors run ``knn_capped_reference``.
    """
    _check(points, queries, point_norms, k, "knn_capped")
    _check_capped(k, tile, passes, "knn_capped")
    if points.device.type == "cpu":
        return knn_capped_reference(points, queries, point_norms, k=k,
                                    tile=tile, passes=passes)
    out = _launch("capped", points, queries, point_norms, k, tile, passes)
    knn_capped.launches += 1
    return out


def knn_bcap(points, queries, point_norms, *, k: int, tile: int,
             passes: int):
    """Block-capped streaming top-k (``_knn_kernel_bcap``,
    knn_kernel.py:546): the capped scheme over the minima of u over blocks
    of ``BCAP_BLOCK`` = 16 contiguous rows (block id b = rows [16b,
    16b + 16)), ``tile`` blocks per tile, ``k`` block ids kept.

    The TPU kernel streams block-interleaved planes so that its block
    minima are lane-wise minima; here a block is slot i of a half-warp's
    16 lanes, so the kernel reads the padded points as they are.  Inputs
    as ``knn_fold``; ``k <= tile``, ``0 <= passes <= 15``; on the card
    ``tile`` is a multiple of 4 blocks.  Returns ``(block-min rdist (Q, k),
    block ids (Q, k), thr (Q,))`` as ``knn_capped``.  CUDA tensors launch
    ``csrc/knn_fold.cu`` (counted in ``knn_bcap.launches``); CPU tensors
    run ``knn_bcap_reference``.
    """
    _check(points, queries, point_norms, k, "knn_bcap")
    _check_capped(k, tile, passes, "knn_bcap")
    if points.device.type == "cpu":
        return knn_bcap_reference(points, queries, point_norms, k=k,
                                  tile=tile, passes=passes)
    out = _launch("bcap", points, queries, point_norms, k, tile, passes)
    knn_bcap.launches += 1
    return out


def knn_merge(points, queries, point_norms, *, k: int):
    """Exact streaming top-k of u for ``1 <= k <= 4096``, sorted
    (``_knn_kernel_merge``, knn_kernel.py:336, as ``knn_pallas(scheme=
    "merge")`` serves it).

    Inputs as ``knn_fold``.  Returns ``(rdist (Q, k) float32 ascending,
    ids (Q, k) int32)``: rdist is ``u + ‖q‖²`` clamped at 0; empty slots
    and NaN query rows are (+inf, -1); ids of +inf-norm rows never
    appear.  CUDA tensors launch ``csrc/knn_fold.cu``'s merge kernel
    (counted in ``knn_merge.launches``); CPU tensors run
    ``knn_merge_reference``.
    """
    _check(points, queries, point_norms, k, "knn_merge", MERGE_K_MAX)
    if points.device.type == "cpu":
        return knn_merge_reference(points, queries, point_norms, k=k)
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError("knn_merge ids are int32: N and Q must be < 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    point_norms = point_norms.contiguous()
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        s, _ = _plan(dev.index if dev.index is not None
                     else torch.cuda.current_device(), _MODES["merge"], n,
                     nq, d, k, 1)
        # scratch: each range's sorted working set, two slots that take
        # turns; each range's fill and slot; the ranges' shared bound per
        # query (all ones: none yet); one arrival counter per query tile
        part_d = torch.empty((s, nq, 2, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((s, nq, 2, k), dtype=torch.int32, device=dev)
        part_f = torch.empty((s, nq), dtype=torch.int32, device=dev)
        bound = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        counters = torch.zeros((-(-nq // _constants()["tq"]),),
                               dtype=torch.int32, device=dev)
        err = _lib().knn_merge_launch(
            points.data_ptr(), queries.data_ptr(), point_norms.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), part_f.data_ptr(), bound.data_ptr(),
            counters.data_ptr(), n, nq,
            d, k, s, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_merge kernel launch failed: cudaError {err}")
    knn_merge.launches += 1
    return out_d, out_i


#: kernel launches made by each wrapper (plain-version calls do not count)
knn_merge.launches = 0
knn_fold.launches = 0
knn_fold_lazy.launches = 0
knn_capped.launches = 0
knn_bcap.launches = 0
