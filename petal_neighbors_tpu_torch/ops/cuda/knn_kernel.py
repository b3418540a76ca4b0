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
* ``knn_few``: the exact k smallest u of 1 to a few live queries in one
  pass over the index (no TPU counterpart): fold's path for CUDA tensors
  where ``few_path`` says so.

Two precision tiers.  fold and fold_lazy compute u in FP32 on the SIMT
cores (``_u``).  capped, bcap and merge compute it as the TPU kernels do at
``precision="highest"``, a six-pass bf16 product: each operand element is
split into three bf16 pieces (``split_bf16x3``) and the six products hh,
hm, mh, hl, lh and mm are summed in f32 (``_u_tc``), on the card by the
tensor cores (``csrc/knn_tc.cuh``: asynchronous ``wgmma`` on swizzled piece
planes, split once by ``tc_planes.split_planes`` and brought in by bulk
copies: the points' planes as an index holds them, ``point_planes``, and
the queries' split per call; bcap reduces each 16-row block to its minimum
in the accumulator registers).  ``tc_proof_err`` is that tier's
pointwise error bound, and ``tc_probe`` holds the card's product to it once
per process and device before the first tensor-core launch, raising
``RuntimeError`` on a breach.

fold, capped and bcap launch one template of ``csrc/knn_fold.cu`` (a mode
each), fold_lazy a kernel of its own there on a wider FP32 tile product
(128 queries × 128 rows a block) that sums each pair in fold's order; merge
launches the radix-select passes of
``csrc/knn_select.cu`` and the word sort of ``csrc/row_sort.cu``.  fold
takes one of three paths by shape (``fold_path``): a few queries the
few-query kernel, small batches (the route's repairs) those radix-select
passes on fold's own FP32 product, larger ones the streaming kernel.
The few-query kernel (``csrc/knn_few.cu``) keeps fold's contract: u in
FP32 in fold's order (so fold's bits) and an exact selection; the route
(``ops.bruteforce.knn_prepadded``) sends bcap and capped calls at its
shapes to fold.  Each
wrapper launches its kernels for CUDA tensors and runs its plain PyTorch
version for CPU tensors.  Nothing else selects between them: a CUDA tensor
launches the kernel or raises.

NaN policy is enforced at padding time (``ops.bruteforce.pad_for_pallas``):
NaN rows are zeroed with +inf norms, so their u is +inf and they are never
selected.  A NaN query row keeps its init state (+inf, -1).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...utils.profiling import count
from .tc_planes import check_planes, index_planes, split_planes

__all__ = ["knn_fold", "knn_fold_reference", "knn_fold_lazy",
           "knn_fold_lazy_reference", "knn_capped",
           "knn_capped_reference", "knn_bcap", "knn_bcap_reference",
           "knn_merge", "knn_merge_reference", "kernel_plan", "tc_tile",
           "split_bf16x3", "tc_proof_err", "tc_probe", "check_tc_product",
           "merge_layout", "fold_path", "FOLD_SELECT_Q",
           "knn_few", "knn_few_reference", "few_path", "few_plan",
           "FEW_RULE", "FEW_K_MAX", "FOLD_K_MAX", "MERGE_K_MAX",
           "PASSES_MAX", "BCAP_BLOCK", "TILE_ROWS"]

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

#: rows per tile of selection of the capped and bcap kernels on the card
#: (``csrc/knn_tiles.cuh``'s TN): their ``tile`` is a whole number of these
#: (capped: a multiple of 64 rows; bcap: of 4 blocks)
TILE_ROWS = 64

_MODES = {"fold": 0, "capped": 1, "bcap": 2, "merge": 3, "fold_lazy": 4,
          "fold_select": 5}

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


def _points_planes(points, point_planes, name: str):
    """The points' piece planes for a tensor-core wrapper: ``point_planes``
    checked against the points (``check_planes``), or, where None, split
    here as an index would hold them (``index_planes``: None for a CPU call,
    whose plain version needs none)."""
    if point_planes is not None:
        check_planes(point_planes, points, name)
        return point_planes
    return index_planes(points)


def _u(points, queries, point_norms, s: int, e: int):
    if points.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return point_norms[s:e][None, :] - 2.0 * (queries @ points[s:e].T)


def split_bf16x3(x):
    """(hi, mid, lo) bf16 pieces of float32 ``x``, each rounded to nearest
    and returned as float32: hi = bf16(x), mid = bf16(x − hi), lo =
    bf16(x − hi − mid).  For a normal float32 (exponent >= −110)
    hi + mid + lo == x exactly; both remainders are exact in float32."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _u_tc(points, queries, point_norms, s: int, e: int):
    """u of the tensor-core tier: the six products hh, hm, mh, hl, lh and
    mm of the operands' three bf16 pieces, each an exact-product float32
    matmul, summed in float32 (the card's kernel accumulates them per 16
    features, so the two agree within ``tc_proof_err``, not bit for
    bit)."""
    if points.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    qh, qm, ql = split_bf16x3(queries)
    xh, xm, xl = split_bf16x3(points[s:e])
    dot = (qh @ xh.T + qh @ xm.T + qm @ xh.T + qh @ xl.T + ql @ xh.T
           + qm @ xm.T)
    return point_norms[s:e][None, :] - 2.0 * dot


def tc_proof_err(dim: int, qn, xn_max):
    """Pointwise |computed u − true u| bound of the tensor-core tier
    (capped, bcap, the block minima of bcap2 and the subchunk minima of
    two_phase: the split-bf16 product, ``_u_tc``, ``csrc/knn_tc.cuh``),
    ``(4 + 12·⌈d/16⌉)·2⁻²³·(‖q‖² + max ‖x‖²)``, the bound the route's proof
    uses.  With S = Σ|q_i x_i| ≤ ‖q‖‖x‖ ≤ (‖q‖² + ‖x‖²)/2 and s = 6·⌈d/16⌉
    mma steps:
      * the split: hi + mid + lo == x exactly, |mid| ≤ 2⁻⁸|x|, |lo| ≤
        2⁻¹⁶|x|, so the dropped ml, lm and ll terms sum to at most
        (2·2⁻²⁴ + 2⁻³²)·S ≤ 2⁻²³·S;
      * the accumulation: each of the s mma steps adds 16 exact products
        of bf16 pieces to the f32 accumulator.  Hopper's mma accumulation
        is not specified as IEEE round-to-nearest (earlier tensor cores
        were measured aligning the addends and truncating), so each step
        is taken at 2⁻²² (two units of 2⁻²³) of the magnitudes it adds,
        which never exceed S: at most s·2⁻²²·S;
      * u = ‖x‖² − 2·dot doubles those and rounds once more: 2⁻²⁴·(‖x‖²
        + 2S) ≤ 2⁻²³·(‖q‖² + ‖x‖²).
    Together 2·(2⁻²³ + s·2⁻²²)·S + 2⁻²³·(‖q‖² + ‖x‖²) ≤ (2 + 2s)·2⁻²³·
    (‖q‖² + ‖x‖²) = (2 + 12·⌈d/16⌉)·2⁻²³·(...); the 4 in place of 2 is
    margin.  ``tc_probe`` holds the card's product to this bound, f64
    against f32 on the reference's probe distribution, before the first
    tensor-core launch."""
    return (4.0 + 12.0 * math.ceil(dim / 16)) * 2.0 ** -23 * (qn + xn_max)


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
    """Plain PyTorch version of the merge kernel: the running top-k of the
    fold kernel's plain version, on the tensor-core tier's u (``_u_tc``),
    at k up to ``MERGE_K_MAX``.  Its output is sorted ascending, ties in id
    order, as the kernel's."""
    _check(points, queries, point_norms, k, "knn_merge", MERGE_K_MAX)
    return _running_topk(points, queries, point_norms, k, _u_tc)


def _running_topk(points, queries, point_norms, k: int, u_of=_u):
    best_u, best_i = _exact_topk(
        lambda s, e: u_of(points, queries, point_norms, s, e),
        points.shape[0], queries.shape[0], queries.device, k)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    rd = torch.where(best_i < 0, torch.inf, torch.clamp_min(best_u + qn, 0.0))
    return rd, best_i


def _exact_topk(scores, ncols: int, nq: int, device, k: int,
                chunk: int = 4096):
    """The k smallest of the (Q, ncols) scores ``scores(s, e)`` gives for
    columns [s, e), NaN counted as +inf: a running set before each chunk in
    a stable sort, so that a candidate enters only strictly below the k-th
    kept value, ties inside a chunk go to the smaller column and +inf never
    displaces an empty (+inf, -1) slot.  Returns (u (Q, k) ascending, ids
    (Q, k) int32)."""
    best_u = torch.full((nq, k), torch.inf, dtype=torch.float32,
                        device=device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=device)
    for s in range(0, ncols, chunk):
        u = scores(s, min(s + chunk, ncols))
        u = torch.where(torch.isnan(u), torch.inf, u)
        ids = torch.arange(s, s + u.shape[1], dtype=torch.int32,
                           device=device).expand(nq, -1)
        cat_u = torch.cat([best_u, u], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        best_u, pos = torch.sort(cat_u, dim=1, stable=True)
        best_u = best_u[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    return best_u, best_i


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
    """Plain PyTorch version of the capped kernel (see ``knn_capped``) on
    the tensor-core tier's u (``_u_tc``); ``splits`` reproduces a launch
    plan's row ranges."""
    _check(points, queries, point_norms, k, "knn_capped")
    _check_capped(k, tile, passes, "knn_capped")

    def scores(s, e):
        return _u_tc(points, queries, point_norms, s, e)

    bd, bi, thr = _capped_select(scores, points.shape[0], queries.shape[0],
                                 queries.device, k=k, tile=tile,
                                 passes=passes, splits=splits)
    return _capped_out(queries, bd, bi, thr)


def knn_bcap_reference(points, queries, point_norms, *, k: int, tile: int,
                       passes: int, splits: int = 1):
    """Plain PyTorch version of the bcap kernel (see ``knn_bcap``) on the
    tensor-core tier's u (``_u_tc``); ``tile`` counts blocks, ``splits``
    reproduces a launch plan's row ranges."""
    _check(points, queries, point_norms, k, "knn_bcap")
    _check_capped(k, tile, passes, "knn_bcap")
    bd, bi, thr = _capped_select(
        _block_minima(points, queries, point_norms),
        -(-points.shape[0] // BCAP_BLOCK), queries.shape[0], queries.device,
        k=k, tile=tile, passes=passes, splits=splits)
    return _capped_out(queries, bd, bi, thr)


def _block_minima(points, queries, point_norms):
    """scores(s, e): the minima of the tensor-core tier's u over the blocks
    [s, e) of ``BCAP_BLOCK`` rows, the last block's missing rows +inf;
    ``amin`` propagates NaN, so a NaN query's minima stay NaN."""
    b = BCAP_BLOCK

    def scores(s, e):
        u = _u_tc(points, queries, point_norms, s * b, e * b)
        short = (e - s) * b - u.shape[1]      # the last block's missing rows
        if short:
            u = torch.nn.functional.pad(u, (0, short), value=float("inf"))
        return torch.amin(u.reshape(u.shape[0], e - s, b), dim=2)
    return scores


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("knn_fold")
    p = ctypes.POINTER(ctypes.c_int)
    lib.knn_constants.argtypes = [p] * 6
    lib.knn_constants.restype = None
    lib.knn_tc_constants.argtypes = [p] * 8
    lib.knn_tc_constants.restype = None
    lib.knn_plan.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, p, p]
    lib.knn_plan.restype = ctypes.c_int
    lib.knn_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.knn_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _select_lib():
    from ._build import load

    lib = load("knn_select")
    p = ctypes.POINTER(ctypes.c_int)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "knn_select_constants": [p, p],
        "knn_select_plan": [ll, i, i, p],
        "knn_select_minima_launch": [vp] * 4 + [ll] + [i] * 5 + [vp],
        "knn_select_bound_launch": [vp, i, i, i] + [vp] * 6 + [vp],
        "knn_select_collect_launch": [vp] * 10 + [ll] + [i] * 4 + [vp],
        "knn_select_pick_launch": [vp] * 8 + [i, i, i, vp],
        "knn_select_fp32_plan": [ll, i, i, p],
        "knn_select_fp32_minima_launch": [vp] * 4 + [ll] + [i] * 5 + [vp],
        "knn_select_fp32_collect_launch": [vp] * 10 + [ll] + [i] * 4 + [vp],
        "knn_select_fold_out_launch": [vp] * 3 + [i] * 3 + [vp],
        "knn_tc_u_launch": [vp] * 4 + [ll, i, i, vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None if name == "knn_select_constants" else ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _word_sort_lib():
    from ._build import load

    lib = load("row_sort")
    lib.word_sort_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.word_sort_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _constants() -> dict[str, int]:
    """The kernels' fixed sizes, as the CUDA sources define them."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    _lib().knn_constants(*(ctypes.byref(v) for v in vals))
    out = dict(zip(("tq", "lazy_tq", "tn", "block", "max_passes", "max_k"),
                   (v.value for v in vals)))
    sel = [ctypes.c_int(0) for _ in range(2)]
    _select_lib().knn_select_constants(*(ctypes.byref(v) for v in sel))
    out["bins"], out["max_list"] = (v.value for v in sel)
    # merge_layout's lists reach 2 * MERGE_K_MAX words
    if ((out["tn"], out["block"], out["max_passes"], out["max_k"])
            != (TILE_ROWS, BCAP_BLOCK, PASSES_MAX, FOLD_K_MAX)
            or out["max_list"] < 2 * MERGE_K_MAX):
        raise RuntimeError(f"csrc/knn_fold.cu or csrc/knn_select.cu "
                           f"disagrees with this module: {out}")
    return out


@functools.lru_cache(maxsize=None)
def tc_tile() -> dict[str, int]:
    """The tensor-core product's tile on the card (``csrc/knn_tc.cuh``):
    queries and point rows per tile, features per staged chunk, bf16 pieces
    per element and piece products per pair; the query and point rows of
    one warpgroup's ``wgmma`` (``wg_m``, ``wg_n``) and the plane buffers
    of a streamed operand."""
    vals = [ctypes.c_int(0) for _ in range(8)]
    _lib().knn_tc_constants(*(ctypes.byref(v) for v in vals))
    return dict(zip(("tq", "tn", "dc", "pieces", "products", "wg_m", "wg_n",
                     "bufs"), (v.value for v in vals)))


def _block_queries(scheme: str) -> int:
    """Queries per block of a scheme's kernel on the card: the tensor-core
    tile's for capped and bcap, fold_lazy's wide block's, fold's SIMT
    tile's otherwise (the arrival counters are one per block of
    queries)."""
    if scheme in ("capped", "bcap"):
        return tc_tile()["tq"]
    return _constants()["lazy_tq" if scheme == "fold_lazy" else "tq"]


def _scratch_shapes(scheme: str, nq: int, k: int, splits: int,
                   ws_smem: bool, tq: int):
    """Shapes of a streaming kernel's scratch for a launch plan: the
    working sets (each row range's, or the only one when it is not in
    shared memory), each range's miss (capped and bcap, when split), and
    one zeroed arrival counter per block of ``tq`` queries
    (``_block_queries``)."""
    part = (splits, nq, k) if (splits > 1 or not ws_smem) else (0,)
    miss = (splits, nq) if scheme not in _FOLDS and splits > 1 else (0,)
    return part, miss, (-(-nq // tq),)


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, mode: int, n: int, q: int, d: int, k: int,
          tile_tiles: int) -> tuple[int, bool]:
    splits, ws_smem = ctypes.c_int(1), ctypes.c_int(0)
    if mode == _MODES["merge"]:
        err = _select_lib().knn_select_plan(n, q, d, ctypes.byref(splits))
    elif mode == _MODES["fold_select"]:
        err = _select_lib().knn_select_fp32_plan(n, q, d,
                                                 ctypes.byref(splits))
    else:
        err = _lib().knn_plan(mode, n, q, d, k, tile_tiles,
                              ctypes.byref(splits), ctypes.byref(ws_smem))
    if err != 0:
        raise RuntimeError(f"knn kernel planning failed: cudaError {err}")
    return splits.value, bool(ws_smem.value)


def _tile_tiles(scheme: str, tile: int) -> int:
    """The card's tiles of ``TILE_ROWS`` rows in one capped or bcap tile
    (``tile`` rows, or blocks for bcap); raises ValueError where ``tile``
    is not a whole number of them.  The tensor-core product runs 128-row
    tiles; a range that ends in half of one reads its first 64 rows."""
    if scheme in _FOLDS + ("merge", "fold_select"):
        return 1
    rows = tile * BCAP_BLOCK if scheme == "bcap" else tile
    if rows % TILE_ROWS:
        raise ValueError(f"knn_{scheme}: a tile of {rows} rows is not a "
                         f"multiple of the kernel's {TILE_ROWS}-row tile")
    return rows // TILE_ROWS


def kernel_plan(scheme: str, n: int, q: int, d: int, k: int,
                tile: int = 1) -> tuple[int, bool]:
    """The CUDA kernel's launch plan on the current card: (row-range
    splits, working set in shared memory).  ``tile`` as the scheme's
    wrapper takes it (rows for capped, blocks for bcap).  capped's and
    merge's ranges split the tensor-core product (``tc_tile``);
    "fold_select" is fold's select path (``fold_path``), whose ranges may
    exceed the streaming kernels' 64."""
    return _plan(torch.cuda.current_device(), _MODES[scheme], n, q, d, k,
                 _tile_tiles(scheme, tile))


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


#: the probe's widths and the largest |u − u_f64| / bound seen, per device
_PROBE_DIMS = (128, 960)
_probed: dict[int, float] = {}


def _probe_inputs(d: int):
    """The integrity probe's points and queries at width d: the reference's
    ``standard_normal × exp(uniform(−8, 8))`` (knn_kernel.py:937-938),
    and rows where ‖x‖² is far above q·x (large rows against small
    queries), where the product's cancellation is the bound's whole
    margin."""
    rng = np.random.default_rng(d)
    def draw(rows):
        return (rng.standard_normal((rows, d))
                * np.exp(rng.uniform(-8, 8, (rows, d)))).astype(np.float32)
    pts = np.concatenate([draw(192),
                          (rng.standard_normal((64, d)) * 1e3).astype(
                              np.float32)])
    qs = np.concatenate([draw(48),
                         (rng.standard_normal((16, d)) * 1e-2).astype(
                             np.float32)])
    return pts, qs


def check_tc_product(u_of, device, rows: int = 1,
                     product: str = "tc::scan (capped, merge)") -> float:
    """Push the probe (``_probe_inputs``, d = 128 and 960) through
    ``u_of(points, queries, norms)`` on ``device``: u (Q, N), or with
    ``rows`` > 1 its minima over each block of ``rows`` rows (Q, N / rows).
    Hold every value to ``tc_proof_err`` of its query against the same
    reduction of the f64 u (a minimum moves no further than its inputs).
    Raises ``RuntimeError`` naming ``product`` on a breach; returns the
    largest error over its bound."""
    worst = 0.0
    for d in _PROBE_DIMS:
        pts, qs = _probe_inputs(d)
        p = torch.from_numpy(pts).to(device)
        q = torch.from_numpy(qs).to(device)
        xn = torch.sum(p * p, dim=1)
        u = u_of(p, q, xn)
        u64 = xn.double()[None, :] - 2.0 * (q.double() @ p.double().T)
        if rows > 1:
            u64 = torch.amin(u64.reshape(u64.shape[0], -1, rows), dim=2)
        qn = torch.sum(q * q, dim=1).double()
        bound = tc_proof_err(d, qn, xn.double().max())[:, None]
        ratio = float(((u.double() - u64).abs() / bound).max())
        if not ratio <= 1.0:
            raise RuntimeError(
                f"the tensor-core product breaks its proof bound: |u - "
                f"u_f64| is {ratio:.3g} times tc_proof_err at d={d} in "
                f"{product}; its kernels' results cannot be certified here")
        worst = max(worst, ratio)
    return worst


def tc_probe(device=None) -> float:
    """Hold the card's tensor-core product to ``tc_proof_err`` once per
    process and device, before the first tensor-core launch there.  Both
    of ``csrc/knn_tc.cuh``'s loops are checked: ``tc::scan`` (the capped
    and merge kernels) through ``knn_tc_u_launch``'s u, and
    ``tc::scan_minima`` (the bcap and block-minima kernels) through the
    block-minima kernel's 16-row minima, its query planes resident at
    d = 128 and streamed at d = 960.  Raises ``RuntimeError`` on a breach:
    an unsound bound would certify wrong answers.  Returns the largest
    error over its bound (cached after the first call)."""
    from .minima_kernel import _launch as minima_launch

    def block_minima(p, q, xn):
        return minima_launch("block", p, q, xn, BCAP_BLOCK)

    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = _device_index(dev)
    if idx not in _probed:
        with torch.cuda.device(idx):
            on = torch.device("cuda", idx)
            _probed[idx] = max(
                check_tc_product(_tc_u, on),
                check_tc_product(block_minima, on, BCAP_BLOCK,
                                 "tc::scan_minima (bcap, block minima)"))
    return _probed[idx]


def _tc_u(points, queries, point_norms):
    """u (Q, N) of the tensor-core product on the card (the probe's entry
    point; not a route of the index)."""
    n, d = points.shape
    nq = queries.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=points.device)
    point_planes, query_planes = split_planes(points), split_planes(queries)
    err = _select_lib().knn_tc_u_launch(
        point_planes.data_ptr(), query_planes.data_ptr(),
        point_norms.contiguous().data_ptr(), out.data_ptr(), n, nq, d,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_tc_u kernel launch failed: cudaError {err}")
    return out


def _launch(scheme: str, points, queries, point_norms, k: int, tile: int = 1,
            passes: int = 0, point_planes=None):
    """One launch of ``csrc/knn_fold.cu``'s kernel of ``scheme``; capped
    and bcap read ``point_planes`` (the points' ``split_planes``) and the
    queries' planes, split here."""
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
        part, miss, count = _scratch_shapes(scheme, nq, k, s, ws_smem,
                                            _block_queries(scheme))
        part_d = torch.empty(part, dtype=torch.float32, device=dev)
        part_i = torch.empty(part, dtype=torch.int32, device=dev)
        part_m = torch.empty(miss, dtype=torch.float32, device=dev)
        counters = torch.zeros(count, dtype=torch.int32, device=dev)
        on_tc = scheme not in _FOLDS
        query_planes = split_planes(queries) if on_tc else None
        err = _lib().knn_launch(
            _MODES[scheme], points.data_ptr(), queries.data_ptr(),
            point_norms.data_ptr(),
            point_planes.data_ptr() if on_tc else None,
            query_planes.data_ptr() if on_tc else None,
            out_d.data_ptr(), out_i.data_ptr(),
            out_t.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
            part_m.data_ptr(), counters.data_ptr(), n, nq, d, k, tt, passes,
            s, int(ws_smem), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_{scheme} kernel launch failed: "
                           f"cudaError {err}")
    return out_d, out_i, out_t


#: fold's select path by width and k_scan: {widest d: ((k_scan, fewest
#: queries, most queries or None), ...)}.  A call takes the tier of the
#: narrowest width at or above its d (the widest past them all) and the row
#: of the largest k_scan at or below its k (the first row below them all),
#: and runs the select for fewest <= Q <= most, the streaming kernel
#: otherwise.  Read from chip_smoke.py's table of both paths (phase
#: fold_paths: SIFT 1M x 128 and GIST 1M x 960) on an NVIDIA H100 80GB HBM3
#: at 700 W: the select's two product passes fill the card where the
#: streaming kernel's few query tiles do not, and its cost does not grow
#: with k; the streaming kernel's one pass wins for large batches at small
#: k, and ties it for a few queries at k_scan 18 (the select's device time
#: is lower, its host's launches and one read per pass are not; PERF.md §6).
#: Past the 64 queries measured at d = 960 the streaming kernel stays.
#: ``fold_path`` reads it only outside ``FEW_RULE``: there, at k_scan 128
#: or less, the few-query kernel runs first; the rows still decide past
#: the rule's counts, past k_scan 128 and past its widest width.
FOLD_SELECT_Q = {
    128: ((18, 8, 64), (108, 1, 384), (208, 1, 768), (1008, 1, None)),
    960: ((18, 3, 64), (108, 1, 64), (208, 1, 64), (1008, 1, 64)),
}


def fold_path(q: int, k: int, d: int, n: int) -> str:
    """The path ``knn_fold`` takes on the card for Q queries, k, width d
    and n index rows: "few", the few-query kernel, where ``few_path`` says
    so; else by ``FOLD_SELECT_Q`` "select", the radix select over fold's
    FP32 product (two product passes over row ranges that fill the card),
    or "stream", the streaming kernel (one product pass).  A rule on the
    shape alone; nothing is timed at run time."""
    if not 1 <= k <= FOLD_K_MAX:
        raise ValueError(f"knn_fold takes 1 <= k <= {FOLD_K_MAX}, got {k}")
    if few_path(q, d, k, n):
        return "few"
    tier = min((t for t in FOLD_SELECT_Q if d <= t),
               default=max(FOLD_SELECT_Q))
    rows = FOLD_SELECT_Q[tier]
    _, fewest, most = max((r for r in rows if r[0] <= k), default=rows[0])
    return "select" if fewest <= q and (most is None or q <= most) \
        else "stream"


#: the few-query kernel's largest k (``csrc/knn_few.cu``'s K_MAX)
FEW_K_MAX = 128

#: ``few_path``'s rule: {measured width d: ((largest k, most queries),
#: ...)}.  A row holds for k up to its largest k (the first row at or
#: above k; none past them), and the few-query kernel runs for 1 <= Q <=
#: most queries.  A width between two measured ones takes the smaller
#: count of the two (the kernel's lead over the other paths grows with d,
#: and its shared memory too), a width below them all the narrowest's,
#: and none runs past the widest.  Read from chip_smoke.py's phase
#: few_query on an NVIDIA H100 80GB HBM3 at 700 W: the kernel against
#: fold's select and streaming paths at 1M rows of each width, k_scan 13
#: (d = 8) or 18, 108 and 128, q = 1 to 64; each count is the largest at
#: which the kernel was at least 5% faster than both other paths in every
#: run (one to four runs a point).  Indexes of 10k and 100k rows gave the
#: kernel a wider lead at every count than 1M rows did.
FEW_RULE = {
    2: ((18, 24), (128, 8)),
    8: ((18, 28), (128, 8)),
    32: ((18, 24), (128, 8)),
    64: ((18, 32), (128, 16)),
    128: ((18, 48), (128, 24)),
    256: ((18, 64), (128, 48)),
    512: ((18, 64), (128, 64)),
    960: ((18, 64), (128, 8)),
}


def few_path(q: int, d: int, k: int, n: int) -> bool:
    """Whether ``knn_fold`` takes the few-query kernel on the card for Q
    queries of width d, k and n index rows (``FEW_RULE``; the kernel's ids
    are int32, so n < 2^31): ``fold_path``'s "few", which the route
    (``ops.bruteforce.knn_prepadded``) also reads to send bcap and capped
    calls at these shapes to fold.  A rule on the shape alone; nothing is
    timed at run time.  Outside it fold's other paths run."""
    widths = sorted(FEW_RULE)
    if not (1 <= q and 1 <= k <= FEW_K_MAX and 1 <= n < 2 ** 31
            and 1 <= d <= widths[-1]):
        return False
    near = {max((t for t in widths if t <= d), default=widths[0]),
            min(t for t in widths if t >= d)}
    return q <= min(next((m for kk, m in FEW_RULE[t] if k <= kk), 0)
                    for t in near)


def knn_few_reference(points, queries, point_norms, *, k: int):
    """Plain PyTorch version of the few-query kernel: the exact k smallest
    FP32 u (``_u``) per query, NaN counted as +inf, ties to the smaller id
    (fold's plain version at k <= ``FEW_K_MAX``).  Returns (rdist (Q, k),
    ids (Q, k)): rdist is u + ‖q‖² clamped at 0, (+inf, -1) in empty slots;
    rows ascending."""
    _check(points, queries, point_norms, k, "knn_few", FEW_K_MAX)
    return _running_topk(points, queries, point_norms, k)


@functools.lru_cache(maxsize=None)
def _few_lib():
    from ._build import load

    lib = load("knn_few")
    p = ctypes.POINTER(ctypes.c_int)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.few_k_max.argtypes = []
    lib.few_k_max.restype = ctypes.c_int
    lib.few_plan.argtypes = [ll, i, i, i, p, p, p]
    lib.few_plan.restype = ctypes.c_int
    lib.few_launch.argtypes = [vp] * 7 + [ll, i, i, i, i, vp]
    lib.few_launch.restype = ctypes.c_int
    if lib.few_k_max() != FEW_K_MAX:
        raise RuntimeError(f"csrc/knn_few.cu's K_MAX {lib.few_k_max()} "
                           f"disagrees with FEW_K_MAX {FEW_K_MAX}")
    return lib


@functools.lru_cache(maxsize=256)
def _few_plan(device_index: int, n: int, q: int, d: int,
              k: int) -> dict[str, int]:
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = _few_lib().few_plan(n, q, d, k, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"knn_few planning failed at n={n}, q={q}, d={d}, "
                           f"k={k}: cudaError {err}")
    return dict(zip(("tile_rows", "splits", "smem"), (v.value for v in vals)))


def few_plan(n: int, q: int, d: int, k: int) -> dict[str, int]:
    """The few-query kernel's launch plan on the current card: rows a
    tile, row ranges (splits) and the scan block's shared memory bytes."""
    return _few_plan(torch.cuda.current_device(), n, q, d, k)


def knn_few(points, queries, point_norms, *, k: int):
    """The exact k smallest u of 1 to a few live queries in one pass over
    the index (``csrc/knn_few.cu``; no TPU kernel: it serves the shapes
    where the wide-tile kernels had one live query in 128 or 64).

    Inputs as ``knn_fold``, ``1 <= k <= FEW_K_MAX``; fold's contract
    (``knn_few_reference``): u is FP32, each pair summed in fold's order,
    so the rdist are the streaming fold kernel's bits.  Queries run in
    groups of up to 16, one pass over the index each.  CUDA tensors launch
    the scan and its merge (counted in ``knn_few.launches`` and, by
    queries, in the profiling counter ``knn.few_queries``); CPU tensors run
    ``knn_few_reference``.  Returns (rdist (Q, k), ids (Q, k)), rows in no
    promised order; at a tie on the k-th value any of the tied ids may be
    kept."""
    _check(points, queries, point_norms, k, "knn_few", FEW_K_MAX)
    if points.device.type == "cpu":
        return knn_few_reference(points, queries, point_norms, k=k)
    return _few(points, queries, point_norms, k)


def _few(points, queries, point_norms, k: int):
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError("knn_few ids are int32: N and Q must be < 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    point_norms = point_norms.contiguous()
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        splits = _few_plan(_device_index(dev), n, nq, d, k)["splits"]
        part_u = torch.empty((splits, nq, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
        err = _few_lib().few_launch(
            points.data_ptr(), queries.data_ptr(), point_norms.data_ptr(),
            part_u.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), n, nq, d, k, splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_few kernel launch failed: cudaError {err}")
    knn_few.launches += 1
    count("knn.few_queries", nq)
    return out_d, out_i


def knn_fold(points, queries, point_norms, *, k: int,
             path: str | None = None):
    """Exact top-k of u over padded points (the fold contract,
    knn_kernel.py:969-991).

    ``points`` (N, d), ``point_norms`` (N,) as made by ``pad_for_pallas``
    (NaN and padding rows zeroed with +inf norms); ``queries`` (Q, d);
    all float32 on one device; ``1 <= k <= 1024``.  Returns
    ``(rdist (Q, k) float32, ids (Q, k) int32)``, rows in no promised
    order: rdist is ``u + ‖q‖²`` clamped at 0; empty slots and NaN query
    rows are (+inf, -1); ids of +inf-norm rows never appear.

    CUDA tensors take one of three paths by shape (``fold_path``): the
    few-query kernel (``knn_few``), the streaming kernel of
    ``csrc/knn_fold.cu`` or the radix select of ``csrc/knn_select.cu``
    over the same FP32 u (rows sorted); ``path`` ("few", "select" or
    "stream") forces one, for measurement.  All give the same u and rdist
    bits; at a tie at the k-th value they may keep different ids.
    ``knn_fold.launches`` counts one per call on the select or stream path
    (the few path counts in ``knn_few.launches``),
    ``knn_fold.last_path`` names the path of the last call and
    ``knn_fold.last_passes`` holds the select's collect passes per chunk of
    queries (empty for the others).  CPU tensors run
    ``knn_fold_reference``.
    """
    _check(points, queries, point_norms, k, "knn_fold")
    if path not in (None, "few", "select", "stream"):
        raise ValueError(f"knn_fold path is 'few', 'select' or 'stream', "
                         f"got {path!r}")
    if points.device.type == "cpu":
        return knn_fold_reference(points, queries, point_norms, k=k)
    if path is None:
        path = fold_path(queries.shape[0], k, points.shape[1],
                         points.shape[0])
    passes = []
    if path == "few":
        out_d, out_i = _few(points, queries, point_norms, k)
    elif path == "select":
        out_d, out_i, passes = _fold_select(points, queries, point_norms, k)
    else:
        out_d, out_i, _ = _launch("fold", points, queries, point_norms, k)
    if path != "few":
        knn_fold.launches += 1
    knn_fold.last_path = path
    knn_fold.last_passes = passes
    return out_d, out_i


def _fold_select(points, queries, point_norms, k: int):
    """fold's select path on the card: the radix-select passes on the FP32
    product, then rdist by ``knn_select_fold_out_launch`` (‖q‖² summed as
    the streaming kernel sums it).  Returns (rdist, ids, passes)."""
    queries = queries.contiguous()
    u, ids, passes = _select(points, queries, point_norms, k, "fp32")
    if u.shape[0]:
        with torch.cuda.device(u.device):
            err = _select_lib().knn_select_fold_out_launch(
                queries.data_ptr(), u.data_ptr(), ids.data_ptr(), u.shape[0],
                queries.shape[1], k, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"knn_fold rdist launch failed: cudaError "
                               f"{err}")
    return u, ids, passes


def knn_fold_lazy(points, queries, point_norms, *, k: int):
    """The fold contract with the lazy kernel (``_knn_kernel_lazy``,
    knn_kernel.py:116, ``knn_pallas(scheme="fold_lazy")``): a tile whose
    scores all miss their queries' working-set maxima costs one warp vote
    and no per-candidate work.  Inputs, ``1 <= k <= 1024`` and outputs as
    ``knn_fold``, whose rdist it gives bit for bit (its ids may differ only
    at a tie on a row's largest rdist, as between fold's two paths).

    CUDA tensors launch ``csrc/knn_fold.cu``'s ``MODE_FOLD_LAZY``, its own
    kernel on the wide FP32 product of ``csrc/knn_tiles.cuh`` (counted
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
               passes: int, point_planes=None):
    """Capped-pass streaming top-k (``_knn_kernel_capped``,
    knn_kernel.py:429): each tile of ``tile`` rows folds at most
    ``passes`` of its candidates into the working set, so true top-k
    members may be skipped; ``thr`` lower-bounds every point outside the
    set.  u is the tensor-core tier's (``_u_tc``; ``tc_probe`` runs before
    the first launch on a device).

    Inputs as ``knn_fold``; ``k <= tile`` (the first tile seeds the set),
    ``0 <= passes <= 15``; on the card ``tile`` is a multiple of 64 rows.
    Returns ``(rdist (Q, k), ids (Q, k), thr (Q,))``, unsorted, thr in the
    rdist domain (NaN for a NaN query).  Seed slots of +inf-norm rows may
    hold (+inf, id).  CUDA tensors launch ``csrc/knn_fold.cu`` at every
    query count (counted in ``knn_capped.launches``) on the points' piece
    planes, ``point_planes`` (``split_planes(points)``, as an index holds
    them; split here when None), and the queries', split here; CPU tensors
    run ``knn_capped_reference``.
    """
    _check(points, queries, point_norms, k, "knn_capped")
    _check_capped(k, tile, passes, "knn_capped")
    point_planes = _points_planes(points, point_planes, "knn_capped")
    if points.device.type == "cpu":
        return knn_capped_reference(points, queries, point_norms, k=k,
                                    tile=tile, passes=passes)
    tc_probe(points.device)
    out = _launch("capped", points, queries, point_norms, k, tile, passes,
                  point_planes)
    knn_capped.launches += 1
    return out


def knn_bcap(points, queries, point_norms, *, k: int, tile: int,
             passes: int, point_planes=None):
    """Block-capped streaming top-k (``_knn_kernel_bcap``,
    knn_kernel.py:546): the capped scheme over the minima of u over blocks
    of ``BCAP_BLOCK`` = 16 contiguous rows (block id b = rows [16b,
    16b + 16)), ``tile`` blocks per tile, ``k`` block ids kept.

    u is the tensor-core tier's (``_u_tc``), as capped's.  The TPU kernel
    streams block-interleaved planes so that its block minima are
    lane-wise minima; here the product reduces each 16-row block in the
    mma registers (``csrc/knn_tc.cuh``'s ``scan_minima``, bit for bit
    ``bcap_minima``'s), so the kernel reads the padded points' planes as
    they are;
    ``tc_probe`` runs before the first launch on a device.  Inputs as
    ``knn_fold``; ``k <= tile``, ``0 <= passes <= 15``; on the card
    ``tile`` is a multiple of 4 blocks (``TILE_ROWS`` rows; ValueError
    otherwise).  Returns ``(block-min rdist (Q, k), block ids (Q, k), thr
    (Q,))`` as ``knn_capped``.  CUDA tensors launch ``csrc/knn_fold.cu`` at
    every query count (counted in ``knn_bcap.launches``) on the piece
    planes, ``point_planes`` as ``knn_capped`` takes them; CPU tensors run
    ``knn_bcap_reference``.
    """
    _check(points, queries, point_norms, k, "knn_bcap")
    _check_capped(k, tile, passes, "knn_bcap")
    point_planes = _points_planes(points, point_planes, "knn_bcap")
    if points.device.type == "cpu":
        return knn_bcap_reference(points, queries, point_norms, k=k,
                                  tile=tile, passes=passes)
    _tile_tiles("bcap", tile)
    tc_probe(points.device)
    out = _launch("bcap", points, queries, point_norms, k, tile, passes,
                  point_planes)
    knn_bcap.launches += 1
    return out


def merge_layout(n: int, k: int, tier: str = "tc") -> tuple[int, int]:
    """(glog, width) of the radix-select passes over n rows: groups of
    2^glog rows, the largest of 128, 64, 32 and 16 that still makes at
    least 1.5 k groups (16 where none does), and lists of width
    ``min(8192, k + max(k, 1024))``.  On the FP32 product (``tier``
    "fp32", fold's select path) a group stays inside one 64-row tile, so
    the largest is 64."""
    glog = 4
    for g in ((7, 6, 5) if tier == "tc" else (6, 5)):
        if -(-n // (1 << g)) >= 1.5 * k:
            glog = g
            break
    return glog, min(8192, k + max(k, 1024))


#: collect passes after which the select has ended on every query: the
#: bound's interval spans at most 2^64 words, each pass cuts it by 2^8
#: and a one-word interval is done on the next
_MAX_COLLECT_PASSES = 9

#: scratch bytes (group minima and lists) a merge launch keeps per chunk
#: of queries
_MERGE_SCRATCH_BYTES = 512 << 20


def _merge_chunk(points, queries, point_norms, k: int, splits: int,
                 glog: int, width: int, tier: str = "tc",
                 point_planes=None):
    """The radix-select passes (``csrc/knn_select.cu``) on the product of
    ``tier`` ("tc": merge's, on ``point_planes`` and the chunk's query
    planes, split here; "fp32": fold's) and the word sort on one chunk of
    queries.  Returns (u (Q, k), ids (Q, k), collect passes)."""
    lib = _select_lib()
    name = "knn_merge" if tier == "tc" else "knn_fold"
    minima_launch, collect_launch = (
        (lib.knn_select_minima_launch, lib.knn_select_collect_launch)
        if tier == "tc" else (lib.knn_select_fp32_minima_launch,
                              lib.knn_select_fp32_collect_launch))
    n, d = points.shape
    nq = queries.shape[0]
    dev = queries.device
    stream = torch.cuda.current_stream().cuda_stream
    groups = -(-n // (1 << glog))
    minima = torch.empty((nq, groups), dtype=torch.int64, device=dev)
    lo = torch.empty((nq,), dtype=torch.int64, device=dev)
    hi = torch.empty_like(lo)
    shift, below, done, cnt = (torch.empty((nq,), dtype=torch.int32,
                                           device=dev) for _ in range(4))
    hist = torch.zeros((nq, _constants()["bins"]), dtype=torch.int32,
                       device=dev)
    words = torch.empty((nq, width), dtype=torch.int64, device=dev)
    flags = torch.zeros((2,), dtype=torch.int32, device=dev)
    if tier == "tc":
        query_planes = split_planes(queries)
        ptr = (point_planes.data_ptr(), query_planes.data_ptr(),
               point_norms.data_ptr())
    else:
        ptr = (points.data_ptr(), queries.data_ptr(), point_norms.data_ptr())

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{name} {what} launch failed: "
                               f"cudaError {err}")

    check(minima_launch(*ptr, minima.data_ptr(), n, nq, d, groups, glog,
                        splits, stream), "minima")
    check(lib.knn_select_bound_launch(
        minima.data_ptr(), nq, groups, k, lo.data_ptr(), hi.data_ptr(),
        shift.data_ptr(), below.data_ptr(), done.data_ptr(), cnt.data_ptr(),
        stream), "bound")
    del minima
    passes = 0
    while True:
        check(collect_launch(
            *ptr, lo.data_ptr(), hi.data_ptr(), shift.data_ptr(),
            done.data_ptr(), hist.data_ptr(), cnt.data_ptr(),
            words.data_ptr(), n, nq, d, width, splits, stream), "collect")
        flags[0] = 0
        check(lib.knn_select_pick_launch(
            hist.data_ptr(), cnt.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            shift.data_ptr(), below.data_ptr(), done.data_ptr(),
            flags.data_ptr(), nq, k, width, stream), "pick")
        passes += 1
        still_open, longest = flags.tolist()
        if not still_open:
            break
        if passes > _MAX_COLLECT_PASSES:
            raise RuntimeError(f"{name}: the radix select did not end "
                               f"within {_MAX_COLLECT_PASSES} passes")
    sort_w = max(k, longest)
    out_u = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    check(_word_sort_lib().word_sort_launch(
        words.data_ptr(), cnt.data_ptr(), width, out_u.data_ptr(),
        out_i.data_ptr(), nq, sort_w, k, stream), "word sort")
    return out_u, out_i, passes


def _select(points, queries, point_norms, k: int, tier: str,
            point_planes=None):
    """The radix select of ``csrc/knn_select.cu`` on the product of
    ``tier`` over chunks of queries (each chunk's scratch within
    ``_MERGE_SCRATCH_BYTES``), each chunk with its own launch plan; the
    tensor-core tier reads ``point_planes`` and each chunk's query planes.
    Returns (u (Q, k) ascending, ids (Q, k), collect passes per chunk)."""
    name = "knn_merge" if tier == "tc" else "knn_fold"
    n, d = points.shape
    nq = queries.shape[0]
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError(f"{name} ids are int32: N and Q must be < 2^31")
    points = points.contiguous()
    queries = queries.contiguous()
    point_norms = point_norms.contiguous()
    dev = queries.device
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev), [])
    glog, width = merge_layout(n, k, tier)
    per_q = 8 * (-(-n // (1 << glog)) + width)
    step = max(64, _MERGE_SCRATCH_BYTES // per_q // 64 * 64)
    mode = _MODES["merge" if tier == "tc" else "fold_select"]
    us, ids, passes = [], [], []
    with torch.cuda.device(dev):
        for s in range(0, nq, step):
            qc = queries[s:s + step]
            splits, _ = _plan(_device_index(dev), mode, n, qc.shape[0], d, k,
                              1)
            u, i, p = _merge_chunk(points, qc, point_norms, k, splits, glog,
                                   width, tier, point_planes)
            us.append(u)
            ids.append(i)
            passes.append(p)
    return (torch.cat(us) if len(us) > 1 else us[0],
            torch.cat(ids) if len(ids) > 1 else ids[0], passes)


def knn_merge(points, queries, point_norms, *, k: int, point_planes=None):
    """Exact streaming top-k of u for ``1 <= k <= 4096``, sorted
    (``_knn_kernel_merge``, knn_kernel.py:336, as ``knn_pallas(scheme=
    "merge")`` serves it), on the tensor-core tier's u (``_u_tc``).

    Inputs as ``knn_fold``.  Returns ``(rdist (Q, k) float32 ascending,
    ids (Q, k) int32)``: rdist is ``u + ‖q‖²`` clamped at 0, ties in id
    order; empty slots and NaN query rows are (+inf, -1); ids of +inf-norm
    rows never appear.  CUDA tensors launch ``csrc/knn_select.cu``'s radix
    select (group minima, bound, collect and pick passes) and
    ``csrc/row_sort.cu``'s word sort, after ``tc_probe`` (counted once per
    call in ``knn_merge.launches``; ``knn_merge.last_passes`` holds the
    collect passes of each chunk of queries of the last call), on the
    piece planes, ``point_planes`` as ``knn_capped`` takes them; CPU
    tensors run ``knn_merge_reference``.  Either way the call's queries
    count in the profiling counter ``knn.merge_queries``.
    """
    _check(points, queries, point_norms, k, "knn_merge", MERGE_K_MAX)
    point_planes = _points_planes(points, point_planes, "knn_merge")
    count("knn.merge_queries", queries.shape[0])
    if points.device.type == "cpu":
        return knn_merge_reference(points, queries, point_norms, k=k)
    if queries.shape[0]:
        tc_probe(queries.device)
    u, i, passes = _select(points, queries, point_norms, k, "tc",
                           point_planes)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    rd = torch.where(i < 0, torch.inf, torch.clamp_min(u + qn, 0.0))
    knn_merge.launches += 1
    knn_merge.last_passes = passes
    return rd, i


#: kernel launches made by each wrapper (plain-version calls do not count)
knn_merge.launches = 0
knn_merge.last_passes = []
knn_fold.launches = 0
knn_fold.last_path = None
knn_fold.last_passes = []
knn_fold_lazy.launches = 0
knn_capped.launches = 0
knn_bcap.launches = 0
knn_few.launches = 0
