"""Exact brute-force k-NN — the flat index's slice of the port.

Counterpart of ``petal_neighbors_tpu/ops/bruteforce.py``, reduced to what
the exact flat index needs:

* the build: ``center_of``, ``pad_for_pallas``, ``prepare_euclidean_index``,
  ``prepare_cosine_index`` (L2-normalized rows: cosine through the
  Euclidean kernels) and ``prepare_lp_index``;
* the kernel route ``knn_prepadded`` (``ops/bruteforce.py:577-1009`` at
  FP32): the bcap, capped, fold or merge kernel over the padded index at
  ``k_scan = k + RESCORE_SLACK``, a direct-form rescore (re-ranked by the
  row-sort kernels from ``k_scan >= 512``, ``_rescore_large``), and for
  bcap and capped the per-batch proof with the compacted repair on the
  fold or merge kernel (on the card, at the shapes where fold runs the
  few-query kernel, bcap and capped take the fold route instead); it
  serves ``k <= PALLAS_K_MAX = 4088``.  The
  opt-in schemes, which ``pick_scheme`` never takes: fold_lazy (the lazy
  fold kernel), two_phase (subchunk minima, a whole-batch proof and
  fallback) and bcap2 (block minima, the bcap proof and repair);
* the Lp route ``lp_knn_prepadded`` (``:1024-1048``): the Lp kernel's
  direct power sums are final, converted by the metric;
* ``knn`` with the JAX signature: it centres high-dim Euclidean input
  unless told it is centred, and takes the kernel route (``backend=
  "pallas"``, or "auto" on the card) or the streamed scan ``_knn_impl``
  (``backend="xla"``: the JAX package's XLA path, which serves f64
  indexes, SqEuclidean, Haversine, low dimensions and k beyond the
  kernels);
* the radius family (``ops/bruteforce.py:1163-1548``): ``radius_mask``
  (the direct form, or for f32 Euclidean at d > 32 and n >= 4096 the
  matmul form with a rescored boundary band), ``radius_counts``,
  ``radius_counts_streaming``, ``radius_capped``, ``distances_at`` and
  ``compact_mask``.  The compactions keep ascending id order by a
  ``cumsum`` position and a scatter into a buffer one column wider than
  the cap, whose last column takes the dropped entries.

Euclidean distance evaluation is a tiled ``‖q‖² + ‖x‖² − 2 q·xᵀ`` product
on centered data (or the direct form at d <= 32), streamed over point
chunks with a running top-k so the (Q, N) distance matrix never
materializes.
"""

from __future__ import annotations

import math
import warnings

import torch

from ..distance import DIRECT_DIM_MAX, Cosine, Euclidean, Metric, _cross
from ..utils.profiling import count, span
from .cuda.knn_kernel import (BCAP_BLOCK, FOLD_K_MAX, MERGE_K_MAX,
                              PASSES_MAX, fold_path, knn_bcap, knn_capped,
                              knn_fold, knn_fold_lazy, knn_merge,
                              tc_proof_err)
from .cuda.lp_kernel import lp_knn, pad_for_lp
from .cuda.minima_kernel import SUBCHUNK, bcap_minima, subchunk_minima
from .cuda.rank_sort_kernel import rank_sort_pairs
from .cuda.rescore_kernel import rescore_rd
from .cuda.sort_kernel import bitonic_sort_pairs
from .cuda.tc_planes import index_planes
from .topk import (merge_topk, monotone_distances, nan_to_inf, rescore_exact,
                   smallest_k)

__all__ = ["knn", "knn_prepadded", "center_of", "pad_for_pallas",
           "prepare_euclidean_index", "prepare_cosine_index",
           "prepare_lp_index", "lp_knn_prepadded", "pick_scheme",
           "with_bcap_planes", "capped_passes", "scan_width",
           "radius_mask", "radius_counts", "radius_counts_streaming",
           "radius_capped", "distances_at", "compact_mask",
           "RESCORE_SLACK", "PAD_ROWS", "PALLAS_K_MAX",
           "SPLIT_BUDGET_ELEMS"]

RESCORE_SLACK = 8

#: largest k the kernel route serves (ops/bruteforce.py:517): merge keeps
#: a working set of up to 4096
PALLAS_K_MAX = MERGE_K_MAX - RESCORE_SLACK

#: index pad granule: a multiple of the bcap block, so the rescore reads
#: whole blocks (the kernels themselves take any row count)
PAD_ROWS = 64

#: corpus size from which the proof-gated schemes serve (the JAX package's
#: cutover, ops/bruteforce.py:639-654)
CAPPED_MIN_N = 262144

#: the JAX index builds its split planes, and with them the bcap planes,
#: only up to this many elements (trees/bruteforce.py:29, :108-113)
SPLIT_BUDGET_ELEMS = 512 * (1 << 20)

#: capped tile in rows (the JAX package's tile at d <= 256, pallas_tile_n)
CAPPED_TILE = 4096

#: capped serves k_scan beyond 128 where n >= CAPPED_N_PER_K * k_scan
#: (ops/bruteforce.py:655-656)
CAPPED_N_PER_K = 200

#: widest candidate row the bitonic re-rank takes; wider rows go to the
#: counting-rank sort (ops/bruteforce.py:568)
BITONIC_WIDTH_MAX = 2048

#: bcap tile in blocks: 2048 rows, the JAX package's bcap_tile_n
BCAP_TILE = 128

#: entries past the exact k-th cutoff that the large-k bcap compaction
#: absorbs before a row must repair (ops/bruteforce.py:418-420)
BCAP_TIE_MARGIN = 64

#: float32 +inf as int32: rdist >= 0, so its int32 bits keep its order
_INF_BITS = 0x7F800000

#: whether the most recent two_phase call fell back to the fold route for
#: its whole batch (some query's proof failed)
last_two_phase_fallback = False

#: per-query counts of the pairs the most recent band-form
#: ``radius_mask`` call found ambiguous (int64, (Q,)); more than its cap
#: in some row sent the call to the direct form
last_band_ambiguous: torch.Tensor | None = None


def center_of(points: torch.Tensor) -> torch.Tensor:
    """Dataset mean for centering (NaN rows ignored; all-NaN columns -> 0).

    Euclidean distances are translation-invariant, but the
    ‖q‖²+‖x‖²−2qx matmul form is not *numerically*: its absolute error
    scales with eps*(‖q‖²+‖x‖²), so un-centered data silently destroys the
    candidate set.  Centering once at index build shrinks the norms to
    data-variance scale and restores exactness."""
    return torch.nan_to_num(torch.nanmean(points, dim=0))


def pad_for_pallas(points: torch.Tensor, point_norms=None, *,
                   tn: int | None = None, bad=None):
    """Sanitize and pad points (and norms) for the kernels, once at index
    build.

    Rows containing any NaN are zeroed and their norms pinned to +inf,
    making their u-scores +inf (never selected — the NaN-is-farthest
    contract); padding rows up to a multiple of ``tn`` (default
    ``PAD_ROWS``) get the same treatment.  Returns (points, norms)."""
    n = points.shape[0]
    if tn is None:
        tn = PAD_ROWS
    if bad is None:
        bad = torch.isnan(points).any(dim=-1)
    points = torch.where(bad[:, None], 0.0, points)
    if point_norms is None:
        point_norms = torch.sum(points * points, dim=-1)
    point_norms = torch.where(bad, torch.inf, point_norms)
    npad = (-n) % tn
    if npad:
        points = torch.nn.functional.pad(points, (0, 0, 0, npad))
        point_norms = torch.nn.functional.pad(point_norms, (0, npad),
                                              value=float("inf"))
    return points, point_norms


def prepare_euclidean_index(points: torch.Tensor, tn: int | None = None):
    """Every index-resident array of the Euclidean kernel route: the
    center ``mu``, the kernel-padded centered points ``ppad`` and their
    norms ``pnorm``, and the NaN-row mask ``bad``.  Only derived arrays
    are kept: callers slice ``ppad[:n]`` when the scan needs the points."""
    mu = center_of(points)
    bad = torch.isnan(points).any(dim=-1)
    ppad, pnorm = pad_for_pallas(points - mu, tn=tn, bad=bad)
    return mu, ppad, pnorm, bad


def prepare_cosine_index(points: torch.Tensor, tn: int | None = None):
    """The index-resident arrays for serving cosine through the Euclidean
    kernels (ops/bruteforce.py:102-121): on L2-normalized rows
    ``1 − q̂·x̂ = ‖q̂ − x̂‖²/2`` exactly, so the route (candidates, proof,
    direct-form rescore) applies with a final ``rd/2``.  Zero-norm rows
    normalize to NaN (0/0) and join the NaN rows: zeroed, +inf norms,
    never selected.  No centering (unit rows are already at data scale).
    Returns (ppad, pnorm, bad)."""
    norms = torch.sqrt(torch.sum(points * points, dim=-1, keepdim=True))
    unit = points / norms
    bad = torch.isnan(unit).any(dim=-1)
    ppad, pnorm = pad_for_pallas(unit, tn=tn, bad=bad)
    return ppad, pnorm, bad


def prepare_lp_index(points: torch.Tensor, tn: int | None = None):
    """The Lp kernel's resident arrays (ops/bruteforce.py:1012-1021):
    NaN-zeroed points padded to ``tn`` rows (default ``PAD_ROWS``), the
    additive +inf exclusion mask, and the NaN-row flags (the scan's
    ``invalid``).  Returns (ppad, mask, bad)."""
    bad = torch.isnan(points).any(dim=-1)
    ppad, mask = pad_for_lp(points, tn=PAD_ROWS if tn is None else tn,
                            bad=bad)
    return ppad, mask, bad


def lp_knn_prepadded(pts_padded, mask, queries, k_eff: int, n_real: int,
                     *, spec, metric: Metric):
    """Exact Lp / Chebyshev k-NN over an index padded by ``pad_for_lp``
    (ops/bruteforce.py:1024-1048): the Lp kernel's reduced distances are
    final (the direct power sum has no cancellation, so no rescore and no
    proof); the metric takes the p-th root, clamped ascending.  Returns
    (distances, ids), (Q, k_eff); NaN queries and missing slots are
    (+inf, -1)."""
    rd, idx = lp_knn(pts_padded, mask, queries, k=k_eff, spec=spec)
    idx = torch.where(idx < n_real, idx, -1)
    rd = torch.where(idx < 0, torch.inf, rd)
    return monotone_distances(metric.rdistance_to_distance(rd)), idx


def with_bcap_planes(n_real: int, dim: int, cosine: bool = False) -> bool:
    """Whether the reference's index would hold bcap planes, which its
    route needs for bcap (trees/bruteforce.py:108-118, ops/bruteforce.py:
    639-652): its split planes fit ``SPLIT_BUDGET_ELEMS``, ``n >= 262144``,
    and it is not a cosine index (``prepare_cosine_index`` makes none)."""
    return (not cosine and n_real * dim <= SPLIT_BUDGET_ELEMS
            and n_real >= CAPPED_MIN_N)


def pick_scheme(k_eff: int, n_real: int, bcap_planes: bool = True) -> str:
    """The kernel route's scheme (ops/bruteforce.py:638-663, within the
    port's kernels), with ``ks = min(k_eff + 8, n)``: bcap for ``ks <= 32``
    where the reference's index holds bcap planes (``bcap_planes``, see
    ``with_bcap_planes``) and capped for ``ks <= 128`` at serving scale
    (``n >= 262144``);
    capped for ``ks <= 1024`` or ``3072 <= ks <= 4088`` where
    ``n >= 200 ks``; otherwise fold up to ``k_eff + 8 <= 640`` and merge
    above.

    Deviation 1: the port's capped kernel keeps a tile's ``passes + 1``
    smallest on one half-warp, so ``passes <= PASSES_MAX = 15``, and a
    working set of at most ``FOLD_K_MAX = 1024``, where the reference
    allows 48 passes and 4096.  Wherever the reference's capped route
    needs more (its passes, or ``ks > 1024``, as at ``3072 <= ks <= 4088``),
    the port takes fold or merge instead of clamping the passes, which
    would send most queries to the repair.  The thresholds are the JAX
    package's cutovers; this card's own are not measured yet."""
    ks = min(k_eff + RESCORE_SLACK, n_real)
    if ks <= 32 and n_real >= CAPPED_MIN_N and bcap_planes:
        return "bcap"
    if ks <= 128 and n_real >= CAPPED_MIN_N:
        return "capped"
    if ((ks <= 1024 or 3072 <= ks <= PALLAS_K_MAX)
            and n_real >= CAPPED_N_PER_K * ks and ks <= FOLD_K_MAX
            and _passes_needed(ks, CAPPED_TILE, n_real,
                               "capped") <= PASSES_MAX):
        return "capped"
    return "fold" if k_eff + RESCORE_SLACK <= 640 else "merge"


def _passes_needed(k_scan: int, tile_rows: int, n_real: int,
                   scheme: str) -> int:
    lam = k_scan * tile_rows / n_real
    if lam <= 0.5 and (scheme == "bcap" or k_scan <= 32):
        return 2
    if scheme == "capped" and k_scan <= 128 and lam <= 2.0:
        return 4
    return math.ceil(lam + 3.0 * math.sqrt(lam) + 2.0)


def capped_passes(k_scan: int, tile_rows: int, n_real: int,
                  scheme: str) -> int:
    """Extraction passes per tile (ops/bruteforce.py:807-813, :922-928):
    sized for the per-tile survivor count, a Poisson(lam = k_scan *
    tile / n) variable, with 3 sqrt(lam) of tail slack; the small-k
    serving regimes keep the measured 2 and 4.  Capped at ``PASSES_MAX``
    for a forced scheme (a miss costs a repair, never exactness);
    ``pick_scheme`` never routes where the cap binds."""
    return min(PASSES_MAX, _passes_needed(k_scan, tile_rows, n_real, scheme))


def scan_width(scheme: str, k_eff: int, n_real: int) -> int:
    """``k_scan``, the candidates a scheme keeps: ``min(k_eff + 8, n)``;
    for merge and capped above 1024 rounded up to a multiple of 128,
    at most 4096 and at least ``k_eff`` (ops/bruteforce.py:673-679)."""
    k_scan = min(k_eff + RESCORE_SLACK, n_real)
    if scheme in ("merge", "capped") and k_scan > FOLD_K_MAX:
        k_scan = max(min(-(-k_scan // 128) * 128, MERGE_K_MAX), k_eff)
    return k_scan


def _rescore_large(points, queries, idx, k: int):
    """Direct-form rescore and re-rank for ``k_scan`` in the hundreds to
    thousands (ops/bruteforce.py:520-570): the rdist of every candidate
    (``rescore_rd``), and the re-rank a row-sort kernel,
    ``bitonic_sort_pairs`` up to width 2048 and ``rank_sort_pairs`` above.
    Same contract as ``rescore_exact``: (rdist, ids) ascending, (Q, k); NaN
    distances are +inf; ids < 0 or >= n count as missing."""
    n = points.shape[0]
    rd = rescore_rd(points, queries, idx)
    ids = torch.where((idx >= 0) & (idx < n), idx, -1).to(torch.int32)
    row_sort = (rank_sort_pairs if idx.shape[1] > BITONIC_WIDTH_MAX
                else bitonic_sort_pairs)
    sd, si = row_sort(rd, ids)
    return sd[:, :k], si[:, :k]


def _rerank(pts_padded, queries, idx, k_eff: int, k_scan: int):
    """The route's rescore of the kernel's candidates (ops/bruteforce.py:
    719-724, :937-941): ``_rescore_large`` from ``k_scan >= 512``."""
    if k_scan >= 512:
        return _rescore_large(pts_padded, queries, idx, k_eff)
    return rescore_exact(pts_padded, queries, idx, k_eff)


def _block_rd(pts_padded, xn_padded, queries, block_ids, block: int):
    """Exact direct-form rdist of every row of the candidate blocks, an id
    b standing for rows [b*block, b*block + block) (``rescore_rd``;
    ops/bruteforce.py:375-415, :465-478).  Ids < 0, rows past the padded
    index, and NaN and padding rows (+inf norms, an exclusion the direct
    form cannot see) give (+inf, -1); NaN distances are +inf, and every
    +inf carries row -1.  Returns (rd (Q, R) float32, rows (Q, R) int32),
    R = kb * block, in candidate order."""
    q, kb = block_ids.shape
    rd = rescore_rd(pts_padded, queries, block_ids, block=block,
                    norms=xn_padded)
    off = torch.arange(block, dtype=torch.int32, device=block_ids.device)
    rows = (block_ids.to(torch.int32)[:, :, None] * block
            + off).reshape(q, kb * block)
    return rd, torch.where(torch.isinf(rd), -1, rows)


def _block_rescore(pts_padded, xn_padded, queries, block_ids, k_eff: int,
                   block: int):
    """The k_eff smallest exact rdist over the candidate blocks'
    rows (``_block_rd``; the reference's ``_bcap_rescore``, and the
    candidate rescore of ``_two_phase_small_k``), ascending, ties by
    candidate position; NaN queries and missing slots give (+inf, -1).
    Returns (rd, ids), (Q, k_eff)."""
    rd, rows = _block_rd(pts_padded, xn_padded, queries, block_ids, block)
    best_rd, best_i = smallest_k(rd, rows, k_eff)
    return best_rd, torch.where(torch.isfinite(best_rd), best_i, -1)


def _bcap_rescore_large(pts_padded, xn_padded, queries, block_ids,
                        k_eff: int):
    """Rescore and selection of bcap candidates where ``k_eff * 16 > 1024``
    (ops/bruteforce.py:423-512): the exact rdist over the (Q, R) candidate
    rows, the exact k-th cutoff per row by bisection on the float32 bit
    order (31 masked counts, no sort), the entries at or below it
    compacted in candidate order into W = min(R, ceil((k + 64) / 128) * 128)
    lanes, and one row sort of width W (``bitonic_sort_pairs`` up to 2048,
    ``rank_sort_pairs`` above).  A row whose entries at or below a finite
    cutoff overflow W (ties) is flagged for the caller's repair.  A row
    with fewer than k finite candidates has cutoff +inf; it compacts its
    finite entries only, which always fit (the reference compacts its +inf
    entries too, in candidate order, and can push finite ones past W).
    Returns (rd (Q, k) ascending, ids (Q, k), overflow (Q,) bool)."""
    rd, rows = _block_rd(pts_padded, xn_padded, queries, block_ids,
                         BCAP_BLOCK)
    q, width = rd.shape
    bits = rd.view(torch.int32)
    lo = torch.zeros((q,), dtype=torch.int32, device=rd.device)
    hi = torch.full((q,), _INF_BITS, dtype=torch.int32, device=rd.device)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        ge = torch.sum(bits <= mid[:, None], dim=1) >= k_eff
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    cutoff = hi
    w = min(width, -(-(k_eff + BCAP_TIE_MARGIN) // 128) * 128)
    keep = bits <= torch.clamp_max(cutoff, _INF_BITS - 1)[:, None]
    count = torch.sum(keep, dim=1)
    pos = torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep & (pos < w), pos, w)        # column w: dropped
    cd = torch.full((q, w + 1), torch.inf, dtype=rd.dtype,
                    device=rd.device).scatter_(1, pos, rd)[:, :w]
    ci = torch.full((q, w + 1), -1, dtype=torch.int32,
                    device=rd.device).scatter_(1, pos, rows)[:, :w]
    overflow = (count > w) & (cutoff < _INF_BITS)
    row_sort = (rank_sort_pairs if w > BITONIC_WIDTH_MAX
                else bitonic_sort_pairs)
    sd, si = row_sort(cd.contiguous(), ci.contiguous())
    best_rd = sd[:, :k_eff]
    return (best_rd, torch.where(torch.isfinite(best_rd), si[:, :k_eff], -1),
            overflow)


def _two_phase_small_k(pts_padded, xn_padded, queries, k_eff: int,
                       planes=None):
    """Two-phase candidates (ops/bruteforce.py:284-372): the subchunk
    minima kernel, then each query's k_eff smallest subchunk minima (a
    stable sort: ties to the lower column, as the reference's argmin loop),
    and the exact direct-form rescore of their k_eff * 128 rows.  The k-th
    smallest minimum T bounds the true k-th u from above, and every point
    with u <= T lies in a selected subchunk.  Returns (rd (Q, k_eff)
    ascending, ids, T (Q,) u-domain); T is +inf where there are no more
    than k_eff subchunks (every row is a candidate), NaN for a NaN query.
    The port keeps its 64-row pad: rows past the padded index are missing
    candidates.  ``planes``: the index's piece planes, as
    ``knn_prepadded`` takes them."""
    with span("petal.route.candidates"):
        minima = subchunk_minima(pts_padded, queries, xn_padded,
                                 point_planes=planes)
        vals, sid = torch.sort(minima, dim=1, stable=True)
        nc = minima.shape[1]
        if k_eff <= nc:
            thr_u = vals[:, k_eff - 1]
        else:
            thr_u = torch.full((queries.shape[0],), torch.inf,
                               dtype=minima.dtype, device=minima.device)
    with span("petal.route.rescore"):
        best_rd, best_i = _block_rescore(pts_padded, xn_padded, queries,
                                         sid[:, :min(k_eff, nc)], k_eff,
                                         SUBCHUNK)
    return best_rd, best_i, thr_u


def _prove_repair(covered, best_rd, best_i, pts_padded, xn_padded, queries,
                  k_eff: int, k_scan: int, n_real: int, planes=None):
    """The compacted repair of the proof-gated schemes
    (ops/bruteforce.py:732-779): the queries the proof could not cover
    run the fold kernel (merge above ``k_scan = 1024``), which is exact
    with the rescore slack, and their rows are replaced.  Shapes are dynamic here, so the uncovered queries
    form one batch of their own size; the JAX package's 256-row cap and
    whole-batch fallback have no counterpart.  Counts the uncovered
    queries in ``route.repaired``."""
    with span("petal.route.repair"):
        unc = torch.nonzero(~covered).flatten()
        count("route.repaired", unc.numel())
        if unc.numel() == 0:
            return best_rd, best_i
        qu = queries[unc]
        if k_scan <= FOLD_K_MAX:
            _, idx = knn_fold(pts_padded, qu, xn_padded, k=k_scan)
        else:
            with span("petal.route.merge"):
                _, idx = knn_merge(pts_padded, qu, xn_padded, k=k_scan,
                                   point_planes=planes)
        fr, fi = rescore_exact(pts_padded, qu,
                               torch.where(idx < n_real, idx, -1), k_eff)
        best_rd = best_rd.index_copy(0, unc, fr)
        best_i = best_i.index_copy(0, unc, fi)
        return best_rd, best_i


def _fold_route(pts_padded, xn_padded, queries, scheme: str, k_eff: int,
                k_scan: int, n_real: int, planes=None):
    """The exact k_scan candidates of the fold, fold_lazy or merge kernel
    (merge on the index's ``planes``), rescored in the direct form
    (ops/bruteforce.py:700-725).  Returns (rd, ids) ascending, (Q,
    k_eff)."""
    with span("petal.route.candidates"):
        if scheme == "merge":
            with span("petal.route.merge"):
                _, idx = knn_merge(pts_padded, queries, xn_padded, k=k_scan,
                                   point_planes=planes)
        else:
            run = {"fold": knn_fold, "fold_lazy": knn_fold_lazy}[scheme]
            _, idx = run(pts_padded, queries, xn_padded, k=k_scan)
    with span("petal.route.rescore"):
        # drop any padded-row ids (none can appear: their norms are +inf)
        return _rerank(pts_padded, queries,
                       torch.where(idx < n_real, idx, -1), k_eff, k_scan)


def knn_prepadded(pts_padded, xn_padded, queries, k_eff: int, n_real: int,
                  center=None, *, scheme: str | None = None,
                  normalize_q: bool = False, out_rdist: bool = False,
                  planes=None):
    """Exact k-NN through the kernels over an index padded by
    ``pad_for_pallas`` (``knn_pallas_prepadded`` at FP32).

    ``pts_padded``/``xn_padded`` are pre-centered (``center_of``); pass the
    same ``center`` so the queries are shifted here.  ``normalize_q``
    L2-normalizes the queries (a cosine index, ``prepare_cosine_index``;
    zero-norm queries become NaN rows); ``out_rdist`` returns squared
    distances instead of distances (ops/bruteforce.py:664-671, :727-730).
    ``scheme`` (default ``pick_scheme``, with bcap where the reference's
    index would hold its planes) is "bcap", "capped", "fold" or "merge",
    or one of the opt-in schemes "fold_lazy", "two_phase" and "bcap2",
    which ``pick_scheme`` never takes (ops/bruteforce.py:626-637).  Every
    scheme keeps ``k_scan`` candidates (``scan_width``; bcap and bcap2:
    that many 16-row blocks, at least 12; two_phase: k_eff 128-row
    subchunks), re-scores them with the direct form and re-ranks:

    * fold and fold_lazy keep the exact FP32 top k_scan, merge the exact
      top k_scan of the tensor-core tier's u (the reference's "highest"
      six-pass product); the slack absorbs the product form's rounding, so
      they need no proof.
      fold_lazy raises ValueError beyond ``k_scan = 1024``, as the
      reference's kernel asserts;
    * capped and bcap may skip true members where a tile had more than
      ``passes`` survivors, and bcap2 keeps the blocks of its smallest
      block minima.  Their threshold ``thr`` lower-bounds every
      point left out, so a query is covered when its re-scored k-th
      distance is at most ``thr − err`` (``tc_proof_err``, the bound of
      the tensor-core tier that made the candidates of all three);
      uncovered queries are recomputed by the fold kernel
      (``_prove_repair``).  On the card, bcap and capped (picked or
      forced) take the fold route instead wherever ``knn_fold`` would run
      the few-query kernel at their queries and ``k_scan``
      (``_few_takes_fold``): its exact FP32 top k_scan is what the repair
      would compute, so there is nothing to prove;
    * two_phase's threshold is the k-th smallest subchunk minimum, on the
      tensor-core tier, and proves on its bound.  If the
      proof leaves any query uncovered, the whole batch re-runs the fold
      route (fold up to k_scan 1024, merge above), as the reference does;
      ``last_two_phase_fallback`` records whether the last call did.

    ``planes`` are the index's piece planes (``split_planes(pts_padded)``,
    made once at build), which the tensor-core kernels (bcap, capped,
    merge and the minima) read; an index that holds none has them split at
    each kernel call.

    The call counts its queries in ``route.queries`` (the normalised ones
    also in ``route.normalized``) and records its stages in
    ``petal.route.*`` spans (``utils.profiling``).

    Returns (distances, ids), (Q, k_eff), ascending; NaN queries and
    missing slots are (+inf, -1)."""
    count("route.queries", queries.shape[0])
    with span("petal.route"):
        scheme = scheme or pick_scheme(
            k_eff, n_real, with_bcap_planes(n_real, pts_padded.shape[1],
                                            normalize_q))
        k_scan = scan_width(scheme, k_eff, n_real)
        if scheme == "capped" and k_scan > FOLD_K_MAX:
            # the port's capped kernel keeps at most 1024 (deviation 1)
            scheme = "merge"
        elif _few_takes_fold(scheme, queries, k_scan, pts_padded.shape[0]):
            scheme = "fold"
        if scheme == "fold_lazy" and k_scan > FOLD_K_MAX:
            raise ValueError(f"fold_lazy keeps at most {FOLD_K_MAX} "
                             f"candidates, k_scan={k_scan}")
        proof_gated = scheme not in ("fold", "fold_lazy", "merge")
        with span("petal.route.prep"):
            if center is not None:
                queries = queries - center
            if normalize_q:
                count("route.normalized", queries.shape[0])
                with span("petal.route.normalize"):
                    queries = queries / torch.sqrt(
                        torch.sum(queries * queries, dim=-1, keepdim=True))
            if proof_gated:
                qn = torch.sum(queries * queries, dim=1)
                xn_max = torch.max(torch.where(torch.isfinite(xn_padded),
                                               xn_padded, 0.0))
                err = tc_proof_err(queries.shape[1], qn, xn_max)
        if not proof_gated:
            best_rd, best_i = _fold_route(pts_padded, xn_padded, queries,
                                          scheme, k_eff, k_scan, n_real,
                                          planes)
        elif scheme == "two_phase":
            best_rd, best_i = _two_phase_route(pts_padded, xn_padded,
                                               queries, qn, err, k_eff,
                                               n_real, planes)
        else:
            best_rd, best_i = _proved_route(pts_padded, xn_padded, queries,
                                            qn, err, scheme, k_eff, k_scan,
                                            n_real, planes)
        with span("petal.route.out"):
            # the sqrt needs the ascending clamp; the squared domain does not
            return (best_rd if out_rdist
                    else monotone_distances(torch.sqrt(best_rd))), best_i


def _few_takes_fold(scheme: str, queries, k_scan: int, n_padded: int) -> bool:
    """Whether a bcap or capped call takes the fold route: on the card,
    where ``knn_fold`` would run the few-query kernel for these queries at
    ``k_scan`` (``fold_path``'s "few").  That kernel's candidates are the
    exact FP32 top k_scan, which the repair would compute, so a proof
    could only confirm them; the answers rest on the premise of every
    repair, that the true k nearest lie in the FP32 top k_eff + 8.  On CPU
    tensors the routes stay as they are."""
    q, dim = queries.shape
    return (queries.is_cuda and scheme in ("bcap", "capped")
            and k_scan <= FOLD_K_MAX
            and fold_path(q, k_scan, dim, n_padded) == "few")


def _two_phase_route(pts_padded, xn_padded, queries, qn, err, k_eff: int,
                     n_real: int, planes=None):
    """two_phase's candidates, rescore and whole-batch proof
    (ops/bruteforce.py:955-981): one uncovered query sends the whole batch
    to the fold route; with the k nearest points in k different subchunks
    the k-th rescored distance equals T + ||q||^2 up to rounding, so at
    serving scale most batches fall back.  Returns (rd, ids) ascending,
    (Q, k_eff)."""
    global last_two_phase_fallback
    best_rd, best_i, thr_u = _two_phase_small_k(pts_padded, xn_padded,
                                                queries, k_eff, planes)
    with span("petal.route.proof"):
        kth, thr = best_rd[:, -1], thr_u + qn
        covered = (kth <= thr - err) | (~torch.isfinite(kth)
                                        & ~torch.isfinite(thr))
        last_two_phase_fallback = not bool(torch.all(covered))
    if last_two_phase_fallback:
        run = ("fold" if min(k_eff + RESCORE_SLACK, n_real) <= FOLD_K_MAX
               else "merge")
        best_rd, best_i = _fold_route(pts_padded, xn_padded, queries, run,
                                      k_eff, scan_width(run, k_eff, n_real),
                                      n_real, planes)
    return best_rd, best_i


def _proved_route(pts_padded, xn_padded, queries, qn, err, scheme: str,
                  k_eff: int, k_scan: int, n_real: int, planes=None):
    """bcap, bcap2 and capped: the candidates (on the index's ``planes``),
    their rescore, the per-query proof against ``thr - err`` and the
    compacted repair of the uncovered queries (``_prove_repair``).
    Returns (rd, ids) ascending, (Q, k_eff)."""
    overflow = None
    if scheme in ("bcap", "bcap2"):
        n_blocks = -(-pts_padded.shape[0] // BCAP_BLOCK)
        with span("petal.route.candidates"):
            if scheme == "bcap":
                k_cand = min(max(k_eff + RESCORE_SLACK, 12), BCAP_TILE,
                             n_blocks)
                passes = capped_passes(k_cand, BCAP_TILE * BCAP_BLOCK,
                                       n_real, scheme)
                _, idx, thr = knn_bcap(pts_padded, queries, xn_padded,
                                       k=k_cand, tile=BCAP_TILE,
                                       passes=passes, point_planes=planes)
            else:
                # ops/bruteforce.py:853-905: the k_cand smallest block
                # minima; an unselected block's minimum is at least the
                # k_cand-th
                k_cand = min(max(k_eff + RESCORE_SLACK, 12), n_blocks)
                minima = bcap_minima(pts_padded, queries, xn_padded,
                                     point_planes=planes)
                vals, idx = torch.topk(minima, k_cand, dim=1, largest=False)
                thr = vals[:, -1] + qn
        covers_all = k_cand * BCAP_BLOCK >= n_real
        with span("petal.route.rescore"):
            if k_eff * BCAP_BLOCK > 1024:
                best_rd, best_i, overflow = _bcap_rescore_large(
                    pts_padded, xn_padded, queries, idx, k_eff)
            else:
                best_rd, best_i = _block_rescore(pts_padded, xn_padded,
                                                 queries, idx, k_eff,
                                                 BCAP_BLOCK)
    elif scheme == "capped":
        tile = max(CAPPED_TILE, -(-k_scan // PAD_ROWS) * PAD_ROWS)
        passes = capped_passes(k_scan, tile, n_real, scheme)
        with span("petal.route.candidates"):
            rd, idx, thr = knn_capped(pts_padded, queries, xn_padded,
                                      k=k_scan, tile=tile, passes=passes,
                                      point_planes=planes)
        covers_all = k_scan >= n_real
        with span("petal.route.rescore"):
            # a seed slot may hold a NaN or padding row at +inf: the direct
            # form would score its zeroed copy as finite, so it goes as -1
            ok = torch.isfinite(rd) & (idx < n_real)
            best_rd, best_i = _rerank(pts_padded, queries,
                                      torch.where(ok, idx, -1), k_eff, k_scan)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    with span("petal.route.proof"):
        kth = best_rd[:, -1]
        covered = covers_all | (kth <= thr - err)
        if overflow is not None:
            # ties past the compaction's margin: the row repairs
            covered = covered & ~overflow
        # a non-finite k-th is covered only when thr is non-finite too (a
        # NaN query, or nothing finite skipped); a finite thr means finite
        # scores were skipped while the set still held +inf seeds
        # (:841-849)
        covered = covered | (~torch.isfinite(kth) & ~torch.isfinite(thr))
    return _prove_repair(covered, best_rd, best_i, pts_padded, xn_padded,
                         queries, k_eff, k_scan, n_real, planes)


def _pick_chunk(n: int, q: int, dim: int, chunk: int | None,
                direct: bool) -> int:
    if chunk is not None:
        return max(1, min(chunk, n))
    # Aim for ~64 MB of per-step intermediate, power-of-two sized.  The
    # direct-difference forms (d <= 32, and the Lp metrics at any d)
    # materialize (q, c, dim), not (q, c).
    per_elem = 4 * (dim if direct else 1)
    target = max(1, (64 << 20) // max(per_elem * q, 1))
    c = 1 << min(int(math.log2(target)) if target > 1 else 0, 20)
    return max(128, min(c, n))


def knn(points, queries, k: int, metric: Metric | None = None,
        *, chunk: int | None = None, point_norms=None,
        rescore: bool = True, backend: str = "auto",
        assume_centered: bool = False, invalid=None):
    """Exact k nearest neighbors of ``queries`` (Q, d) among ``points``
    (n, d) (``ops/bruteforce.py:144-200``): (distances, ids int32), each
    (Q, min(k, n)), ascending.

    ``backend``: "xla" names the streamed scan (the JAX package's XLA
    path), "pallas" the hand-written CUDA route (``pad_for_pallas``, then
    ``knn_prepadded`` with ``pick_scheme(k, n, bcap_planes=False)``), and
    "auto" takes that route for float32 Euclidean CUDA tensors at d > 32,
    n >= 4096 and k <= ``PALLAS_K_MAX``, the scan otherwise.  A forced
    "pallas" outside float32 Euclidean and k <= ``PALLAS_K_MAX`` raises
    ``ValueError``; on CPU tensors it runs the kernels' plain versions.
    Nothing falls back from the kernels to the scan.

    ``assume_centered``: set by callers that pass centred data (an index's
    ``center_of`` copy, with its ``point_norms``); otherwise high-dim
    Euclidean input is centred here and ``point_norms`` dropped, since the
    matmul form cancels catastrophically off the origin.  ``rescore``
    re-scores the scan's top (k + slack) high-dim Euclidean candidates in
    the direct form.  ``invalid`` (n,) bool marks rows that must never
    match (an index's zeroed NaN rows): only the scan honours it, so it
    keeps the call there whatever the backend, as in the JAX package.
    """
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    metric = metric or Euclidean()
    n = points.shape[0]
    k_eff = min(int(k), n)
    if k_eff == 0:
        return (torch.zeros((queries.shape[0], 0), dtype=points.dtype,
                            device=points.device),
                torch.zeros((queries.shape[0], 0), dtype=torch.int32,
                            device=points.device))
    dim = points.shape[1]
    if (not assume_centered and isinstance(metric, Euclidean)
            and dim > DIRECT_DIM_MAX):
        mu = center_of(points)
        points = points - mu
        queries = queries - mu
        point_norms = None      # the uncentred data's norms are wrong here
    if (backend != "xla" and invalid is None
            and _kernel_eligible(points, queries, k_eff, metric,
                                 backend == "pallas")):
        # its own padded rows and, on the card, their piece planes, split
        # once for every kernel of the call
        pp, pn = pad_for_pallas(points, point_norms)
        return knn_prepadded(pp, pn, queries, k_eff, n,
                             scheme=pick_scheme(k_eff, n, bcap_planes=False),
                             planes=index_planes(pp))
    direct = dim <= DIRECT_DIM_MAX or not isinstance(metric,
                                                     (Euclidean, Cosine))
    c = _pick_chunk(n, queries.shape[0], dim, chunk, direct)
    return _knn_impl(points, queries, point_norms, invalid, k_eff, metric, c,
                     rescore)


def _kernel_eligible(points, queries, k_eff: int, metric: Metric,
                     force: bool) -> bool:
    """Whether ``knn`` takes the kernel route (``_pallas_eligible``,
    ops/bruteforce.py:202-220, with a CUDA tensor in place of its
    availability test).  The exact-type test: ``knn_prepadded`` converts
    with a plain sqrt, wrong for subclasses such as SqEuclidean."""
    hard = (type(metric) is Euclidean
            and points.dtype == torch.float32
            and queries.dtype == torch.float32
            and k_eff <= PALLAS_K_MAX)
    if force:
        if not hard:
            raise ValueError(
                "backend='pallas' requires Euclidean metric, f32 data and "
                f"k <= {PALLAS_K_MAX}")
        return True
    return (hard and points.shape[1] > DIRECT_DIM_MAX
            and points.shape[0] >= 4096 and points.is_cuda)


def _knn_impl(points, queries, point_norms, invalid, k: int,
              metric: Metric, chunk: int, rescore: bool = True):
    """Exact k nearest neighbors of ``queries`` (Q, d) among ``points``
    (n, d), streamed over point chunks (``ops/bruteforce.py:1064-1160``).

    Returns ``(distances, indices)`` with shape (Q, k), sorted ascending;
    the caller guarantees ``1 <= k <= n``.  NaN distances sort as +inf.

    For high-dim Euclidean the streaming pass uses the matmul form; with
    ``rescore`` the final top-(k + slack) candidates are re-scored with the
    direct (q-x)^2 form and re-ranked.
    """
    n, dim = points.shape
    q = queries.shape[0]
    dev = points.device
    do_rescore = (rescore and isinstance(metric, Euclidean)
                  and dim > DIRECT_DIM_MAX)
    k_scan = min(k + RESCORE_SLACK, n) if do_rescore else k

    use_norms = isinstance(metric, Euclidean)
    if use_norms:
        qn = torch.sum(queries * queries, dim=-1)
        # provided norms are used as they are, never recomputed: an
        # index's resident copy may hold zeroed NaN rows whose exclusion
        # lives in the +inf norms
        xn = (point_norms if point_norms is not None
              else torch.sum(points * points, dim=-1))

    best_d = torch.full((q, k_scan), torch.inf, dtype=points.dtype,
                        device=dev)
    best_i = torch.full((q, k_scan), -1, dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        pts = points[base:base + chunk]
        if use_norms:
            rd = metric.rdist_with_norms(queries, pts, qn,
                                         xn[base:base + chunk])
        else:
            rd = metric.rdist(queries, pts)
        rd = nan_to_inf(rd)
        if invalid is not None:
            rd = torch.where(invalid[base:base + chunk][None, :], torch.inf,
                             rd)
        ids = torch.arange(base, base + pts.shape[0], dtype=torch.int32,
                           device=dev).expand(q, -1)
        # New candidates go first so a real point at +inf (NaN coords sort
        # farthest) beats the -1/inf init sentinel on the positional
        # tie-break.
        best_d, best_i = merge_topk(rd, ids, best_d, best_i, k_scan)

    if invalid is not None:
        # invalid rows are selectable only at +inf ties (k ~ finite count);
        # they must never reach the rescore nor surface as results
        best_i = torch.where(invalid[best_i.clamp_min(0).long()]
                             & (best_i >= 0), -1, best_i)
    if do_rescore:
        best_d, best_i = rescore_exact(points, queries, best_i, k)
    # invalid queries (NaN coords): every distance is NaN -> +inf, and the
    # positional tie-break above would surface arbitrary real ids — align
    # with the kernel route's (+inf, -1) policy
    qbad = metric.invalid_queries(queries)[:, None]
    dists = monotone_distances(metric.rdistance_to_distance(best_d))
    return (torch.where(qbad, torch.inf, dists),
            torch.where(qbad, -1, best_i))


# -- the radius family (ops/bruteforce.py:1163-1548) -------------------------

def _no_rows(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.bool, device=device)


def direct_rdist(queries, pts, metric: Metric):
    """(Q, c) reduced distances for radius decisions: the direct
    difference form for Euclidean at any dim (the matmul form's
    cancellation would flip boundary decisions), ``metric.rdist``
    otherwise.  NaN stays NaN."""
    if isinstance(metric, Euclidean):
        diff = queries[:, None, :] - pts[None, :, :]
        return torch.sum(diff * diff, dim=-1)
    return metric.rdist(queries, pts)


def _member_chunk(pts, queries, rr, metric: Metric, inclusive: bool):
    """(Q, c) membership of one point chunk (ops/bruteforce.py:1421-1428);
    NaN distances never match."""
    rd = nan_to_inf(direct_rdist(queries, pts, metric))
    return (rd <= rr) if inclusive else (rd < rr)


def _members(points, queries, rr, metric: Metric, inclusive: bool, invalid,
             chunk: int):
    """(base, (Q, c) membership) of each point chunk in id order, the
    ``invalid`` rows never members."""
    for base in range(0, points.shape[0], chunk):
        yield base, (_member_chunk(points[base:base + chunk], queries, rr,
                                   metric, inclusive)
                     & ~invalid[None, base:base + chunk])


def append_ids(out, count, member, vals):
    """Append each row's accepted ``vals`` (``member`` True), in order, to
    ``out`` (..., cap + 1) at the row's running ``count``; the entries past
    the cap land in the last column, which the caller drops, and the
    counts still take them.  The last axis is the row; ``vals`` broadcasts
    to ``member``'s shape.  Returns the new counts."""
    cap = out.shape[-1] - 1
    pos = count[..., None] + torch.cumsum(member, dim=-1) - 1
    pos = torch.where(member & (pos < cap), pos, cap)
    out.scatter_(-1, pos, vals.to(out.dtype).expand_as(pos))
    return count + torch.sum(member, dim=-1)


def _cols(base: int, width: int, device) -> torch.Tensor:
    return torch.arange(base, base + width, device=device)


def radius_mask(points, queries, radius, metric: Metric | None = None,
                *, inclusive: bool = True, chunk: int | None = None,
                invalid=None, amb_cap: int = 256):
    """Boolean membership mask (Q, n): distance to the query within
    ``radius`` (ops/bruteforce.py:1163-1209).

    ``inclusive=True`` tests ``d <= r``, else the strict ``d < r``.  NaN
    distances never match, nor do the ``invalid`` (n,) rows (an index's
    zeroed NaN rows).  Float32 Euclidean corpora at d > 32 and n >= 4096
    take the matmul form with a boundary band (``_radius_mask_matmul``);
    where more than ``amb_cap`` points of some query land in the band, the
    direct form runs again, with a ``RuntimeWarning``."""
    metric = metric or Euclidean()
    n, dim = points.shape
    q = queries.shape[0]
    if invalid is None:
        invalid = _no_rows(n, points.device)
    r = torch.as_tensor(radius, dtype=points.dtype, device=points.device)
    if (isinstance(metric, Euclidean) and dim > DIRECT_DIM_MAX
            and n >= 4096 and points.dtype == torch.float32
            and queries.dtype == torch.float32):
        c = _pick_chunk(n, q, dim, chunk, direct=False)
        mask, overflow = _radius_mask_matmul(
            points, queries, metric.distance_to_rdistance(r), invalid,
            inclusive=inclusive, chunk=c, cap=min(amb_cap, c))
        if not overflow:
            return mask
        warnings.warn(
            f"radius_mask: > {amb_cap} points per query within the "
            "matmul-form error band of the radius; re-running the direct "
            "path for exact boundary decisions", RuntimeWarning,
            stacklevel=2)
    c = _pick_chunk(n, q, dim, chunk, direct=isinstance(metric, Euclidean))
    mask = torch.empty((q, n), dtype=torch.bool, device=points.device)
    for base, m in _members(points, queries, metric.distance_to_rdistance(r),
                            metric, inclusive, invalid, c):
        mask[:, base:base + m.shape[1]] = m
    return mask


def _radius_band(dim: int) -> float:
    """Worst-case |matmul rd − direct rd| over ‖q‖² + max ‖x‖² for the
    full-FP32 ``qn + xn − 2 q·x`` form (ops/bruteforce.py:1248-1258): the
    sequential-sum accumulation of the d-term products plus the final
    additions.  A sound bound, not a stochastic one; it holds only for an
    FP32 product, never a TF32 one (``distance._cross``)."""
    return (8.0 + 2.0 * dim) * 2.0 ** -24


def _radius_mask_matmul(points, queries, rr, invalid, *, inclusive: bool,
                        chunk: int, cap: int):
    """High-dim Euclidean membership by the matmul form
    (ops/bruteforce.py:1262-1337).  With err = ``_radius_band(d)·(‖q‖² +
    max ‖x‖²)`` each pair is certain in (rd < rr − err), certain out
    (rd > rr + err) or ambiguous; each query's first ``cap`` ambiguous ids
    are re-decided by the direct form (``_amb_rescore``).  Returns (mask
    (Q, n), overflow: some query had more than ``cap`` ambiguous ids); the
    per-query ambiguous counts go to ``last_band_ambiguous``."""
    global last_band_ambiguous
    n, dim = points.shape
    q = queries.shape[0]
    qn = torch.sum(queries * queries, dim=-1)
    xn = torch.sum(points * points, dim=-1)
    # NaN rows' norms must not widen the band (their rd is +inf: out)
    xn_max = torch.max(torch.where(invalid | ~torch.isfinite(xn), 0.0, xn))
    err = _radius_band(dim) * (qn + xn_max)
    lo, hi = (rr - err)[:, None], (rr + err)[:, None]
    mask = torch.empty((q, n), dtype=torch.bool, device=points.device)
    amb_ids = torch.full((q, cap + 1), n, dtype=torch.int64,
                         device=points.device)
    count = torch.zeros((q,), dtype=torch.int64, device=points.device)
    for base in range(0, n, chunk):
        pts = points[base:base + chunk]
        rd = nan_to_inf(qn[:, None] + xn[None, base:base + chunk]
                        - 2.0 * _cross(queries, pts))
        ok = ~invalid[None, base:base + chunk]
        sure = (rd < lo) & ok
        mask[:, base:base + chunk] = sure
        count = append_ids(amb_ids, count, ~sure & (rd <= hi) & ok,
                           _cols(base, pts.shape[0], points.device))
    last_band_ambiguous = count
    amb_ids = amb_ids[:, :cap]
    member = _amb_rescore(points, queries, amb_ids, rr, inclusive, n)
    # an ambiguous pair is never sure, and a row lists an id once
    rows = torch.arange(q, device=points.device)[:, None].expand_as(amb_ids)
    listed = amb_ids < n
    mask[rows[listed], amb_ids[listed]] = member[listed]
    return mask, bool(torch.any(count > cap))


def _amb_rescore(points, queries, ids, rr, inclusive: bool, n: int):
    """Direct-form membership of the ambiguous ids (Q, cap), sentinel
    ``n``, over query blocks of 128 (ops/bruteforce.py:1340-1361)."""
    out = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for s in range(0, ids.shape[0], 128):
        idb = ids[s:s + 128]
        ok = idb < n
        cand = points[torch.where(ok, idb, 0)]
        rd = nan_to_inf(torch.sum((queries[s:s + 128, None, :] - cand) ** 2,
                                  dim=-1))
        out[s:s + 128] = ((rd <= rr) if inclusive else (rd < rr)) & ok
    return out


def radius_counts(mask):
    """Per-query neighbour counts of a membership mask, int32."""
    return torch.sum(mask, dim=-1).to(torch.int32)


def _stream(points, queries, radius, metric, inclusive, invalid, chunk):
    """The streaming radius ops' membership chunks (``_members``), with
    the chunk size of the direct form (ops/bruteforce.py:1369-1379)."""
    metric = metric or Euclidean()
    if invalid is None:
        invalid = _no_rows(points.shape[0], points.device)
    c = _pick_chunk(points.shape[0], queries.shape[0], points.shape[1],
                    chunk, direct=isinstance(metric, Euclidean))
    r = torch.as_tensor(radius, dtype=points.dtype, device=points.device)
    return _members(points, queries, metric.distance_to_rdistance(r), metric,
                    inclusive, invalid, c)


def radius_counts_streaming(points, queries, radius,
                            metric: Metric | None = None, *,
                            inclusive: bool = True, invalid=None,
                            chunk: int | None = None):
    """Per-query counts within the radius with no (Q, n) mask: one pass
    over point chunks in the direct form, (Q,) int32
    (ops/bruteforce.py:1382-1399)."""
    cnt = torch.zeros((queries.shape[0],), dtype=torch.int64,
                      device=points.device)
    for _, m in _stream(points, queries, radius, metric, inclusive, invalid,
                        chunk):
        cnt += torch.sum(m, dim=1)
    return cnt.to(torch.int32)


def radius_capped(points, queries, radius, metric: Metric | None = None,
                  *, cap: int, inclusive: bool = True, invalid=None,
                  chunk: int | None = None):
    """Streaming capped radius search (ops/bruteforce.py:1402-1495): (ids
    (Q, min(cap, n)) int32, counts (Q,) int32) with no (Q, n) mask.  Each
    row holds its first members in ascending id order, -1 padded; the
    counts are exact past the cap (``counts > cap``: the list was cut)."""
    q = queries.shape[0]
    cap = min(cap, points.shape[0])
    ids = torch.full((q, cap + 1), -1, dtype=torch.int32,
                     device=points.device)
    cnt = torch.zeros((q,), dtype=torch.int64, device=points.device)
    for base, m in _stream(points, queries, radius, metric, inclusive,
                           invalid, chunk):
        cnt = append_ids(ids, cnt, m, _cols(base, m.shape[1], points.device))
    return ids[:, :cap], cnt.to(torch.int32)


def distances_at(points, queries, ids, metric: Metric):
    """Exact distances from each query to its own ids (Q, cap), over query
    blocks of 128 (ops/bruteforce.py:1499-1526); -1 and out-of-range ids
    and NaN distances give +inf."""
    n = points.shape[0]
    rd = torch.empty(ids.shape, dtype=points.dtype, device=points.device)
    for s in range(0, ids.shape[0], 128):
        idb = ids[s:s + 128]
        ok = (idb >= 0) & (idb < n)
        cand = points[torch.where(ok, idb, 0).long()]
        rdb = nan_to_inf(metric.rowwise_rdist(queries[s:s + 128, None, :],
                                              cand))
        rd[s:s + 128] = torch.where(ok, rdb, torch.inf)
    # +inf stays +inf (Haversine's conversion clips its domain)
    return torch.where(torch.isinf(rd), torch.inf,
                       metric.rdistance_to_distance(rd))


def compact_mask(mask, cap: int):
    """A (Q, n) mask compacted into (ids (Q, cap) int32, counts (Q,)
    int32): each row's first ``cap`` member columns ascending, -1 padded
    (ops/bruteforce.py:1530-1548)."""
    q, n = mask.shape
    ids = torch.full((q, min(cap, n) + 1), -1, dtype=torch.int32,
                     device=mask.device)
    counts = append_ids(ids, torch.zeros((q,), dtype=torch.int64,
                                         device=mask.device), mask,
                        _cols(0, n, mask.device))
    ids = ids[:, :-1]
    if cap > n:
        ids = torch.nn.functional.pad(ids, (0, cap - n), value=-1)
    return ids, counts.to(torch.int32)
