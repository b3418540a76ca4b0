"""Drive petal_neighbors_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — compiles every kernel source under
              petal_neighbors_tpu_torch/ops/cuda/csrc with nvcc; then
              build_ptxas, each kernel's registers, spills and stack frame
              from ``-Xptxas -v`` (knn_fold.cu, knn_select.cu,
              knn_minima.cu, mst_scan.cu, split_planes.cu), and the kernels
              of the tensor-core core whose wgmma ptxas serialized
              (``wgmma_notes``).
   tc_probe — the tensor-core tier's integrity probe (knn_kernel.tc_probe):
              its largest |u - u_f64| over the tier's bound, at most 1.
   planes — the tensor-core core's piece planes (tc_planes.split_planes,
              csrc/split_planes.cu) at the SIFT, GIST and GloVe index shapes
              and one 10,240-query batch: the split's time beside its byte
              bound and its plain version's, the planes' bytes beside the
              float32 rows', and the first and last tiles against the plain
              version byte for byte; then, at the GIST shape, what a call
              of the functional knn() (no index: it pads and splits its
              rows in the call) costs beside an index's query_batch:
              host time and device memory above its inputs.
   rescore — the direct-form rescore (rescore_kernel.rescore_rd,
              csrc/rescore.cu) at RESCORE_SHAPES, the benchmark's batch
              cells' rescores and one single query: the kernel's time
              beside its byte bound (the candidate rows read once) and its
              plain version's on the card; its +inf exactly where the
              plain version's are, its rdist within rescore_rounding of a
              float64 sum of the same rounded differences' squares (the
              first 64 queries), and its largest relative gap to the plain
              version.
   mst_kernel_small — the Borůvka scan kernel (csrc/mst_scan.cu)
              against its plain version, bw and bj bit for bit: n ragged
              against the 256-row stages (1 to 4,097), d = 1 to 8 (the
              direct kernel in f32), 17 and 40, labels all distinct, three
              components or one (every row (+inf, -1)), small-integer rows
              with exact ties and duplicates, real rows and rows whose
              exponents spread over 2^-12 to 2^12 (where the fused f32 step
              and a separately rounded one differ), +inf cores, query rows
              of their own, f32 and f64.
3. kernel   — each kernel (fold, fold_lazy, capped, bcap, merge) against
              its plain PyTorch version on the card, with the same launch
              plan: small
              shapes with NaN rows, NaN queries, duplicated rows and ragged
              tails (at the vectorized and the chunked scalar widths, split
              into row ranges or not, working set in shared or global
              memory), k = 1024 (fold) and 1100 to 4096 (merge), merge's
              edge rows (all rows equal, duplicates, a +inf tail, k above
              the rows), and the main paths' shapes over 1M x 128 (merge
              with its radix passes per call).  Sorted rdist and
              thresholds must agree within the stated tolerance, and an id
              may differ only against one of near-equal rdist; fold_lazy
              must also give fold's rdist bit for bit, and bcap's
              block-min rdist at its ids must equal the rdist made from
              the block-minima kernel's columns at the same ids, bit for
              bit (bcap_is_minima: one tensor-core epilogue).  fold_lazy
              (its own 128-query x 128-row FP32 product) also at q = 1,
              127, 129 and 300, d = 17, 130 and 960, k = 1 to 1024, its
              working set in shared and in global memory, 1 and 17 row
              ranges, and held to both fold paths' rdist bit for bit at
              every case and at the SIFT shape.  The two minima kernels
              (subchunk, block; both on the tensor-core tier) against
              their plain versions at ragged row counts, d = 17 to 130 and
              960, NaN rows and queries, 1 and several row ranges, and at
              the SIFT shape, both timed there; each subchunk column equal
              bit for bit to the min of the 8 block minima it covers
              (subchunk_is_block), at every case and the SIFT shape.  The
              two row sorts (bitonic, rank; one block sort on the card)
              against a stable ``torch.sort``, keys bit for bit and
              payloads exact:
              both entry points on the edge rows (all keys equal, only
              +inf, negative keys, -0.0 among +0.0) at widths 1 to 8192;
              rows with duplicate keys and +inf tails at the path's
              shapes (bitonic 2,048 x 1008 and 2048, 10,240 x 256; rank
              2,048 x 2176, 3072 and 4096), timed; and the rows the route
              itself hands each sort at k=1000, 2000, 3000 and bcap2
              k=100, captured and timed beside them.  The Lp kernel
              against its plain version at d = 33, 48, 64, 130 and 960,
              p = 1, 2.5, 3, 4 and Chebyshev, k = 1 to 4096, with NaN rows,
              NaN queries and ragged tails.  fold's two paths (the radix
              select over its FP32 product, and the streaming kernel),
              each forced, at FOLD_PATH_CASES: q = 1 to 300 on both sides
              of the cutover, k = 1 to 1024, ragged rows, NaN rows and
              queries, k above the finite rows, integer rows with many
              exact ties (the select's ids equal the plain version's;
              collect narrows over several passes), the two paths' rdist
              equal bit for bit and fold_lazy equal to both.
   fold_paths — fold's select and streaming paths timed in turns over
              the SIFT index (and, in main_generic, the GIST one) at
              FOLD_TABLE's queries x k_scan, with the few-query kernel
              where ``fold_path`` picks it; at the route's repair shapes
              also the plain version, the library call and the bound.
              knn_kernel.FOLD_SELECT_Q was read from it.
   few_query — the few-query kernel (csrc/knn_few.cu) timed in turns
              with fold's select and streaming paths (at k_scan 18 and 1
              to 4 queries also the tensor-core capped and bcap kernels
              the single queries' schemes name, and ``knn_few`` itself,
              each called directly) over FEW_SWEEP: SIFT (the main index) and
              GIST 1M x 960, 1M rows of d = 2, 8 (the MST core pass's
              repair, 31 queries at k_scan 13), 32, 64, 256 and 512, at q =
              1 to 64 and k_scan 18, 108 and 128; 100k x 2 (config 2's VP
              repair, 10 queries), 10k x 128 and 10k x 960; beside the
              bytes bound, the path ``fold_path`` picks and its margin; at
              one query also the plain version and the library call.  The
              kernel's rdist equal to the streaming kernel's bit for bit at
              every point; the kernel against its plain version at
              FEW_COMPARE_Q queries (SIFT: k_scan 18 and 108; GIST: 18);
              then the route on 1 to 4 queries at k=10 over SIFT (bcap)
              and GIST (capped) and k=100 over SIFT (capped): the fold
              route on the few-query kernel, no tile kernel, no query
              repaired, ids against an f64 oracle; and 50 single queries a
              shape through
              ``BruteForce.query``, every one counted in
              ``knn.few_queries``.  knn_kernel.FEW_RULE was read from it.
4. main     — ``BruteForce.euclidean`` over 1M x 128 f32 points (seed 7,
              as bench.py makes them) answering 10,240 queries at k=10
              (bcap), k=100 and k=200 (capped); every kernel's launches in
              that run (fold's by path) and the queries each fold repair
              carried (under the proof's tier, "tc" for bcap and capped),
              the repair's time on its path and on the streaming kernel;
              every
              query's ids against a chunked f64 oracle on the card, where
              an id may differ only by a swap that f32 direct-form
              distances cannot order.
5. main_large_k — the same index answering the first 2,048 queries at
              k=1000 (capped, re-ranked by the bitonic sort), k=2000 and
              k=3000 (merge; the bitonic and the rank sort), with the same
              oracle check and the launches of that run.
6. main_opt_in — the same index through ``knn_prepadded`` with the opt-in
              schemes on all 10,240 queries: bcap2 at k=10 and k=100 (the
              large-k rescore and the bitonic sort), two_phase and
              fold_lazy at k=10; QPS, launches, queries repaired (bcap2) and
              whole-batch fallbacks (two_phase) per call; ids against the
              main phase's f64 oracle.
7. main_generic — the JAX package's config 5 (benchmarks/run.py:192-212):
              1M x 960 f32 points and 1,000 queries (seed 5, uniform in
              [0, 1)), three indexes built one at a time, each answering
              k=10: Euclidean and Cosine on the capped kernel, Minkowski-3
              on the Lp kernel.  Per index: QPS, kernel ms, launches,
              queries repaired, build seconds; ids against an f64 oracle
              (every query; Minkowski-3 on as many as the time allows, at
              least 256).  Then the path's kernels against their plain
              versions at this shape, the Lp kernel's time for Manhattan and
              Chebyshev, and bcap at this shape as a yardstick.
   radius_flat — the same index's radius search (plain PyTorch): r is the
              median over the first 1,024 queries of their 100th-neighbour
              distance (k=100 above); ``query_radius_batch`` on those
              queries takes the matmul band form (a 1 GB mask), held to a
              plain direct-form mask made chunk by chunk on the card: a
              pair may differ only within 2 f32 ulp of rr.  Then
              ``cap=512`` and ``query_radius_count_batch`` on all 10,240
              queries: counts equal to each other and to the mask's row
              sums (off only by pairs within 2 ulp), capped ids the mask's
              first members.  QPS of each form, ambiguous pairs per query,
              whether the band overflowed.
   vp_sift — (PR 14) a VantagePointTree over the same SIFT points:
              "auto" builds it on the card (level-synchronous) and answers
              all 10,240 queries at k=10 on the kernel route (capped,
              k_scan 18, 2 passes, with the fold repair; no bcap planes);
              QPS, the device build's seconds, launches, the queries
              repaired, ids against the main phase's f64 oracle; then
              capped (whole batch) and fold (the largest repair) against
              their plain versions at this shape, timed beside the plain
              version, a library call and the bound.
8. ball_knn — the JAX package's config 1 (benchmarks/run.py:109-127):
              ``BallTree`` over 100,000 x 2 N(0,1) f32 points (seed 1,
              host build), 10,000 queries at k=2 by the tiled ("auto") and
              per-query schemes; build seconds, QPS, ``loop_chunks`` (host
              loop steps, one device-to-host read each), every query's ids
              against the f64 oracle.
   ball_radius — config 4 (:173-189): seed 4, the first 4,096 points as
              queries, eps 0.01, 0.05 and 0.2, capped at 512 (tiled and
              per-query), the count form and the mask form; counts equal
              across the forms, capped ids the mask's members; QPS of each.
   ball_device_build — 1,000,000 x 2 N(0,1) f32 (seed 1) with the "auto"
              builder on the card: it must take the device build, its idx
              equal to the host "vectorized" build's bit for bit, centroids
              and radii within 1e-6 relative (+ 1e-6); both builds'
              seconds; config 1's
              queries at k=2 on it against the f64 oracle.
   ball_highdim — 65,536 x 40 uniform f32, 1,024 queries, k=10 per query
              (the matmul-form leaf scan and the direct rescore), against
              the f64 oracle.
   vp_knn   — (PR 14) the JAX package's config 2 (benchmarks/run.py:
              128-149): VantagePointTree over 100,000 x 2 N(0,1) f32
              (seed 2, the native host build), k=10 on the first 1,000 and
              all 4,096 queries under "auto" (the kernel route: capped,
              4 passes, and the fold repair), "per_query" and "tiled";
              QPS, loop_chunks, launches and repairs, every query against
              the f64 oracle; capped and fold against their plain versions
              at this shape.  Fails unless capped ran under "auto", and
              unless fold ran on the VP route in this phase or vp_sift.
   vp_radius — config 4's data on the VP tree: the capped search (cap
              512; its loop steps) and the mask form at eps 0.01, 0.05 and
              0.2, counts equal to a plain inclusive direct-form count
              except pairs within 2 f32 ulp of r, listed ids members.
   vp_device_build — 1,000,000 x 2 N(0,1) (seed 1): "auto" must build on
              the card, cold and warm, against the native host build; the
              two number their nodes differently, so config 1's 10,000
              queries at k=10 per query on both trees give equal
              distances and ids equal away from ties, against the f64
              oracle.
   dynamic  — DynamicIndex over config 1's points: 5,000 rows added and
              5,000 ids removed (10% of the base, under the 0.25 rebuild
              threshold), 10,000 queries at k=10 against the f64 oracle
              over the live rows, the capped radius (eps 0.05, cap 512)
              against a plain strict count; then rebuild(), timed, and
              both again.
   hdbscan  — the JAX package's MST workload (benchmarks/
              mst_probe.py:47-48): 1M x 8 uniform f32, seed 0xB0, min_samples
              5, through ``mutual_reachability_mst`` on the card: the core
              distances on the kernel route (capped with the fold repair;
              their launches and seconds), each Borůvka round's scan-kernel
              ms (CUDA events), wall and host union-find seconds; the edges
              span (scipy), every weight within 8 f32 ulp of max(core_u,
              core_v, d(u, v)) in f64, 4,096 core distances within 8 ulp of
              an f64 direct-form k-th NN, the weight sum within 1e-6
              relative of the 186891.1277 the JAX package recorded; the host
              stages (single_linkage, condense_tree, extract_clusters)
              timed, with the cluster count; the scan kernel against its
              plain version bit for bit at 16,384 query rows x 1M (a mid-run
              labelling), timed beside the plain version and a chunked
              ``torch.cdist`` yardstick, with the scan's share of its
              bound at both shapes; the pruning levers' size round by
              round (the share of pairs inside one component, and the
              share of the reduced shape's rows whose best j under round
              r's labelling lies in another component under round r + 1's,
              which keep (bw, bj): two reduced launches a pair of rounds,
              the kept rows checked unchanged); capped and fold held to
              theirs at the core pass's shape (8,192 of its queries; its
              largest repair); then the generator's first 10,000 points:
              the MST's sorted weights and total against a dense f64 Prim
              on the card (the "dual" engine's too), and ``hdbscan`` end to
              end.
   dual_join — ``dual_tree_knn`` on each engine, every query's ids
              against the f64 oracle (check_tree_knn): the tree engine on
              config 1's self-join (k=5; ``query_tree`` equal to it), the
              kernel engine on a 300k x 8 uniform self-join (seed 8, k=5;
              capped and fold), the leaf-pair sweep with 20,000 N(0,1) x 2
              points (seed 20) against config 1's tree at k=32 (its rounds
              and steps).
   The adapters and the utilities, each phase with its launches
   counted from zero and read after it:
   serialize — save_index and load_index on the card, one line a kind:
              brute (the SIFT index, right after vp_sift: the largest
              file, timed first), ball (the 1M x 2 device-built tree,
              config 1's queries), vantage (config 2's tree after its
              kernel-route queries, its flat tables in the file), dynamic
              (the d = 64 index below, its mutations pending).  Every
              array of the loaded index equals the saved one's bit for bit
              (and the flat index's prepared layout), and it answers its
              cell's queries with the same distances and ids bit for bit;
              save and load seconds and the file's bytes.  Files live in a
              temporary directory under build/ that the phase deletes.
   knn_route — ``bf.knn`` with backend "auto" on the SIFT points as users
              pass them, uncentred: all 10,240 queries at k=10 and 100
              (capped) and the first 2,048 at k=2000 (merge), fold repairs
              required; ids against the main phases' f64 oracles under the
              swap rule, QPS beside BruteForce's.  Then the fault the
              centring repairs: 5,000 x 64 N(10^4, 1) (seed 13), 300
              queries, k=5, on "auto" (the kernels) and "xla" (the scan):
              recall 1.0 against f64.
   sklearn  — ``NearestNeighbors(n_neighbors=10).fit`` on the SIFT points
              must take BruteForce; ``kneighbors`` at k=10 (bcap) and 100
              (capped) equal to ``query_batch`` bit for bit;
              ``kneighbors_graph``'s shape and nnz; ``radius_neighbors`` on
              the first 1,024 queries at radius_flat's r, counts equal to
              the mask's row sums except pairs within 2 ulp; config 1's
              ``kneighbors(X=None, n_neighbors=5)`` (the ball tree) with no
              row holding its own id, against the f64 oracle of k=6 less
              the point itself; config 4's ``radius_neighbors_graph`` at
              eps 0.05 against a plain count.  Seconds and QPS of each.
   serving  — a ``QueryStream`` over the SIFT index at k=10: 1,000 single
              submits flushed in groups of 1, 10, 100 and 1,000, equal bit
              for bit to one ``query_batch``'s rows; ms a query and
              launches a flush at each group size.
   profiling — ``utils.profiling.trace`` around one SIFT k=10
              ``query_batch``: the Chrome trace must name the bcap kernel;
              the traced kernels' time, and ``wall_time`` of the call.
   dynamic (d64) — a DynamicIndex at d = 64 off the origin: 180,000 rows
              of N(10^3, 1) (seed 16) build it, 20,000 are added, 2,000
              ids removed; 1,024 queries at k=10 must find the f64
              oracle's ids over the live rows exactly.
   examples — examples/torch_dbscan.py on config 4's points (eps 0.05,
              min_samples 10), torch_optics.py and torch_hdbscan_core.py
              on their own ``__main__`` data, each on the card and with
              device="cpu": the same core mask and partition of core
              points; the same ordering and reachability within f32; the
              same MST weights within f32 and the same labels.
   parallel — the sharded search (``petal_neighbors_tpu_torch.parallel``)
              at world size 1 on NCCL, through ``default_mesh()``:
              knn_query_sharded, knn_points_sharded and knn_ring (a 1 x 1
              mesh) on the SIFT points and all 10,240 queries at k=10 and
              100 (capped, fold repairs), knn_query_sharded on 2,048 at
              k=2000 and 3000 (merge, the bitonic and the rank sort), every
              distance equal to ``bf.knn``'s on the same inputs bit for
              bit, ids against the main phases' f64 oracles;
              knn_feature_sharded on 1,024 queries at k=10 against an f64
              oracle (distances within DIM * 2^-24 relative);
              tree_query_sharded on config 1's tree (k=2) equal to
              ``query_batch(scheme="per_query")``; both radius forms on
              1,024 queries at radius_flat's r, counts and cap 512, equal
              to ``radius_counts_streaming`` and ``radius_capped``;
              mutual_reachability_mst_sharded on hdbscan's 1M x 8 points,
              its sorted weights equal to the single-device MST's and its
              sum within 1e-6 of 186891.1277.  Each call's seconds, the
              launches of all of them (fold, capped, merge, both row sorts
              and mst_scan must run), beside the nvidia-smi line; then
              ``dryrun_multichip(4, device="cpu")`` (gloo: several ranks
              cannot share one card under NCCL), and on NCCL over every
              card where there are two or more.
9. kernels  — one JSON line: every kernel with its launches on its main
              path, error against its plain version, its time, the plain
              version's time, its bound and a PyTorch yardstick (fold: at
              its main path's largest repair, with the whole batch, its
              launches by path, the cutover and every repair shape beside
              it); its tier
              ("tc" for capped, bcap, merge and both minima kernels, whose
              bound is the tensor cores' six bf16 products, with the FP32
              SIMT bound beside it as simt_bound_ms; "fp32" for the
              others, with tc_bound_ms); fold and capped also carry
              vp_launches (the VP tree's "auto" runs, config 2 and SIFT)
              and vp (each kernel held to its plain version at those
              cells' shapes), and mst_launches (the HDBSCAN
              core pass and the join's kernel engine) and mst (held at the
              core pass's shape).  The scan kernel's row (mst_scan): its
              launches (one a round), ms a round at full width, its bound
              (2d + 6 FP32 instructions a pair at 33.5e12 a second), the
              plain version and the cdist yardstick at the reduced shape.
              fold, capped, bcap, merge and the row sorts also carry
              adapter_launches: their launches in knn_route, sklearn and
              serving;
              every row carries parallel_launches, its launches in phase
              parallel.

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when no CUDA card is present or any
phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, DIM, N_Q, SEED = 1_000_000, 128, 10_240, 7
#: the main path's requests and the scheme each must take
MAIN_K = {10: "bcap", 100: "capped", 200: "capped"}
#: the large-k path (bench.py:212-221): queries, requests and schemes
N_Q_LARGE = 2048
LARGE_K = {1000: "capped", 2000: "merge", 3000: "merge"}
#: boundary swaps against the f64 oracle allowed per 10^6 returned ids
SWAPS_PER_MILLION = 5
#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: FP32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
#: FP32 instructions per second on the SIMT lanes (one FFMA is 2 FLOP)
PEAK_FP32_INSTR_S = PEAK_FP32_FLOP_S / 2
#: bf16 dense on the tensor cores (H100 SXM data sheet)
PEAK_BF16_FLOP_S = 989e12
#: the kernels whose u comes from the split-bf16 tensor-core product: six
#: bf16 products per FP32 product
TC_SCHEMES = ("capped", "merge", "bcap")
TC_PRODUCTS = 6
KNN_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_fold.cu"
SELECT_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_select.cu"
SORT_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/row_sort.cu"
LP_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/lp_knn.cu"
MINIMA_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_minima.cu"
FEW_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/knn_few.cu"
SPLIT_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/split_planes.cu"
RESCORE_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/rescore.cu"
#: the opt-in schemes' requests on the SIFT index, in order
OPT_IN = (("bcap2", 10), ("bcap2", 100), ("two_phase", 10),
          ("fold_lazy", 10))
#: the JAX package's config 5, the GIST-1M shape (benchmarks/run.py:192-212)
GIST_N, GIST_D, GIST_Q, GIST_SEED, GIST_K = 1_000_000, 960, 1_000, 5, 10
#: config 5's indexes, built in this order, and the scheme each must take
GENERIC = (("euclidean", "capped"), ("cosine", "capped"), ("minkowski3", "lp"))
#: Minkowski-3 queries always held to the f64 oracle; the rest follow when
#: the first ones' oracle time projects all of them under ORACLE_BUDGET_S
LP_ORACLE_MIN_Q = 256
ORACLE_BUDGET_S = 60.0
REPLACES = {"fold": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:186",
            "fold_lazy": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:116",
            "subchunk_minima":
                "petal_neighbors_tpu/ops/pallas/knn_kernel.py:804",
            "bcap_minima": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:706",
            "capped": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:429",
            "bcap": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:546",
            "merge": "petal_neighbors_tpu/ops/pallas/knn_kernel.py:336",
            "bitonic_sort": "petal_neighbors_tpu/ops/pallas/sort_kernel.py:36",
            "rank_sort":
                "petal_neighbors_tpu/ops/pallas/rank_sort_kernel.py:48",
            "lp_knn": "petal_neighbors_tpu/ops/pallas/lp_kernel.py:111"}


def ptxas_summary(log: str) -> list:
    """``-Xptxas -v``'s lines per kernel: [entry, registers, spill stores,
    spill loads, stack frame bytes] for each compiled entry function."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = [m.group(1), None, None, None, None]
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                cur[4], cur[2], cur[3] = (int(x) for x in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur[1] = int(m.group(1))
    return out


def wgmma_notes(log: str) -> list:
    """ptxas's notes that it serialized a kernel's wgmma (its "Potential
    Performance Loss" lines, such as C7518 and C7520): [code, entry]
    each."""
    import re

    return [[m.group(1), m.group(2)] for m in re.finditer(
        r"\((C\d+)\) Potential Performance Loss: wgmma[^\n]*?serialized"
        r"[^\n]*?function '([^']+)'", log)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1, hold: bool = False) -> float:
    """Mean device milliseconds per call, by CUDA events over ``reps``.
    ``hold`` queues the launches behind a sleep of 2*10^7 cycles on the
    card (about 10 ms), so that a kernel shorter than its host-side launch
    is timed back to back and not at the rate the host launches it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n: int, q: int, d: int, k: int) -> tuple[float, str]:
    """Least time for a kernel's work: each input read once and each
    output written once (working set and threshold) over the memory rate,
    against 2*Q*N*d FP32 FLOP over the SIMT peak; the larger one bounds."""
    bytes_ = 4 * (n * d + n + q * d) + 8 * q * k + 4 * q
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = 2.0 * q * n * d / PEAK_FP32_FLOP_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tc_bound_ms(n: int, q: int, d: int, k: int) -> tuple[float, str]:
    """Least time for the same work on the tensor cores at the TPU's
    "highest" arithmetic: six bf16 products of 2*Q*N*d FLOP at the bf16
    dense peak, against the bytes of bound_ms; the larger one bounds."""
    bytes_ = 4 * (n * d + n + q * d) + 8 * q * k + 4 * q
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = TC_PRODUCTS * 2.0 * q * n * d / PEAK_BF16_FLOP_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def minima_bound_ms(n: int, q: int, d: int, rows: int,
                    tier: str = "fp32") -> tuple[float, str]:
    """Least time for a minima kernel's work: points, norms and queries
    read once and the (Q, ceil(N / rows)) minima written once over the
    memory rate, against 2*Q*N*d FP32 FLOP over the SIMT peak (tier
    "fp32"), or six bf16 products of it over the tensor cores' (tier
    "tc")."""
    bytes_ = 4 * (n * d + n + q * d) + 4 * q * -(-n // rows)
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = 2.0 * q * n * d * (TC_PRODUCTS / PEAK_BF16_FLOP_S
                               if tier == "tc" else 1 / PEAK_FP32_FLOP_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lp_instructions(spec) -> float:
    """FP32 instructions per (query, row, feature) of the Lp kernel's work
    (csrc/lp_knn.cu's table): FADD for the difference, then FADD or max
    with |.| (p=1, Chebyshev) or FMUL and FFMA (p=3)."""
    if spec.reduce == "max" or spec.p == 1.0:
        return 2.0
    if spec.p_int == 3:
        return 3.0
    raise ValueError(f"no instruction count for {spec}")


def lp_bound_ms(n: int, q: int, d: int, k: int, spec) -> tuple[float, str]:
    """Least time for the Lp kernel's work: points, mask and queries read
    once and the (rdist, id) output written once over the memory rate,
    against its instructions per element (lp_instructions) over the FP32
    issue rate; the larger one bounds."""
    bytes_ = 4 * (n * d + n + q * d) + 8 * q * k
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = lp_instructions(spec) * q * n * d / PEAK_FP32_INSTR_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lp_tolerance(d: int, spec) -> float:
    """Relative tolerance between the Lp kernel and its plain version: each
    sums d non-negative terms in its own order, each term rounded up to p
    times (the band (d + 2p) 2^-24 per side, twice); the non-integer power
    adds the SFU error of csrc/lp_knn.cu (about 1.4 p 2^-23 times
    |log2 |t||, up to 2^-14 for the smallest terms).  Chebyshev's max is
    exact."""
    if spec.reduce == "max":
        return 0.0
    tol = 2.0 * (d + 2.0 * spec.p) * 2.0 ** -24
    return tol + (2.0 ** -14 if spec.p_int is None else 0.0)


def compare_lp(pp, mask, qt, k: int, spec):
    """The Lp kernel against its plain version on the same card tensors.
    Returns (max_abs_err and max_rel_err over matched sorted rdist, rows
    whose ids differ between near-equal rdist, the plain version's ms).
    Kernel rows must come out ascending; finite slots, and the (+inf, -1)
    slots of NaN queries, must match; where a row's id sets differ, its
    differing ids, paired in rdist order, must lie within the tolerance
    of each other."""
    from petal_neighbors_tpu_torch.ops.cuda import lp_kernel as lk

    rd_k, id_k = lk.lp_knn(pp, mask, qt, k=k, spec=spec)
    torch.cuda.synchronize()
    if not bool((rd_k[:, 1:] >= rd_k[:, :-1]).all()):
        raise AssertionError(f"lp_knn {spec} k={k}: rows not ascending")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    rd_p, id_p = lk.lp_knn_reference(pp, mask, qt, k=k, spec=spec)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    fin = torch.isfinite(rd_p)
    if not torch.equal(fin, torch.isfinite(rd_k)) or not bool(
            (id_k[~fin] == -1).all()):
        raise AssertionError(f"lp_knn {spec} k={k}: finite slots differ")
    tol = lp_tolerance(pp.shape[1], spec)
    diff = torch.where(fin, (rd_k - rd_p).abs(), 0.0)
    band = tol * torch.where(fin, rd_p.abs(), 0.0)
    if bool((diff > band).any()):
        raise AssertionError(f"lp_knn {spec} k={k}: rdist off by "
                             f"{float((diff / rd_p.abs()).max())} relative")
    rel = float(torch.where(fin & (rd_p > 0), diff / rd_p, 0.0).max())
    nanq = torch.isnan(qt).any(dim=1)
    if bool((id_k[nanq] != -1).any()):
        raise AssertionError("lp_knn: a NaN query row picked up results")
    if bool((mask[id_k[id_k >= 0].long()] != 0).any()):
        raise AssertionError("lp_knn: a masked row was returned")
    tied = 0
    a, b = id_k.cpu().numpy(), id_p.cpu().numpy()
    rk, rp = rd_k.cpu().numpy(), rd_p.cpu().numpy()
    for r in np.flatnonzero((np.sort(a, 1) != np.sort(b, 1)).any(1)):
        sa, sb = set(a[r].tolist()), set(b[r].tolist())
        only_k = sorted(rk[r][list(a[r]).index(x)] for x in sa - sb)
        only_p = sorted(rp[r][list(b[r]).index(x)] for x in sb - sa)
        if len(only_k) != len(only_p) or any(
                abs(x - y) > tol * abs(y) for x, y in zip(only_k, only_p)):
            raise AssertionError(f"lp_knn {spec} k={k}: row {r} ids differ "
                                 "off the tie band")
        tied += 1
    return float(diff.max()), rel, tied, plain_ms


def lp_small_inputs(rng, n, q, d):
    """Uniform points and queries in [0, 1)^d with NaN rows (whole and
    partial), NaN queries and ten duplicated rows, on the card, padded by
    pad_for_lp to a ragged row count (no padding)."""
    from petal_neighbors_tpu_torch.ops.cuda.lp_kernel import pad_for_lp

    pts, qs = small_inputs(rng, n, q, d)
    pp, mask = pad_for_lp(torch.from_numpy(pts / 255.0).float().cuda(), tn=1)
    return pp, mask, torch.from_numpy(qs / 255.0).float().cuda()


#: (n, q, d) of the Lp kernel's small shapes: d = 33 and 130 on the scalar
#: loads (130 and 960 in feature chunks, 960 the main width), 70,001 rows
#: split into row ranges
LP_SHAPES = ((5003, 130, 33), (4099, 70, 48), (3001, 200, 130),
             (4500, 70, 960), (70001, 130, 64))
LP_SPECS = ((1.0, "sum"), (2.5, "sum"), (3.0, "sum"), (4.0, "sum"),
            (1.0, "max"))
LP_KS = (1, 10, 100, 1024, 1100, 4096)


def phase_lp_small():
    """The Lp kernel against its plain version at every small shape, p and
    k; returns the largest absolute error."""
    from petal_neighbors_tpu_torch.ops.cuda import lp_kernel as lk

    rng = np.random.default_rng(2)
    worst = 0.0
    for n, q, d in LP_SHAPES:
        pp, mask, qt = lp_small_inputs(rng, n, q, d)
        for p, reduce in LP_SPECS:
            spec = lk.LpSpec(p, reduce)
            for k in LP_KS:
                if k > n:
                    continue
                err, rel, tied, _ = compare_lp(pp, mask, qt, k, spec)
                worst = max(worst, err)
                emit("kernel", name="lp_knn", n=n, q=q, d=d, p=p,
                     reduce=reduce, k=k, max_abs_err=err, max_rel_err=rel,
                     tol_rel=lp_tolerance(d, spec), tied_rows=tied,
                     splits=lk.lp_plan(spec, n, q, d), ok=True)
    return worst


def chunked_topk(scores, n: int, k: int, chunk: int, block: int = 1):
    """The k smallest of ``scores(s, e)`` (Q, (e - s) / block) over row
    chunks [s, e) of [0, n), each chunk's ``torch.topk`` merged into the
    running one; ids count in units of ``block`` rows."""
    best_d = best_i = None
    for s in range(0, n, chunk):
        u = scores(s, min(n, s + chunk))
        vd, vi = torch.topk(u, min(k, u.shape[1]), dim=1, largest=False)
        vi = vi + s // block
        if best_d is not None:
            vd, pos = torch.topk(torch.cat([best_d, vd], 1), k, dim=1,
                                 largest=False)
            vi = torch.gather(torch.cat([best_i, vi], 1), 1, pos)
        best_d, best_i = vd, vi
    return best_d, best_i


def library_topk(points, queries, norms, k: int, block: int = 1):
    """Yardstick: the same top-k of u (of 16-row block minima of u when
    ``block`` > 1) by a chunked ``torch.matmul`` plus ``torch.topk`` and a
    merge — cuBLAS, timed here and used nowhere in the port."""
    def scores(s, e):
        u = norms[s:e][None, :] - 2.0 * (queries @ points[s:e].T)
        return u if block == 1 else u.reshape(u.shape[0], -1, block).amin(2)
    return chunked_topk(scores, points.shape[0], k, 65536, block)


def _run(scheme: str, plain: bool, pp, qt, pn, k: int, tile: int,
         passes: int, splits: int = 1, planes=None):
    """One call of a scheme's kernel (or, with ``plain``, its plain
    version); the tensor-core kernels read ``planes``, the points' piece
    planes as an index holds them (split per call when None)."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    if scheme in FOLD_SCHEMES:
        if plain:
            return kk.knn_fold_reference(pp, qt, pn, k=k) + (None,)
        return kk.knn_fold(pp, qt, pn, k=k,
                           path=FOLD_SCHEMES[scheme]) + (None,)
    if scheme in ("fold", "fold_lazy", "merge"):
        run = {("fold", True): kk.knn_fold_reference,
               ("fold", False): kk.knn_fold,
               ("fold_lazy", True): kk.knn_fold_lazy_reference,
               ("fold_lazy", False): kk.knn_fold_lazy,
               ("merge", True): kk.knn_merge_reference,
               ("merge", False): kk.knn_merge}[scheme, plain]
        kw = {"point_planes": planes} if (scheme, plain) == ("merge",
                                                             False) else {}
        return run(pp, qt, pn, k=k, **kw) + (None,)
    if plain:
        ref = (kk.knn_capped_reference if scheme == "capped"
               else kk.knn_bcap_reference)
        return ref(pp, qt, pn, k=k, tile=tile, passes=passes, splits=splits)
    run = kk.knn_capped if scheme == "capped" else kk.knn_bcap
    return run(pp, qt, pn, k=k, tile=tile, passes=passes,
               point_planes=planes)


def compare_kernel(scheme: str, pp, qt, pn, k: int, tile: int = 1,
                   passes: int = 0, tier_band: bool = False):
    """Kernel vs plain version on the same card tensors and the same launch
    plan.  Returns (max_abs_err over matched sorted rdist and thresholds,
    rows whose ids differ between near-equal rdist, the plan).

    Tolerance: the two sum the d-term dot product in different orders, so
    a score may differ by the f32 accumulation bound d*2^-24*(‖q‖²+‖x‖²)
    (the accumulation term of the FP32 tier's bound); sorted rdist and
    thresholds must agree within twice that.  Where a row's id sets
    differ, its differing ids, paired in rdist order, must lie within that
    band of each other: near ties may fall either way, in the capped and
    bcap schemes also at a pass's `u < tau` test.

    ``tier_band`` takes instead twice the proof bound of the tier that
    made the scores (``tc_proof_err`` for capped, bcap and merge,
    ``fp32_err`` for the folds): each side lies within it of the exact
    score.
    It also covers the fixed roundings (‖x‖² − 2q·x, + ‖q‖²) and the six
    products a feature of the tensor-core tier, which the accumulation
    term alone leaves out at small d (d = 2: the VP tree's config 2)."""
    from petal_neighbors_tpu_torch.ops.cuda.knn_kernel import (
        few_plan, kernel_plan, tc_proof_err)

    if scheme == "fold_few":
        plan = (few_plan(pp.shape[0], qt.shape[0], pp.shape[1], k)["splits"],
                True)
    else:
        plan = kernel_plan("fold" if scheme == "fold_stream" else scheme,
                           pp.shape[0], qt.shape[0], pp.shape[1], k, tile)
    rd_k, id_k, t_k = _run(scheme, False, pp, qt, pn, k, tile, passes)
    torch.cuda.synchronize()
    if scheme in ("merge", "fold_select") and not bool(
            (rd_k[:, 1:] >= rd_k[:, :-1]).all()):
        raise AssertionError(f"{scheme} k={k}: rows not ascending")
    rd_p, id_p, t_p = _run(scheme, True, pp, qt, pn, k, tile, passes,
                           plan[0])
    rd_k, ord_k = torch.sort(rd_k, dim=1)
    id_k = torch.gather(id_k, 1, ord_k)
    rd_p, ord_p = torch.sort(rd_p, dim=1)
    id_p = torch.gather(id_p, 1, ord_p)
    xn_max = torch.where(torch.isfinite(pn), pn, 0.0).max()
    qn = torch.sum(qt * qt, dim=1)
    band = 2.0 * pp.shape[1] * 2.0 ** -24 * (qn + xn_max)
    if tier_band:
        tier_err = tc_proof_err if scheme in TC_SCHEMES else fp32_err
        band = 2.0 * tier_err(pp.shape[1], qn, xn_max)
    fin = torch.isfinite(rd_p)
    if not torch.equal(fin, torch.isfinite(rd_k)):
        raise AssertionError(f"{scheme} k={k}: finite slots differ")
    diff = torch.where(fin, (rd_k - rd_p).abs(), 0.0)
    if bool((diff > band[:, None]).any()):
        raise AssertionError(f"{scheme} k={k}: rdist off by "
                             f"{float(diff.max())}")
    err = float(diff.max())
    nanq = torch.isnan(qt).any(dim=1)
    if bool((id_k[nanq] != -1).any()) or bool(torch.isfinite(rd_k[nanq]).any()):
        raise AssertionError(f"{scheme}: a NaN query row picked up results")
    if t_k is not None:
        if not torch.equal(torch.isnan(t_k), nanq) or not torch.equal(
                torch.isnan(t_p), nanq):
            raise AssertionError(f"{scheme}: NaN thresholds off NaN queries")
        tf = torch.isfinite(t_p) & ~nanq
        if not torch.equal(tf, torch.isfinite(t_k) & ~nanq):
            raise AssertionError(f"{scheme}: finite thresholds differ")
        tdiff = torch.where(tf, (t_k - t_p).abs(), 0.0)
        if bool((tdiff > band).any()):
            raise AssertionError(f"{scheme} k={k}: thr off by "
                                 f"{float(tdiff.max())}")
        err = max(err, float(tdiff.max()))
    tied_rows = 0
    a, b = id_k.cpu().numpy(), id_p.cpu().numpy()
    rk, rp = rd_k.cpu().numpy(), rd_p.cpu().numpy()
    bnd = band.cpu().numpy()
    for r in np.flatnonzero((np.sort(a, 1) != np.sort(b, 1)).any(1)):
        sa, sb = set(a[r].tolist()), set(b[r].tolist())
        if sa == sb:
            continue
        only_k = sorted(rk[r][list(a[r]).index(x)] for x in sa - sb)
        only_p = sorted(rp[r][list(b[r]).index(x)] for x in sb - sa)
        if len(only_k) != len(only_p) or any(
                abs(x - y) > bnd[r] for x, y in zip(only_k, only_p)):
            raise AssertionError(f"{scheme} k={k}: row {r} ids differ "
                                 "off the tie band")
        tied_rows += 1
    return err, tied_rows, plan


def lazy_is_fold(pp, qt, pn, k: int, path=None) -> int:
    """fold_lazy against fold (its ``path``, "select" or "stream", or the
    one ``fold_path`` picks) on the same card tensors: sorted rdist equal
    bit for bit, and ids equal as sets except for ids at a row's largest
    rdist (the last block of a query tile to arrive folds the other row
    ranges in, and the select keeps the smaller ids, so exact ties at the
    k-th value may fall either way).  Returns the rows whose ids differ at
    such a tie."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    rd_l, id_l = kk.knn_fold_lazy(pp, qt, pn, k=k)
    rd_f, id_f = kk.knn_fold(pp, qt, pn, k=k, path=path)
    torch.cuda.synchronize()
    if not torch.equal(torch.sort(rd_l, 1).values, torch.sort(rd_f, 1).values):
        raise AssertionError(f"fold_lazy k={k}: rdist differ from fold's")
    tied = 0
    a, b = id_l.cpu().numpy(), id_f.cpu().numpy()
    ra, rb = rd_l.cpu().numpy(), rd_f.cpu().numpy()
    for r in np.flatnonzero((np.sort(a, 1) != np.sort(b, 1)).any(1)):
        diff = set(a[r].tolist()) ^ set(b[r].tolist())
        at = {**dict(zip(b[r].tolist(), rb[r])), **dict(zip(a[r].tolist(),
                                                            ra[r]))}
        if any(at[x] != ra[r].max() for x in diff):
            raise AssertionError(f"fold_lazy k={k}: row {r} ids differ "
                                 "from fold's off a tie")
        tied += 1
    return tied


def compare_minima(kind: str, pp, qt, pn) -> tuple[float, float]:
    """A minima kernel against its plain version on the same card tensors:
    NaN (NaN queries) and +inf (all-padding blocks) in the same places,
    and the rest within the f32 accumulation band 2*d*2^-24*(‖q‖² + max
    ‖x‖²) of a row (the two sum the dot product in different orders).
    Returns (max abs error, the plain version's ms)."""
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    fn, plain = {"subchunk": (mk.subchunk_minima,
                              mk.subchunk_minima_reference),
                 "block": (mk.bcap_minima, mk.bcap_minima_reference)}[kind]
    got = fn(pp, qt, pn)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(pp, qt, pn)
    stop.record()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{kind} minima: shape {tuple(got.shape)}, "
                             f"want {tuple(want.shape)}")
    nanq = torch.isnan(qt).any(dim=1)
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and bool(torch.isnan(got[nanq]).all())
            and torch.equal(torch.isposinf(got), torch.isposinf(want))):
        raise AssertionError(f"{kind} minima: NaN or +inf columns differ")
    fin = torch.isfinite(want)
    xn_max = torch.where(torch.isfinite(pn), pn, 0.0).max()
    band = 2.0 * pp.shape[1] * 2.0 ** -24 * (torch.sum(qt * qt, 1) + xn_max)
    diff = torch.where(fin, (got - want).abs(), 0.0)
    if bool((diff > torch.nan_to_num(band)[:, None]).any()):
        raise AssertionError(f"{kind} minima: off by {float(diff.max())}")
    return float(diff.max()), start.elapsed_time(stop)


def subchunk_is_block(pp, qt, pn) -> int:
    """The subchunk minima against the block minima on the same card
    tensors: each subchunk column equal, bit for bit, to the min.NaN of
    the 8 block-minima columns it covers (the last subchunk's missing
    blocks +inf).  Both come from tc::scan_minima's one product, so this
    holds whatever the row ranges.  Returns the columns compared."""
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    sub = mk.subchunk_minima(pp, qt, pn)
    blk = mk.bcap_minima(pp, qt, pn)
    per = mk.SUBCHUNK // mk.BCAP_BLOCK
    blk = torch.nn.functional.pad(blk, (0, sub.shape[1] * per - blk.shape[1]),
                                  value=float("inf"))
    want = blk.reshape(blk.shape[0], -1, per).amin(2)   # amin keeps NaN
    torch.cuda.synchronize()
    if not torch.equal(sub.view(torch.int32), want.view(torch.int32)):
        bad = int((sub.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"subchunk minima: {bad} columns differ from "
                             "the min of the block minima")
    return sub.numel()


def library_minima(points, queries, norms, rows: int):
    """Yardstick: the same minima by a chunked ``torch.matmul`` and
    ``amin`` over ``rows``-row blocks (cuBLAS), timed here and used nowhere
    in the port."""
    n, nq = points.shape[0], queries.shape[0]
    parts = []
    for s in range(0, n, 65536):
        u = norms[s:s + 65536][None, :] - 2.0 * (queries @ points[s:s + 65536].T)
        short = -u.shape[1] % rows
        if short:
            u = torch.nn.functional.pad(u, (0, short), value=float("inf"))
        parts.append(u.reshape(nq, -1, rows).amin(2))
    return torch.cat(parts, 1)


#: (n, q, d, pad rows) of the minima kernels' small shapes: row counts no
#: multiple of 16 or 128 (tn=1: no padding), d = 17 and 130 on the scalar
#: loads (130 in two feature chunks), d = 960 (the block minima stream
#: their query planes), 70,001 rows split into row ranges
MINIMA_CASES = ((5003, 301, 128, 1), (4099, 130, 130, 1), (3001, 70, 17, 1),
                (70001, 300, 64, 64), (70001, 200, 128, 1), (1, 3, 8, 1),
                (4099, 130, 960, 1))


def phase_minima_small(rng):
    """Both minima kernels against their plain versions at every small
    shape; returns the largest absolute error of each."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda.minima_kernel import minima_plan

    worst = {"subchunk_minima": 0.0, "bcap_minima": 0.0}
    for n, q, d, tn in MINIMA_CASES:
        pts, qs = small_inputs(rng, n, q, d)
        spp, spn = bf.pad_for_pallas(torch.from_numpy(pts).cuda(), tn=tn)
        qt = torch.from_numpy(qs).cuda()
        for kind, name in (("subchunk", "subchunk_minima"),
                           ("block", "bcap_minima")):
            err, _ = compare_minima(kind, spp, qt, spn)
            worst[name] = max(worst[name], err)
            extra = ({"subchunk_is_block": subchunk_is_block(spp, qt, spn)}
                     if kind == "subchunk" else {})
            emit("kernel", name=name, n=spp.shape[0], q=q, d=d,
                 max_abs_err=err,
                 splits=minima_plan(kind, spp.shape[0], q, d), **extra,
                 ok=True)
    return worst


def bcap_is_minima(pp, qt, pn, k: int, tile: int, passes: int) -> int:
    """bcap's block-min rdist at its returned ids against the rdist made
    from the block-minima kernel's columns at the same ids (‖q‖² added by
    csrc/knn_select.cu's fold_out kernel, as csrc/knn_fold.cu adds it):
    equal bit for bit, both from one tensor-core epilogue.  Returns the
    ids compared."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    rd, ids, _ = kk.knn_bcap(pp, qt, pn, k=k, tile=tile, passes=passes)
    minima = mk.bcap_minima(pp, qt, pn)
    got = ids >= 0
    u = torch.where(got, torch.gather(minima, 1, ids.clamp_min(0).long()),
                    torch.inf).contiguous()
    ids = ids.contiguous()
    qt = qt.contiguous()
    err = kk._select_lib().knn_select_fold_out_launch(
        qt.data_ptr(), u.data_ptr(), ids.data_ptr(), qt.shape[0],
        qt.shape[1], k, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"fold_out launch failed: cudaError {err}")
    if not torch.equal(rd[got].view(torch.int32), u[got].view(torch.int32)):
        bad = int((rd[got].view(torch.int32) != u[got].view(torch.int32))
                  .sum())
        raise AssertionError(f"bcap k={k}: {bad} block-min rdist differ "
                             "from the block minima's")
    return int(got.sum())


def small_inputs(rng, n, q, d):
    """Uniform points and queries in [0, 255)^d with NaN rows (whole and
    partial), NaN queries and ten duplicated rows (exact ties), where the
    shape has room for them."""
    pts = (rng.random((n, d), dtype=np.float32) * 255.0).astype(np.float32)
    qs = (rng.random((q, d), dtype=np.float32) * 255.0).astype(np.float32)
    if n >= 100:
        pts[[3, 77, n - 2]] = np.nan
        pts[11, d // 2] = np.nan
        pts[20:30] = pts[20]
    if q >= 8:
        qs[[0, q - 1]] = np.nan
        qs[5, d // 2] = np.nan
    return pts, qs


#: (scheme, n, q, d, pad rows, k, tile, passes): tn=1 keeps N ragged for
#: the kernel itself; d=5, 17, 130 and 257 run the scalar-load path (130 and
#: 257 in feature chunks); n=1 with k above n; the 70,001-row shapes split
#: the rows (working set in shared and in global memory).  fold_lazy's
#: 128-query x 128-row block also at q = 1, 127, 129 and 300, d = 960
#: (query chunks in the ring; working set in shared memory at k=18, in
#: global memory at k=1024) and k = 1, 18, 33 and 1024
SMALL_CASES = (
    ("fold", 5003, 301, 128, 1, 18, 1, 0),
    ("fold", 5003, 301, 128, 64, 108, 1, 0),
    ("fold", 4099, 130, 130, 1, 40, 1, 0),
    ("fold", 3001, 70, 257, 1, 33, 1, 0),
    ("fold", 700, 64, 5, 1, 9, 1, 0),
    ("fold", 1, 3, 8, 1, 4, 1, 0),
    ("fold", 70001, 300, 128, 1, 18, 1, 0),
    ("fold", 70001, 200, 128, 64, 1024, 1, 0),
    ("fold_lazy", 5003, 301, 128, 1, 18, 1, 0),
    ("fold_lazy", 4099, 130, 130, 1, 1, 1, 0),
    ("fold_lazy", 3001, 70, 17, 1, 33, 1, 0),
    ("fold_lazy", 70001, 300, 128, 1, 18, 1, 0),
    ("fold_lazy", 70001, 200, 64, 64, 1024, 1, 0),
    ("fold_lazy", 5003, 1, 128, 1, 18, 1, 0),
    ("fold_lazy", 9001, 127, 128, 1, 1024, 1, 0),
    ("fold_lazy", 70001, 129, 960, 1, 18, 1, 0),
    ("fold_lazy", 4099, 300, 960, 1, 1024, 1, 0),
    ("fold_lazy", 70001, 129, 17, 1, 1, 1, 0),
    ("capped", 5003, 301, 128, 1, 18, 512, 2),
    ("capped", 5003, 301, 128, 64, 108, 512, 0),
    ("capped", 4099, 130, 130, 1, 40, 1024, 4),
    ("capped", 3001, 70, 257, 1, 33, 64, 15),
    ("capped", 700, 64, 5, 1, 9, 64, 1),
    ("capped", 70001, 300, 128, 1, 18, 4096, 2),
    ("capped", 70001, 200, 128, 64, 1024, 2048, 4),
    ("bcap", 5003, 301, 128, 1, 18, 32, 2),
    ("bcap", 5003, 301, 128, 64, 4, 4, 0),
    ("bcap", 4099, 130, 130, 1, 40, 64, 4),
    ("bcap", 3001, 70, 257, 1, 33, 128, 15),
    ("bcap", 700, 64, 5, 1, 9, 12, 1),
    ("bcap", 70001, 300, 128, 1, 18, 128, 2),
    ("bcap", 70001, 200, 128, 64, 256, 256, 4),
    ("bcap", 4099, 130, 960, 1, 18, 128, 2),
    ("merge", 1203, 301, 128, 1, 1100, 1, 0),
    ("merge", 2100, 130, 130, 1, 2048, 1, 0),
    ("merge", 4200, 70, 64, 64, 4096, 1, 0),
    ("merge", 70001, 300, 128, 1, 3000, 1, 0),
)

#: fold's two paths, forced, as compare_kernel's schemes
FOLD_PATHS = {"fold_select": "select", "fold_stream": "stream"}
#: compare_kernel's names of fold's paths, the few-query kernel's too
FOLD_SCHEMES = dict(FOLD_PATHS, fold_few="few")
#: fold's two paths against the plain version and each other at small
#: shapes, on both sides of the cutover: (n, q, d, pad rows, k, points).
#: "uniform" as small_inputs makes them (NaN rows, NaN queries from q = 8,
#: ten duplicated rows; 700 rows at k=1008: k above the finite rows);
#: "duplicates" 50 distinct integer rows and "five rows" 5
#: (duplicate_inputs); on five rows about a fifth of the rows share the
#: least u, so collect narrows over several passes
FOLD_PATH_CASES = (
    (5003, 1, 128, 1, 18, "uniform"),
    (5003, 5, 128, 1, 1, "uniform"),
    (4099, 64, 130, 1, 108, "uniform"),
    (70001, 65, 128, 1, 1008, "uniform"),
    (70001, 300, 64, 64, 1024, "uniform"),
    (3001, 5, 17, 1, 1024, "uniform"),
    (700, 64, 128, 1, 1008, "uniform"),
    (20000, 65, 64, 1, 108, "duplicates"),
    (20000, 5, 64, 1, 1008, "five rows"),
)
#: the table both fold paths are timed on, from which
#: knn_kernel.FOLD_SELECT_Q was read: (queries, k_scan values) per shape
FOLD_TABLE = {"SIFT": ((1, 5, 47, 56, 187, 512, 2048, 10240),
                       (18, 108, 208, 1008)),
              "GIST": ((1, 2, 8, 64), (18, 108, 208, 1008))}
#: the route's fold repairs (repaired queries, k_scan; PERF.md §5), with
#: the library call and the bound beside both paths
REPAIR_SHAPES = (("SIFT", 5, 18), ("SIFT", 187, 108), ("SIFT", 47, 208),
                 ("SIFT", 56, 1008), ("GIST", 1, 18), ("GIST", 2, 18))
#: the repair the kernels line reports for fold: the largest of the main
#: phase's (k=100)
FOLD_MAIN_REPAIR = ("SIFT", 187, 108)

#: the main paths' kernel calls: (scheme, k requested, queries).  fold at
#: k=200 is the repair kernel of the main path, timed on the whole batch
MAIN_CALLS = (("bcap", 10, N_Q), ("capped", 100, N_Q), ("capped", 200, N_Q),
              ("fold", 200, N_Q), ("fold_lazy", 10, N_Q),
              ("capped", 1000, N_Q_LARGE),
              ("merge", 2000, N_Q_LARGE), ("merge", 3000, N_Q_LARGE))
#: the row each kernel reports in the kernels line
MAIN_ROW = {"bcap": 10, "capped": 100, "fold": 200, "merge": 3000,
            "fold_lazy": 10}
#: row sorts: (kind, (rows, width) shapes checked and timed, the main
#: shape of the kernels line): the widths of k=1000, k=2000 and bcap2
#: k=100 (bitonic), of k=3000 and up to k_scan 4096 (rank)
SORTS = (("bitonic_sort", ((N_Q_LARGE, 1008), (N_Q_LARGE, 2048), (N_Q, 256)),
          (N_Q_LARGE, 2048)),
         ("rank_sort", ((N_Q_LARGE, 2176), (N_Q_LARGE, 3072),
                        (N_Q_LARGE, 4096)), (N_Q_LARGE, 3072)))
#: widths at which both entry points are held to a stable sort on the edge
#: rows, 1 to the widest row taken
SORT_EDGE_WIDTHS = (1, 2, 3, 255, 256, 257, 1008, 2048, 3072, 4097, 8192)
#: requests whose row-sort inputs are captured from the route and timed:
#: (label, forced scheme or None for the index's own route, k, queries)
ROUTE_SORTS = (("capped k=1000", None, 1000, N_Q_LARGE),
               ("merge k=2000", None, 2000, N_Q_LARGE),
               ("merge k=3000", None, 3000, N_Q_LARGE),
               ("bcap2 k=100", "bcap2", 100, N_Q))


def kernel_args(scheme: str, k_req: int, n_real: int):
    """(k, tile, passes) of a scheme's kernel call, as knn_prepadded makes
    it."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    k_scan = bf.scan_width(scheme, k_req, n_real)
    if scheme == "bcap":
        k, tile = max(k_scan, 12), bf.BCAP_TILE
        return k, tile, bf.capped_passes(k, tile * 16, n_real, scheme)
    if scheme == "capped":
        return (k_scan, bf.CAPPED_TILE,
                bf.capped_passes(k_scan, bf.CAPPED_TILE, n_real, scheme))
    return k_scan, 1, 0


def tier_bounds(scheme: str, n: int, q: int, d: int, k: int) -> dict:
    """A u-domain kernel's bounds: its own tier's (bound_ms, bound_by) and
    the other tier's beside it (simt_bound_ms for the tensor-core kernels,
    tc_bound_ms for the FP32 ones), with the peaks they assume."""
    simt, simt_by = bound_ms(n, q, d, k)
    tcb, tc_by = tc_bound_ms(n, q, d, k)
    if scheme in TC_SCHEMES:
        return dict(tier="tc", bound_ms=tcb, bound_by=tc_by,
                    simt_bound_ms=simt,
                    peak="bf16 dense 989 TFLOP/s x 6 products and HBM 3.35 "
                         "TB/s, H100 SXM data sheet")
    return dict(tier="fp32", bound_ms=simt, bound_by=simt_by,
                tc_bound_ms=tcb,
                peak="FP32 non-tensor 67 TFLOP/s and HBM 3.35 TB/s, H100 SXM "
                     "data sheet")


def phase_tc_probe() -> float:
    """The tensor-core tier's integrity probe (knn_kernel.tc_probe): the
    largest |u - u_f64| over its bound, which must stay at or below 1 (the
    probe raises otherwise)."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    ratio = kk.tc_probe()
    if not ratio <= 1.0:
        raise AssertionError(f"tc_probe: error {ratio} times the bound")
    emit("tc_probe", max_err_over_bound=ratio, dims=list(kk._PROBE_DIMS),
         bound="(4 + 12 ceil(d/16)) 2^-23 (|q|^2 + max |x|^2)",
         tile=kk.tc_tile(), ok=True)
    return ratio


#: the planes' build at the benchmark's index shapes (SIFT, GIST, GloVe)
#: and one call's query batch: (name, rows, d)
PLANE_SHAPES = (("sift", 1_000_000, 128), ("gist", 1_000_000, 960),
                ("glove", 1_183_514, 100), ("queries", 10_240, 128))


def phase_planes() -> dict:
    """The tensor-core core's piece planes (``tc_planes.split_planes``,
    ``csrc/split_planes.cu``) at the index shapes of the benchmark's
    configurations and at one batch of queries: the split's device time
    beside its plain version's on the card, the planes' bytes beside the
    float32 rows', its byte bound (float32 read and planes written once at
    3.35 TB/s), and its first and last tiles against the plain version
    byte for byte.  At the GIST shape, ``functional_knn_cost``.  Returns
    the rows by shape."""
    from petal_neighbors_tpu_torch.ops.cuda import tc_planes as tp

    out = {}
    for name, rows, d in PLANE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(rows + d)
        x = torch.rand((rows, d), generator=g, device="cuda") * 255.0 - 127.5
        planes = tp.split_planes(x)
        ms = cuda_ms(lambda: tp.split_planes(x), reps=5)
        plain = cuda_ms(lambda: tp.split_planes_reference(x), reps=1,
                        warm=0)
        for rs in (slice(0, 256), slice((rows - 1) // 128 * 128, rows)):
            want = tp.split_planes_reference(x[rs].cpu()).view(torch.int16)
            t0 = rs.start // 128
            got = planes[t0:t0 + want.shape[0]].cpu()
            if not torch.equal(got.view(torch.int16), want):
                raise AssertionError(f"split_planes {name}: rows {rs} differ "
                                     "from the plain version")
        f32 = rows * d * 4
        nbytes = planes.numel() * 2
        out[name] = dict(rows=rows, d=d, ms=ms, plain_ms=plain,
                         planes_bytes=nbytes, f32_bytes=f32,
                         ratio=nbytes / f32,
                         bound_ms=(f32 + nbytes) / PEAK_BYTES_S * 1e3)
        emit("planes", shape=name, **out[name], plain_equal=True)
        del planes
        if name == "gist":
            functional_knn_cost(x)
        del x
        torch.cuda.empty_cache()
    return out


def functional_knn_cost(x) -> None:
    """What one call of the functional ``knn()`` costs over the rows ``x``
    (GIST's shape) with GIST_Q queries at k = GIST_K, beside a
    ``BruteForce`` index of the same rows: host time of a call after a
    warm one, the device memory it takes above its inputs at its peak
    (``max_memory_allocated``), and the rows ``split_planes`` splits in
    it.  The functional call centres, pads and splits its rows each time;
    the index did that at build."""
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.utils import profiling

    q = x[:GIST_Q] + 0.5
    row = {}
    for name, call in (("functional", lambda: bf.knn(x, q, GIST_K)),
                       ("index", None)):
        if call is None:
            index = pt.BruteForce(x)
            call = lambda: index.query_batch(q, GIST_K)
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        split0 = profiling.counters().get("knn.planes_split", 0)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        row[name] = {"s": time.perf_counter() - t0,
                     "peak_above_inputs_bytes":
                         torch.cuda.max_memory_allocated() - base,
                     "rows_split": profiling.counters().get(
                         "knn.planes_split", 0) - split0}
    row["index"]["held_bytes"] = (index._pts.numel() * 4
                                  + index._planes.numel() * 2)
    del index
    emit("planes", shape="gist", call="knn", queries=GIST_Q, k=GIST_K, **row)


def merge_edge_inputs(kind: str, rng):
    """Merge's edge rows: (points, queries, k).  'all equal': one row
    repeated (every u of a query equal: ids 0..k-1 in order); 'duplicates':
    integer rows drawn from 50 distinct ones (many exact ties; integers
    below 16 make every product exact, so u is the same bits in the kernel
    and the plain version); '+inf tail': 40% NaN rows and k above the
    finite rows; 'k above n': 1,000 rows at k=4096."""
    if kind == "all equal":
        pts = np.repeat(rng.random((1, 64), dtype=np.float32), 6000, 0)
        return pts, rng.random((70, 64), dtype=np.float32), 4096
    if kind == "duplicates":
        base = rng.integers(0, 16, (50, 64)).astype(np.float32)
        pts = base[rng.integers(0, 50, 20000)]
        return pts, rng.integers(0, 16, (130, 64)).astype(np.float32), 3000
    if kind == "+inf tail":
        pts = rng.random((5000, 128), dtype=np.float32)
        pts[rng.random(5000) < 0.4] = np.nan
        return pts, rng.random((70, 128), dtype=np.float32), 4096
    pts = rng.random((1000, 128), dtype=np.float32)
    return pts, rng.random((70, 128), dtype=np.float32), 4096


MERGE_EDGES = ("all equal", "duplicates", "+inf tail", "k above n")


def phase_merge_edges() -> float:
    """Merge on its edge rows against its plain version on the card
    (compare_kernel), plus: ids 0..k-1 in order where all rows are equal,
    ids equal exactly where the products are exact (duplicates), and
    (+inf, -1) past the finite rows.  Returns the largest error."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    rng = np.random.default_rng(4)
    worst = 0.0
    for kind in MERGE_EDGES:
        pts, qs, k = merge_edge_inputs(kind, rng)
        spp, spn = bf.pad_for_pallas(torch.from_numpy(pts).cuda(), tn=1)
        qt = torch.from_numpy(qs).cuda()
        err, tied, plan = compare_kernel("merge", spp, qt, spn, k)
        worst = max(worst, err)
        rd, ids = kk.knn_merge(spp, qt, spn, k=k)
        passes = list(kk.knn_merge.last_passes)
        n_fin = int(torch.isfinite(spn).sum())
        if kind == "all equal" and not torch.equal(
                ids, torch.arange(k, dtype=torch.int32,
                                  device=ids.device).expand_as(ids)):
            raise AssertionError("merge all equal: ids not 0..k-1 in order")
        if kind == "duplicates":
            _, want = kk.knn_merge_reference(spp, qt, spn, k=k)
            if not torch.equal(ids, want):
                raise AssertionError("merge duplicates: ids differ from the "
                                     "plain version's (u, id) order")
        if n_fin < k and not (bool((ids[:, n_fin:] == -1).all())
                              and bool(torch.isinf(rd[:, n_fin:]).all())
                              and bool((ids[:, :n_fin] >= 0).all())):
            raise AssertionError(f"merge {kind}: no (+inf, -1) tail past "
                                 f"the {n_fin} finite rows")
        emit("kernel", name="knn_merge", edge=kind, n=spp.shape[0],
             q=qt.shape[0], k=k, finite_rows=n_fin, max_abs_err=err,
             tied_rows=tied, radix_passes=passes, plan=plan, ok=True)
    return worst


def duplicate_inputs(rng, n, q, d, distinct: int = 50):
    """Points drawn from ``distinct`` integer rows below 16 and integer
    queries (every product exact, so u is the same bits in the kernels and
    the plain version, and each u value is shared by about n / distinct
    rows), with two NaN rows and, from q = 8, a NaN query."""
    base = rng.integers(0, 16, (distinct, d)).astype(np.float32)
    pts = base[rng.integers(0, distinct, n)]
    qs = rng.integers(0, 16, (q, d)).astype(np.float32)
    pts[[3, n - 2]] = np.nan
    if q >= 8:
        qs[q - 1] = np.nan
    return pts, qs


def phase_fold_paths_small(rng) -> float:
    """fold's two paths, each forced, against the plain version
    (compare_kernel) at every FOLD_PATH_CASES shape, and against each
    other: sorted rdist equal bit for bit (the same u and the same ‖q‖²
    sum); on integer rows the select's ids equal the plain version's (both
    keep ties in id order); fold_lazy equal to both (lazy_is_fold).
    Prints the select's collect passes.  Returns the largest error."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    dev = torch.device("cuda")
    worst = 0.0
    for n, q, d, tn, k, kind in FOLD_PATH_CASES:
        if kind == "uniform":
            pts, qs = small_inputs(rng, n, q, d)
        else:
            pts, qs = duplicate_inputs(rng, n, q, d,
                                       50 if kind == "duplicates" else 5)
        spp, spn = bf.pad_for_pallas(torch.from_numpy(pts).to(dev), tn=tn)
        qt = torch.from_numpy(qs).to(dev)
        found = {}
        for scheme in FOLD_SCHEMES:
            if scheme == "fold_few" and k > kk.FEW_K_MAX:
                continue
            err, tied, plan = compare_kernel(scheme, spp, qt, spn, k)
            worst = max(worst, err)
            found[scheme] = dict(max_abs_err=err, tied_rows=tied, plan=plan)
        rd_s, id_s = kk.knn_fold(spp, qt, spn, k=k, path="select")
        passes = list(kk.knn_fold.last_passes)
        rd_t, _ = kk.knn_fold(spp, qt, spn, k=k, path="stream")
        if not torch.equal(rd_s, torch.sort(rd_s, 1).values) or \
                not torch.equal(rd_s, torch.sort(rd_t, 1).values):
            raise AssertionError(f"fold n={n} q={q} k={k}: the select's "
                                 "rdist differ from the stream's")
        if "fold_few" in found:
            rd_f, _ = kk.knn_fold(spp, qt, spn, k=k, path="few")
            if not torch.equal(rd_s, torch.sort(rd_f, 1).values):
                raise AssertionError(f"fold n={n} q={q} k={k}: the few "
                                     "path's rdist differ from the "
                                     "stream's")
        if kind != "uniform":
            _, want = kk.knn_fold_reference(spp, qt, spn, k=k)
            if not torch.equal(id_s, want):
                raise AssertionError(f"fold select n={n} q={q} k={k}: ids "
                                     "differ from the plain version's")
        lazy = {p: lazy_is_fold(spp, qt, spn, k, p)
                for p in ("select", "stream")}
        emit("kernel", name="knn_fold", paths_case=kind, n=n, q=q, d=d, k=k,
             rule=kk.fold_path(q, k, d, spp.shape[0]),
             collect_passes=passes,
             finite_rows=int(torch.isfinite(spn).sum()),
             tied_rows_lazy_vs_fold=lazy, **found, ok=True)
    return worst


def fold_table(pp, pn, qc, shape: str) -> list:
    """fold's select and streaming paths, forced, timed in turns (three
    rounds, the least mean of each) on the first q of the centered queries
    ``qc`` at every FOLD_TABLE point of ``shape`` (and the few-query
    kernel beside them where ``fold_path`` picks it), beside the picked
    path and the best other path's time over the picked one's (``margin``,
    above 1 where the rule picked the fastest); at the REPAIR_SHAPES points
    also the plain version's time, the library call and the bound, the
    rule's path held to the plain version (compare_kernel) and the paths'
    sorted rdist held equal bit for bit.  Returns the rows."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    n, d = pp.shape
    qs_, ks_ = FOLD_TABLE[shape]
    rows = []
    for k in ks_:
        for q in qs_:
            qt = qc[:q]
            reps = 10 if q <= 512 else 1
            rule = kk.fold_path(q, k, d, n)
            paths = ("select", "stream") + (("few",) if rule == "few"
                                            else ())
            ms, passes = {}, None
            for path in paths * 3:
                t = cuda_ms(lambda: kk.knn_fold(pp, qt, pn, k=k, path=path),
                            reps=reps)
                ms[path] = min(ms.get(path, t), t)
                if path == "select":
                    passes = list(kk.knn_fold.last_passes)
            faster = min(ms, key=ms.get)
            row = dict(shape=shape, q=q, k=k, n=n, d=d,
                       **{f"{p}_ms": ms[p] for p in paths},
                       rule=rule, faster=faster, rule_is_faster=rule == faster,
                       margin=min(t for p, t in ms.items() if p != rule)
                       / ms[rule],
                       collect_passes=passes,
                       plan_select=kk.kernel_plan("fold_select", n, q, d, k),
                       plan_stream=kk.kernel_plan("fold", n, q, d, k))
            if rule == "few":
                row["plan_few"] = kk.few_plan(n, q, d, k)
            if (shape, q, k) in REPAIR_SHAPES:
                rd_s, _ = kk.knn_fold(pp, qt, pn, k=k, path="select")
                for other in paths[1:]:
                    rd_o, _ = kk.knn_fold(pp, qt, pn, k=k, path=other)
                    if not torch.equal(rd_s, torch.sort(rd_o, 1).values):
                        raise AssertionError(f"fold {shape} q={q} k={k}: "
                                             f"the {other} path's rdist "
                                             "differ from the select's")
                err, tied, _ = compare_kernel(f"fold_{rule}", pp, qt, pn, k)
                bound, by = bound_ms(n, q, d, k)
                row.update(repair=True, ms=ms[rule], max_abs_err=err,
                           tied_rows=tied,
                           plain_ms=cuda_ms(lambda: kk.knn_fold_reference(
                               pp, qt, pn, k=k), reps=1, warm=0),
                           library_ms=cuda_ms(lambda: library_topk(
                               pp, qt, pn, k), reps=2),
                           bound_ms=bound, bound_by=by)
            emit("fold_paths", **row, ok=True)
            rows.append(row)
    return rows


#: phase few_query's sweep: (label, n, d, k_scan values, query counts);
#: SIFT runs on the main index, the others on points made on the card
FEW_SWEEP = (("SIFT", N, DIM, (18, 108, 128),
              (1, 2, 3, 4, 5, 8, 16, 19, 24, 32, 48, 64)),
             ("GIST", 1_000_000, 960, (18, 108, 128),
              (1, 2, 3, 4, 8, 16, 24, 32, 48, 64)),
             ("MST", 1_000_000, 8, (13, 108, 128),
              (4, 8, 16, 24, 28, 31, 32, 64)),
             ("config2", 100_000, 2, (18,), (10, 32, 64, 128)),
             ("d2", 1_000_000, 2, (18, 108, 128),
              (1, 4, 8, 16, 24, 32, 48, 64)),
             ("d32", 1_000_000, 32, (18, 108, 128),
              (1, 4, 8, 16, 24, 32, 48, 64)),
             ("d64", 1_000_000, 64, (18, 108, 128),
              (1, 4, 8, 16, 24, 32, 48, 64)),
             ("d256", 1_000_000, 256, (18, 108, 128),
              (1, 4, 16, 24, 32, 48, 64)),
             ("d512", 1_000_000, 512, (18, 108, 128),
              (1, 4, 16, 32, 48, 64)),
             ("n10k", 10_000, 128, (18, 128), (1, 4, 16, 32, 64)),
             ("n10k_d960", 10_000, 960, (18, 128), (1, 4, 8, 16, 64)))
#: the tile kernel of the single queries' scheme by shape (k_scan 18),
#: which the route replaces with the few-query kernel
FEW_SINGLE = {"SIFT": "bcap", "GIST": "capped"}
#: the query counts the kernel is held to its plain version at: one
#: query (one row a thread, 128-feature chunks), two, three (a group of
#: four) and sixteen (the widest group)
FEW_COMPARE_Q = (1, 2, 3, 16)
#: the route's repairs the kernels line reports for knn_few: (shape,
#: repaired queries, k_scan) of the sweep (PERF.md §5)
FEW_REPAIRS = (("SIFT", 5, 18), ("SIFT", 19, 18), ("GIST", 1, 18),
               ("GIST", 2, 18), ("MST", 31, 13), ("config2", 10, 18))


def fp32_err(dim: int, qn, xn_max):
    """The FP32 SIMT product's pointwise bound on |u − true u| (fold,
    fold_lazy and the few-query kernel): 4x the f32 rounding plus the
    sequential-sum term d·2⁻²⁴, times ‖q‖² + max ‖x‖²."""
    return (4.0 * 2.0 ** -23 + dim * 2.0 ** -24) * (qn + xn_max)


def few_compare(pp, qt, pn, k: int) -> float:
    """The few-query kernel against its plain version on the card: sorted
    rdist within twice the FP32 tier's bound, every id's float64 distance
    within it of the plain version's, no id twice, NaN queries (+inf, -1).
    Returns the largest error."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    out = kk.knn_few(pp, qt, pn, k=k)
    ref = kk.knn_few_reference(pp, qt, pn, k=k)
    torch.cuda.synchronize()
    xn_max = torch.where(torch.isfinite(pn), pn, 0.0).max()
    band = 2.0 * fp32_err(pp.shape[1], torch.sum(qt * qt, dim=1), xn_max)
    rd_k, rd_p = torch.sort(out[0], 1).values, torch.sort(ref[0], 1).values
    fin = torch.isfinite(rd_p)
    if not torch.equal(fin, torch.isfinite(rd_k)):
        raise AssertionError(f"few k={k}: finite slots differ")
    diff = torch.where(fin, (rd_k - rd_p).abs(), 0.0)
    err = float(diff.max())
    if bool((diff > band[:, None]).any()):
        raise AssertionError(f"few k={k}: rdist off by {err}")

    def rd64(ids):
        r = ids.clamp_min(0).long()
        diff = qt.double()[:, None, :] - pp.double()[r]
        v = torch.where(torch.isfinite(pn[r]), (diff * diff).sum(-1),
                        torch.inf)
        return torch.sort(torch.where(ids >= 0, v, torch.inf), 1).values

    a, b = rd64(out[1]), rd64(ref[1])
    gap = torch.where(torch.isfinite(b), (a - b).abs(), 0.0)
    if bool((gap > band.double()[:, None]).any()):
        raise AssertionError(f"few k={k}: ids farther than the plain "
                             "version's")
    for r in out[1].tolist():
        kept = [x for x in r if x >= 0]
        if len(kept) != len(set(kept)):
            raise AssertionError(f"few k={k}: an id twice")
    nanq = torch.isnan(qt).any(dim=1)
    if bool((out[1][nanq] != -1).any()):
        raise AssertionError("few: a NaN query picked up results")
    return err


def few_sweep(label: str, pp, pn, qc, ks, qs_) -> list:
    """fold's three paths, each forced, timed in turns (three rounds, the
    least mean of each) at every (k_scan, q) of one FEW_SWEEP shape: the
    few-query kernel ("few") and the select and streaming paths it
    replaces, beside the bytes bound, the path ``fold_path`` picks
    (``rule``) and the best other path's time over the picked one's
    (``margin``, above 1 where the rule picked the fastest); the
    few-query kernel's sorted rdist held to the streaming kernel's bit for
    bit.  At k_scan 18 and up to 4 queries of SIFT and GIST also the tile
    kernel of the single queries' scheme (FEW_SINGLE) and ``knn_few``,
    each called directly; at one query the plain version and the library
    call.  Returns the rows."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    n, d = pp.shape
    rows = []
    for k in ks:
        for q in qs_:
            qt = qc[:q].contiguous()
            row = dict(shape=label, n=n, d=d, q=q, k=k,
                       bytes_bound_ms=4.0 * n * d / PEAK_BYTES_S * 1e3,
                       rule=kk.fold_path(q, k, d, n))
            paths = ("few", "select", "stream")
            try:
                row["plan"] = kk.few_plan(n, q, d, k)
            except RuntimeError as e:
                # the group's shared memory is over the card's limit
                if row["rule"] == "few":
                    raise AssertionError(f"few_path takes {label} q={q} "
                                         f"k={k}, which cannot launch")
                row["refused"] = str(e)
                paths = paths[1:]
            ms = {}
            for path in paths * 3:
                t = cuda_ms(lambda: kk.knn_fold(pp, qt, pn, k=k, path=path),
                            reps=10 if path == "few" else 3)
                ms[path] = min(ms.get(path, t), t)
            faster = min(ms, key=ms.get)
            row.update({f"{p}_ms": ms[p] for p in paths}, faster=faster,
                       rule_is_faster=row["rule"] == faster,
                       margin=min(t for p, t in ms.items()
                                  if p != row["rule"]) / ms[row["rule"]])
            if "few" in ms:
                rd_f, _ = kk.knn_fold(pp, qt, pn, k=k, path="few")
                rd_s, _ = kk.knn_fold(pp, qt, pn, k=k, path="stream")
                row["bits_equal_stream"] = bool(torch.equal(
                    torch.sort(rd_f, 1).values, torch.sort(rd_s, 1).values))
                if not row["bits_equal_stream"]:
                    raise AssertionError(f"few {label} q={q} k={k}: the "
                                         "few-query kernel's rdist differ "
                                         "from the streaming kernel's")
            scheme = FEW_SINGLE.get(label)
            if scheme and k == 18 and q <= 4:
                kb, tile, passes = kernel_args(scheme, 10, n)
                run = kk.knn_bcap if scheme == "bcap" else kk.knn_capped
                row[f"{scheme}_tile_ms"] = cuda_ms(lambda: run(
                    pp, qt, pn, k=kb, tile=tile, passes=passes), reps=3)
                row["knn_few_ms"] = cuda_ms(lambda: kk.knn_few(
                    pp, qt, pn, k=k), reps=10)
            if q == 1:
                row["plain_ms"] = cuda_ms(lambda: kk.knn_few_reference(
                    pp, qt, pn, k=k), reps=1, warm=0)
                row["library_ms"] = cuda_ms(lambda: library_topk(
                    pp, qt, pn, k), reps=2)
            emit("few_query", **row, ok=True)
            rows.append(row)
    return rows


def few_route(label: str, index, pdev, qdev, k: int, scheme: str) -> dict:
    """The route on 1 to 4 queries at ``k`` (``scheme`` its pick): the
    fold route on the few-query kernel, no tile kernel launched, nothing
    proved or repaired, and every id the f64 oracle's but for swaps f32
    cannot order.  Returns the counts."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.utils import profiling

    tile = kk.knn_bcap if scheme == "bcap" else kk.knn_capped
    out = {"queries": 0, "swaps": 0}
    for q in (1, 2, 3, 4):
        qs = qdev[:q]
        before = profiling.counters()
        few_before, tile_before = kk.knn_few.launches, tile.launches
        _, ids = index.query_batch(qs, k)
        torch.cuda.synchronize()
        if (index.last_scheme, kk.knn_fold.last_path) != (scheme, "few"):
            raise AssertionError(f"{label} q={q}: {index.last_scheme}, "
                                 f"fold on the {kk.knn_fold.last_path} path")
        if tile.launches != tile_before:
            raise AssertionError(f"{label} q={q}: the {scheme} tile kernel "
                                 "ran")
        after = profiling.counters()
        if after.get("route.repaired", 0) != before.get("route.repaired", 0):
            raise AssertionError(f"{label} q={q}: the route repaired")
        few = (after.get("knn.few_queries", 0)
               - before.get("knn.few_queries", 0))
        if kk.knn_few.launches == few_before or few < q:
            raise AssertionError(f"{label} q={q}: the few-query kernel did "
                                 "not run")
        _, oi = f64_oracle(pdev, qs, k)
        _, swaps, _ = check_vs_oracle(index, pdev, qs, ids, oi)
        out["queries"] += q
        out["swaps"] += swaps
    emit("few_query", route=label, scheme=scheme, k=k, **out, ok=True)
    return out


def few_single(label: str, index, qdev, k: int = 10, calls: int = 50):
    """``calls`` single queries through ``BruteForce.query``, as the
    benchmark's single cells send them, after the counters are cleared:
    every query the route took (``route.queries``) ran on the few-query
    kernel (``knn.few_queries``)."""
    from petal_neighbors_tpu_torch.utils import profiling

    profiling.reset_counters()
    for j in range(calls):
        index.query(qdev[j], k)
    c = profiling.counters()
    if not c.get("knn.few_queries") == c.get("route.queries") == calls:
        raise AssertionError(f"{label}: single queries counted {c}")
    emit("few_query", single=label, k=k, calls=calls,
         route_queries=c["route.queries"],
         few_queries=c["knn.few_queries"],
         repaired=c.get("route.repaired", 0), ok=True)


def phase_few_query(pt, index, pdev, qdev) -> tuple[list, float]:
    """Phase few_query (docstring): the sweep over FEW_SWEEP, the kernel
    against its plain version, and the route over it.  Returns every sweep
    row and the largest error against the plain version."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    qc = qdev - index._center
    rows = few_sweep("SIFT", index._pts, index._norms, qc, *FEW_SWEEP[0][3:])
    errs = {f"SIFT k={k} q={q}": few_compare(index._pts, qc[:q].contiguous(),
                                             index._norms, k)
            for k in (18, 108) for q in FEW_COMPARE_Q}
    few_route("SIFT k=10", index, pdev, qdev, 10, "bcap")
    few_route("SIFT k=100", index, pdev, qdev, 100, "capped")
    few_single("SIFT", index, qdev)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, n, d, ks, qs_ in FEW_SWEEP[1:]:
        if label == "GIST":
            pts = torch.rand((n, d), generator=gen, device="cuda")
            queries = torch.rand((64, d), generator=gen, device="cuda")
            gist = pt.BruteForce.euclidean(pts)
            gq = queries - gist._center
            rows += few_sweep(label, gist._pts, gist._norms, gq, ks, qs_)
            errs |= {f"GIST k=18 q={q}": few_compare(gist._pts,
                                                     gq[:q].contiguous(),
                                                     gist._norms, 18)
                     for q in FEW_COMPARE_Q}
            few_route("GIST k=10", gist, pts, queries, 10, "capped")
            few_single("GIST", gist, queries)
            del gist, pts, queries, gq
        else:
            pts = torch.randn((n, d), generator=gen, device="cuda")
            queries = torch.randn((max(qs_), d), generator=gen, device="cuda")
            mu = bf.center_of(pts)
            pp, pn = bf.pad_for_pallas(pts - mu)
            rows += few_sweep(label, pp, pn, queries - mu, ks, qs_)
            del pp, pn, pts, queries
        torch.cuda.empty_cache()
    emit("few_query", max_abs_err=errs, rule=kk.FEW_RULE,
         rule_is_faster_at=sum(r["rule_is_faster"] for r in rows),
         least_margin=min(r["margin"] for r in rows if "margin" in r),
         table_points=len(rows), ok=True)
    return rows, max(errs.values())


def phase_kernel(pp, pn, planes, queries_c):
    """Each kernel against its plain version at every listed shape, then at
    the main paths' shapes (the tensor-core kernels timed on the index's
    piece planes, ``planes``, as the route runs them); returns the
    main-shape rows by (scheme, k) (the minima kernels by (name, None)) and
    each kernel's largest error."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    errs = {s: 0.0 for s in ("fold", "fold_lazy", "capped", "bcap", "merge")}
    for scheme, n, q, d, tn, k, tile, passes in SMALL_CASES:
        pts, qs = small_inputs(rng, n, q, d)
        spp, spn = bf.pad_for_pallas(torch.from_numpy(pts).to(dev), tn=tn)
        qt = torch.from_numpy(qs).to(dev)
        err, tied, plan = compare_kernel(scheme, spp, qt, spn, k, tile,
                                         passes)
        errs[scheme] = max(errs[scheme], err)
        extra = {}
        if scheme == "fold_lazy":
            extra["tied_rows_vs_fold"] = {
                p: lazy_is_fold(spp, qt, spn, k, p)
                for p in ("select", "stream")}
        if scheme == "bcap":
            extra["ids_equal_to_minima"] = bcap_is_minima(spp, qt, spn, k,
                                                          tile, passes)
        emit("kernel", name=f"knn_{scheme}", n=n, q=q, d=d, k=k, tile=tile,
             passes=passes, max_abs_err=err, tied_rows=tied, plan=plan,
             **extra, ok=True)
    errs["fold"] = max(errs["fold"], phase_fold_paths_small(rng))
    errs["merge"] = max(errs["merge"], phase_merge_edges())
    errs.update(phase_minima_small(rng))

    n_real = N
    rows = {}
    for scheme, k_req, q in MAIN_CALLS:
        qt = queries_c[:q]
        k, tile, passes = kernel_args(scheme, k_req, n_real)
        err, tied, plan = compare_kernel(scheme, pp, qt, pn, k, tile, passes)
        errs[scheme] = max(errs[scheme], err)
        ms = cuda_ms(lambda: _run(scheme, False, pp, qt, pn, k, tile,
                                  passes, planes=planes), reps=3)
        plain = cuda_ms(lambda: _run(scheme, True, pp, qt, pn, k, tile,
                                     passes, plan[0]), reps=1, warm=0)
        lib = cuda_ms(lambda: library_topk(
            pp, qt, pn, k, block=16 if scheme == "bcap" else 1), reps=2)
        extra = tier_bounds(scheme, pp.shape[0], q, DIM, k)
        if scheme == "merge":
            # the collect passes of the timed calls, and the same launch at
            # k=16
            extra["radix_passes"] = list(kk.knn_merge.last_passes)
            extra["ms_at_k16"] = cuda_ms(lambda: _run(
                scheme, False, pp, qt, pn, 16, 1, 0, planes=planes), reps=2)
        if scheme == "bcap":
            extra["ids_equal_to_minima"] = bcap_is_minima(pp, qt, pn, k,
                                                          tile, passes)
        if scheme == "fold_lazy":
            # fold on the same work, in the same call, and the two equal
            # against both of fold's paths
            extra["tied_rows_vs_fold"] = {
                p: lazy_is_fold(pp, qt, pn, k, p)
                for p in ("select", "stream")}
            extra["fold_ms"] = cuda_ms(lambda: _run(
                "fold", False, pp, qt, pn, k, 1, 0), reps=3)
        row = dict(k_request=k_req, k=k, tile=tile, passes=passes,
                   n=pp.shape[0], q=q, d=DIM, plan=plan, max_abs_err=err,
                   tied_rows=tied, ms=ms, plain_ms=plain, library_ms=lib,
                   **extra)
        emit("kernel", name=f"knn_{scheme}", **row, ok=True)
        rows[scheme, k_req] = row

    # the minima kernels at the SIFT shape: all 10,240 queries, both on the
    # tensor-core tier
    for kind, name, fn, width, tier in (
            ("subchunk", "subchunk_minima", mk.subchunk_minima, mk.SUBCHUNK,
             "tc"),
            ("block", "bcap_minima", mk.bcap_minima, mk.BCAP_BLOCK, "tc")):
        err, plain = compare_minima(kind, pp, queries_c, pn)
        errs[name] = max(errs[name], err)
        ms = cuda_ms(lambda: fn(pp, queries_c, pn, point_planes=planes),
                     reps=3)
        lib = cuda_ms(lambda: library_minima(pp, queries_c, pn, width),
                      reps=2)
        bound, by = minima_bound_ms(pp.shape[0], N_Q, DIM, width, tier)
        other = minima_bound_ms(pp.shape[0], N_Q, DIM, width,
                                "fp32" if tier == "tc" else "tc")[0]
        row = dict(n=pp.shape[0], q=N_Q, d=DIM, rows=width,
                   splits=mk.minima_plan(kind, pp.shape[0], N_Q, DIM),
                   max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, tier=tier)
        if kind == "subchunk":
            row["subchunk_is_block"] = subchunk_is_block(pp, queries_c, pn)
        if tier == "tc":
            row.update(simt_bound_ms=other,
                       peak="bf16 dense 989 TFLOP/s x 6 products and HBM "
                            "3.35 TB/s, H100 SXM data sheet")
        else:
            row.update(tc_bound_ms=other,
                       peak="FP32 non-tensor 67 TFLOP/s and HBM 3.35 TB/s, "
                            "H100 SXM data sheet")
        emit("kernel", name=name, **row, ok=True)
        rows[name, None] = row
    return rows, errs


def sort_rows(rows: int, width: int, gen) -> tuple:
    """Rows of keys with many duplicates and a +inf tail, and distinct
    payloads, on the card."""
    keys = (torch.randint(0, max(2, width // 3), (rows, width), generator=gen)
            .float() * 0.25 + 100.0)
    keys[:, width - width // 7:] = float("inf")
    keys[: rows // 4, ::5] = float("inf")
    vals = torch.randperm(rows * width, generator=gen).int().reshape(
        rows, width)
    return keys.cuda(), vals.cuda()


#: the contract's edge rows, in the order edge_rows makes them
EDGE_ROWS = ("all keys equal", "only +inf", "negative keys with ties",
             "-0.0 among +0.0 and +-0.25", "-0.0 among ties and +inf",
             "normal keys")


def edge_rows(width: int, gen) -> tuple:
    """One row of each of EDGE_ROWS at ``width``, with distinct payloads,
    on the card."""
    keys = torch.randn((len(EDGE_ROWS), width), generator=gen)
    keys[0] = 1.5
    keys[1] = float("inf")
    keys[2] = -0.5 * torch.randint(0, max(2, width // 4), (width,),
                                   generator=gen).float()
    keys[3] = torch.tensor([-0.25, -0.0, 0.0, 0.25])[
        torch.randint(0, 4, (width,), generator=gen)]
    keys[4] = torch.randint(-3, 3, (width,), generator=gen).float()
    keys[4, ::4] = -0.0
    keys[4, 1::5] = float("inf")
    vals = torch.randperm(keys.numel(), generator=gen).int().reshape(
        keys.shape)
    return keys.cuda(), vals.cuda()


def check_stable(kind: str, fn, plain, keys, vals, label: str) -> None:
    """A row sort against its plain version (a stable ``torch.sort`` and
    a gather) on the same card tensors: keys equal bit for bit (-0.0 in
    its place) and payloads equal, ties by input position."""
    ok_, ov = fn(keys, vals)
    torch.cuda.synchronize()
    rk_, rv = plain(keys, vals)
    if not torch.equal(ok_.view(torch.int32), rk_.view(torch.int32)):
        raise AssertionError(f"{kind} {label}: keys differ from a stable "
                             "sort")
    if not torch.equal(ov, rv):
        raise AssertionError(f"{kind} {label}: payloads differ from a "
                             "stable sort")


def time_sort(fn, plain, keys, vals) -> dict:
    """A row sort's ms, its plain version's and the library call's (a
    stable ``torch.sort`` and a ``gather``), each held behind a sleep so
    that the events time the launches back to back; and the bound: each
    key and payload read once and written once at the HBM rate."""
    def library():
        sk_, pos = torch.sort(keys, dim=1, stable=True)
        return sk_, torch.gather(vals, 1, pos)
    return dict(rows=keys.shape[0], width=keys.shape[1], max_abs_err=0.0,
                ms=cuda_ms(lambda: fn(keys, vals), reps=20, hold=True),
                plain_ms=cuda_ms(lambda: plain(keys, vals), reps=20,
                                 hold=True),
                library_ms=cuda_ms(library, reps=20, hold=True),
                bound_ms=2 * keys.numel() * 8 / PEAK_BYTES_S * 1e3,
                bound_by="bytes", peak="HBM 3.35 TB/s, H100 SXM data sheet")


def capture_route_rows(index, qdev) -> dict:
    """The (keys, payloads) that the route hands to a row sort, one call
    of each ROUTE_SORTS request with the sorts' names in ops.bruteforce
    wrapped to keep the inputs of the call with the most rows (the
    batch's re-rank, not a repair's).  Returns {label: (kind, keys,
    vals)}."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    originals = {"bitonic_sort": bf.bitonic_sort_pairs,
                 "rank_sort": bf.rank_sort_pairs}
    seen = []

    def keep(kind):
        def call(keys, vals):
            if not seen or keys.shape[0] > seen[0][1].shape[0]:
                seen[:] = [(kind, keys.clone(), vals.clone())]
            return originals[kind](keys, vals)
        return call

    out = {}
    bf.bitonic_sort_pairs = keep("bitonic_sort")
    bf.rank_sort_pairs = keep("rank_sort")
    try:
        for label, scheme, k, nq in ROUTE_SORTS:
            seen.clear()
            if scheme is None:
                index.query_batch(qdev[:nq], k)
            else:
                bf.knn_prepadded(index._pts, index._norms, qdev[:nq], k, N,
                                 index._center, scheme=scheme)
            torch.cuda.synchronize()
            if not seen:
                raise AssertionError(f"{label}: the route ran no row sort")
            out[label] = seen[0]
    finally:
        bf.bitonic_sort_pairs = originals["bitonic_sort"]
        bf.rank_sort_pairs = originals["rank_sort"]
    return out


def phase_sorts(index, qdev):
    """Both row sorts against a stable torch.sort on the card, keys bit for
    bit and payloads exact: both entry points on the edge rows at every
    SORT_EDGE_WIDTHS width; each sort on rows with duplicate keys and +inf
    tails at its path's shapes (and at 301 rows), timed; then on the rows
    the route itself hands it (ROUTE_SORTS), timed beside them.  Returns
    the main shape's row by kind, with the route rows' ms."""
    from petal_neighbors_tpu_torch.ops.cuda import rank_sort_kernel as rk
    from petal_neighbors_tpu_torch.ops.cuda import sort_kernel as sk

    fns = {"bitonic_sort": (sk.bitonic_sort_pairs,
                            sk.bitonic_sort_pairs_reference),
           "rank_sort": (rk.rank_sort_pairs, rk.rank_sort_pairs_reference)}
    gen = torch.Generator().manual_seed(3)
    for width in SORT_EDGE_WIDTHS:
        keys, vals = edge_rows(width, gen)
        for kind, (fn, plain) in fns.items():
            check_stable(kind, fn, plain, keys, vals,
                         f"edge rows at width {width}")
    emit("kernel", name="row_sorts", edge_widths=SORT_EDGE_WIDTHS,
         edge_rows=EDGE_ROWS, entry_points=sorted(fns), ok=True)
    out = {}
    for kind, shapes, main_shape in SORTS:
        fn, plain = fns[kind]
        for nrows, width in shapes:
            for r in (301, nrows):
                keys, vals = sort_rows(r, width, gen)
                check_stable(kind, fn, plain, keys, vals,
                             f"{r} x {width}")
            row = dict(time_sort(fn, plain, keys, vals), rows_from="synthetic")
            emit("kernel", name=kind, **row, ok=True)
            if (nrows, width) == main_shape:
                out[kind] = row
    for label, (kind, keys, vals) in capture_route_rows(index, qdev).items():
        fn, plain = fns[kind]
        check_stable(kind, fn, plain, keys, vals, label)
        row = dict(time_sort(fn, plain, keys, vals), rows_from=label)
        emit("kernel", name=kind, **row, ok=True)
        main = out[kind]
        if (main["rows"], main["width"]) == (row["rows"], row["width"]):
            main["route_ms"] = row["ms"]
    return out


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def f64_oracle(points_dev, queries_dev, k: int, chunk: int = 32768,
               cosine: bool = False):
    """Exact f64 top-k ids, chunked over points (a check on the card, not
    the port).  ``cosine`` ranks the L2-normalized rows, whose squared
    distance is twice the cosine distance."""
    q64 = queries_dev.double()
    if cosine:
        q64 = _unit(q64)
    qn = (q64 * q64).sum(1, keepdim=True)

    def scores(s, e):
        p64 = points_dev[s:e].double()
        if cosine:
            p64 = _unit(p64)
        return qn + (p64 * p64).sum(1)[None, :] - 2.0 * (q64 @ p64.T)
    best_d, best_i = chunked_topk(scores, points_dev.shape[0], k, chunk)
    return best_d.clamp_min(0).sqrt(), best_i


def check_vs_oracle(index, points_dev, queries_dev, ids, oracle_ids,
                    cosine: bool = False):
    """Every query's ids against the f64 oracle's.

    The port is exact to f32 direct-form distances (the JAX package's
    contract), so an id may differ from the oracle's only by a swap that
    those distances cannot order: each of the port's extra ids must be no
    farther, in the f32 direct form over the index's centered copy (as
    ``rescore_exact`` computes it, up to 2^-22 relative for the summation
    order), than every oracle id it displaced.
    Swaps are capped at SWAPS_PER_MILLION per 10^6 returned ids.  A cosine
    index is checked on its normalized copy with normalized queries (no
    center), as the route ranks them.  Returns (recall, swaps, the largest
    f64 gap of a swap over the f32 rounding band 4*d*2^-24*rd)."""
    from petal_neighbors_tpu_torch.ops.topk import rescore_exact

    a = torch.sort(ids.long(), dim=1).values.cpu().tolist()
    b = torch.sort(oracle_ids, dim=1).values.cpu().tolist()
    if cosine:
        qc = queries_dev / torch.sqrt(
            torch.sum(queries_dev * queries_dev, dim=-1, keepdim=True))
    else:
        qc = queries_dev - index._center
    hits, swaps, worst = 0, 0, 0.0
    for r, (x, y) in enumerate(zip(a, b)):
        sx, sy = set(x), set(y)
        hits += len(sx & sy)
        if sx == sy:
            continue
        got, missed = sorted(sx - sy), sorted(sy - sx)
        cand = torch.tensor([got + missed], dtype=torch.int32,
                            device=ids.device)
        rd32, order = rescore_exact(index._pts, qc[r:r + 1], cand,
                                    cand.shape[1])
        rd_of = dict(zip(order[0].tolist(), rd32[0].tolist()))
        # 2^-22 relative: the few ulps by which another summation order
        # of the same d terms may round
        if max(rd_of[p] for p in got) > min(
                rd_of[o] for o in missed) * (1.0 + 2.0 ** -22):
            raise AssertionError(f"query {r}: the port returned an id "
                                 "farther in f32 than an oracle id it left")
        q64 = queries_dev[r].double()
        if cosine:
            q64 = _unit(q64)

        def rd64(pid):
            p64 = points_dev[pid].double()
            if cosine:
                p64 = _unit(p64)
            return float(((p64 - q64) ** 2).sum())
        gap = max(rd64(p) for p in got) - min(rd64(o) for o in missed)
        band = 4.0 * points_dev.shape[1] * 2.0 ** -24 * min(
            rd64(o) for o in missed)
        swaps += len(got)
        worst = max(worst, gap / band)
    n_ids = len(a) * len(a[0])
    if swaps > max(1, SWAPS_PER_MILLION * n_ids // 10 ** 6):
        raise AssertionError(f"{swaps} boundary swaps in {n_ids} ids")
    return hits / n_ids, swaps, worst


def lp_f64_oracle(points_dev, queries_dev, k: int, p: float):
    """Exact f64 top-k of sum |q - x|^p by torch.cdist in f64, chunked
    over points (a check on the card, not the port).  Returns (power sums,
    ids)."""
    q64 = queries_dev.double()
    best_d, best_i = chunked_topk(
        lambda s, e: torch.cdist(q64, points_dev[s:e].double(), p=p),
        points_dev.shape[0], k, 65536)
    return best_d ** p, best_i


def check_lp_vs_oracle(points_dev, queries_dev, dists, ids, oracle_s,
                       oracle_ids, p: float):
    """Minkowski ids and distances against the f64 oracle.  An id may
    differ from the oracle's only by a swap that f32 cannot order: the
    f64 power sums of the port's extra id and of the oracle id it displaced
    differ by less than the f32 rounding band of a sum of d non-negative
    terms, each rounded p times, (d + 2p) 2^-24 times the oracle's k-th
    sum.  Returns (recall, swaps, worst swap gap over its band, largest
    relative distance error against the oracle)."""
    d = points_dev.shape[1]
    want = oracle_s ** (1.0 / p)
    rel = float(((dists.double() - want).abs() / want).max())
    if rel > (d + 2.0 * p) * 2.0 ** -24:
        raise AssertionError(f"Minkowski distances off the oracle by {rel} "
                             "relative")
    a = torch.sort(ids.long(), dim=1).values.cpu().tolist()
    b = torch.sort(oracle_ids, dim=1).values.cpu().tolist()
    kth = oracle_s[:, -1].cpu().tolist()
    hits, swaps, worst = 0, 0, 0.0
    for r, (x, y) in enumerate(zip(a, b)):
        sx, sy = set(x), set(y)
        hits += len(sx & sy)
        if sx == sy:
            continue
        q64 = queries_dev[r].double()

        def s64(pid):
            return float(((points_dev[pid].double() - q64).abs() ** p).sum())
        got, missed = sx - sy, sy - sx
        gap = max(s64(i) for i in got) - min(s64(o) for o in missed)
        band = (d + 2.0 * p) * 2.0 ** -24 * kth[r]
        if gap >= band:
            raise AssertionError(f"query {r}: the port returned an id "
                                 f"{gap / band:.3g} bands farther than an "
                                 "oracle id it left")
        swaps += len(got)
        worst = max(worst, gap / band)
    return hits / (len(a) * len(a[0])), swaps, worst, rel


def library_lp_topk(points, mask, queries, k: int, p: float):
    """Yardstick: the same top-k by a chunked ``torch.cdist`` plus
    ``torch.topk`` and a merge, timed here and used nowhere in the port.
    Returns the p-th-root distances."""
    return chunked_topk(
        lambda s, e: torch.cdist(queries, points[s:e], p=p) + mask[None, s:e],
        points.shape[0], k, 65536)


def phase_main_generic(wrappers, fold_rows):
    """Config 5: three indexes over the same 1M x 960 points, built one at
    a time, each answering the 1,000 queries at k=10 through the entry
    points a user calls; the route, QPS, launches and the oracle checked
    per index; then the path's kernels against their plain versions at
    this shape.  Returns the kernels-line fields of lp_knn and the
    launches on this path."""
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import lp_kernel as lk

    t0 = time.perf_counter()
    rng = np.random.default_rng(GIST_SEED)
    points = rng.random((GIST_N, GIST_D), dtype=np.float32)
    queries = rng.random((GIST_Q, GIST_D), dtype=np.float32)
    emit("main_generic", data_s=time.perf_counter() - t0, n=GIST_N,
         d=GIST_D, queries=GIST_Q, seed=GIST_SEED)
    pdev = torch.from_numpy(points).cuda()
    qdev = torch.from_numpy(queries).cuda()
    metrics = {"euclidean": pt.Euclidean(), "cosine": pt.Cosine(),
               "minkowski3": pt.Minkowski(3.0)}
    lp_row, launches, capped_gist, gist_fold = None, {}, None, []
    for name, scheme in GENERIC:
        t0 = time.perf_counter()
        index = pt.BruteForce(points, metrics[name])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        # ---- the path: counts from 0, warm call, best of 3 ---------------
        for w in wrappers.values():
            w.launches = 0
        fold_rows.clear()
        d, i = index.query_batch(qdev, GIST_K)
        torch.cuda.synchronize()
        if (index.last_backend, index.last_scheme) != ("kernel", scheme):
            raise AssertionError(f"{name}: served by {index.last_backend} "
                                 f"{index.last_scheme}, not {scheme}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, i = index.query_batch(qdev, GIST_K)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        got = {s: w.launches for s, w in wrappers.items()}
        need = "lp_knn" if scheme == "lp" else "capped"
        if got[need] == 0:
            raise AssertionError(f"main_generic {name} launched no {need} "
                                 "kernel")
        for s, c in got.items():
            if c:
                launches[s] = launches.get(s, 0) + c
        repaired = list(fold_rows)
        if d.shape != (GIST_Q, GIST_K) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{name}: bad output {tuple(d.shape)}")
        if not bool((d[:, 1:] >= d[:, :-1]).all()):
            raise AssertionError(f"{name}: distances not ascending")
        # ---- the oracle -------------------------------------------------
        t0 = time.perf_counter()
        if scheme == "lp":
            nq = LP_ORACLE_MIN_Q
            os_, oi = lp_f64_oracle(pdev, qdev[:nq], GIST_K, 3.0)
            torch.cuda.synchronize()
            per_q = (time.perf_counter() - t0) / nq
            if per_q * (GIST_Q - nq) <= ORACLE_BUDGET_S:
                rs, ri = lp_f64_oracle(pdev, qdev[nq:], GIST_K, 3.0)
                os_, oi, nq = torch.cat([os_, rs]), torch.cat([oi, ri]), GIST_Q
            recall, swaps, worst, dist_err = check_lp_vs_oracle(
                pdev, qdev[:nq], d[:nq], i[:nq], os_, oi, 3.0)
        else:
            cosine = name == "cosine"
            od, oi = f64_oracle(pdev, qdev, GIST_K, cosine=cosine)
            nq = GIST_Q
            recall, swaps, worst = check_vs_oracle(index, pdev, qdev, i, oi,
                                                   cosine=cosine)
            want = od * od * 0.5 if cosine else od
            dist_err = float(((d.double() - want).abs() / want).max())
        oracle_s = time.perf_counter() - t0
        # ---- the path's kernel at this shape, against its plain version --
        if scheme == "lp":
            spec = index._lp_spec
            err, rel, tied, plain = compare_lp(index._pts, index._mask, qdev,
                                               GIST_K, spec)
            ms = cuda_ms(lambda: lk.lp_knn(index._pts, index._mask, qdev,
                                           k=GIST_K, spec=spec), reps=3)
            lib = cuda_ms(lambda: library_lp_topk(
                index._pts, index._mask, qdev, GIST_K, 3.0), reps=1)
            bound, by = lp_bound_ms(index._pts.shape[0], GIST_Q, GIST_D,
                                    GIST_K, spec)
            other = {}
            for label, (p, reduce) in (("manhattan", (1.0, "sum")),
                                       ("chebyshev", (1.0, "max"))):
                s2 = lk.LpSpec(p, reduce)
                other[label] = dict(
                    ms=cuda_ms(lambda: lk.lp_knn(index._pts, index._mask,
                                                 qdev, k=GIST_K, spec=s2),
                               reps=2),
                    bound_ms=lp_bound_ms(index._pts.shape[0], GIST_Q,
                                         GIST_D, GIST_K, s2)[0])
            kernel = dict(name="lp_knn", k=GIST_K, max_abs_err=err,
                          max_rel_err=rel, tied_rows=tied, ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=bound,
                          bound_by=by, splits=lk.lp_plan(
                              spec, index._pts.shape[0], GIST_Q, GIST_D),
                          other_metrics=other)
            lp_row = dict(kernel, n=index._pts.shape[0], q=GIST_Q, d=GIST_D)
        else:
            qk = (_unit(qdev) if name == "cosine"
                  else qdev - index._center)
            k, tile, passes = kernel_args("capped", GIST_K, GIST_N)
            err, tied, plan = compare_kernel("capped", index._pts, qk,
                                             index._norms, k, tile, passes)
            ms = cuda_ms(lambda: kk.knn_capped(
                index._pts, qk, index._norms, k=k, tile=tile,
                passes=passes, point_planes=index._planes), reps=3)
            plain = cuda_ms(lambda: kk.knn_capped_reference(
                index._pts, qk, index._norms, k=k, tile=tile, passes=passes,
                splits=plan[0]), reps=1, warm=0)
            lib = cuda_ms(lambda: library_topk(index._pts, qk, index._norms,
                                               k), reps=1)
            kernel = dict(name="knn_capped", k=k, tile=tile, passes=passes,
                          plan=plan, max_abs_err=err, tied_rows=tied, ms=ms,
                          plain_ms=plain, library_ms=lib,
                          **tier_bounds("capped", index._pts.shape[0],
                                        GIST_Q, GIST_D, k))
            if name == "euclidean":
                capped_gist = kernel
                # the bcap yardstick at this shape: the reference serves
                # capped here (no bcap planes over its budget)
                kb, btile, bpasses = kernel_args("bcap", GIST_K, GIST_N)
                kernel["bcap_yardstick"] = dict(
                    k=kb, tile=btile, passes=bpasses,
                    plan=kk.kernel_plan("bcap", index._pts.shape[0], GIST_Q,
                                        GIST_D, kb, btile),
                    ms=cuda_ms(lambda: kk.knn_bcap(
                        index._pts, qk, index._norms, k=kb, tile=btile,
                        passes=bpasses, point_planes=index._planes),
                        reps=3),
                    **tier_bounds("bcap", index._pts.shape[0], GIST_Q,
                                  GIST_D, kb))
            if repaired:
                # the repair's kernel on the repaired count of queries, on
                # the path fold_path picks, beside the streaming kernel
                qr = qk[:repaired[-1]]
                kernel["repair_fold_ms"] = cuda_ms(lambda: kk.knn_fold(
                    index._pts, qr, index._norms, k=k), reps=2)
                kernel["repair_fold_stream_ms"] = cuda_ms(
                    lambda: kk.knn_fold(index._pts, qr, index._norms, k=k,
                                        path="stream"), reps=2)
                kernel["repair_fold_path"] = kk.fold_path(
                    qr.shape[0], k, GIST_D, GIST_N)
            if name == "euclidean":
                gist_fold = fold_table(index._pts, index._norms, qk, "GIST")
        emit("main_generic", index=name, scheme=scheme, k=GIST_K,
             queries=GIST_Q, qps=GIST_Q / min(walls), batch_s=min(walls),
             kernel_ms=ms, launches_in_calls={s: c for s, c in got.items()
                                              if c},
             calls=4, repaired_queries_per_call=repaired, build_s=build_s,
             recall=recall, oracle_queries=nq, boundary_swaps=swaps,
             worst_swap_gap_over_band=worst, max_dist_rel_err=dist_err,
             oracle_s=oracle_s, backend=index.last_backend, kernel=kernel)
        del index, d, i
        torch.cuda.empty_cache()
    emit("main_generic", launches=launches)
    return lp_row, launches, capped_gist, gist_fold


def phase_main_opt_in(index, pdev, qdev, oracle_ids, rows, wrappers,
                      fold_rows, proofs):
    """The opt-in schemes over the SIFT index's arrays through
    ``knn_prepadded`` (as ``benchmarks/bcap2_probe.py`` drives the JAX
    one), every request on all 10,240 queries: a warm call and 3 timed
    ones each; the launches in those calls, the queries each bcap2 repair
    carried, each two_phase call's whole-batch fallback, and every query's
    ids against the main phase's f64 oracle.  Returns the launches."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    for w in wrappers.values():
        w.launches = 0
    kernel_ms = {"bcap2": {"bcap_minima": rows["bcap_minima", None]["ms"]},
                 "two_phase": {"subchunk_minima":
                               rows["subchunk_minima", None]["ms"],
                               "knn_fold at k_scan 18 (fallback)":
                               rows["fold_lazy", 10]["fold_ms"]},
                 "fold_lazy": {"knn_fold_lazy": rows["fold_lazy", 10]["ms"]}}
    for scheme, k in OPT_IN:
        before = {s: w.launches for s, w in wrappers.items()}
        fold_rows.clear()
        proofs.clear()
        fallbacks, walls = [], []
        for call in range(4):                        # warm, then 3 timed
            t0 = time.perf_counter()
            d, i = bf.knn_prepadded(index._pts, index._norms, qdev, k, N,
                                    index._center, scheme=scheme)
            torch.cuda.synchronize()
            if call:
                walls.append(time.perf_counter() - t0)
            if scheme == "two_phase":
                fallbacks.append(bf.last_two_phase_fallback)
        tier = "tc" if proofs else None
        got = {s: w.launches - before[s] for s, w in wrappers.items()}
        if d.shape != (N_Q, k) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{scheme} k={k}: bad output "
                                 f"{tuple(d.shape)}")
        if not bool((d[:, 1:] >= d[:, :-1]).all()):
            raise AssertionError(f"{scheme} k={k}: distances not ascending")
        recall, swaps, worst = check_vs_oracle(index, pdev, qdev, i,
                                               oracle_ids[:, :k])
        extra = {"proof_tier": tier} if tier is not None else {}
        if scheme == "two_phase" and tier != "tc":
            raise AssertionError(f"two_phase proved on {tier}, not tc")
        if scheme == "bcap2":
            extra["repaired_queries_per_call"] = list(fold_rows)
        if scheme == "two_phase":
            extra["fallbacks_per_call"] = [int(f) for f in fallbacks]
        emit("main_opt_in", scheme=scheme, k=k, queries=N_Q,
             qps=N_Q / min(walls), batch_s=min(walls),
             kernel_ms=kernel_ms[scheme],
             launches_in_calls={s: c for s, c in got.items() if c}, calls=4,
             recall=recall, oracle_queries=N_Q, boundary_swaps=swaps,
             worst_swap_gap_over_band=worst, **extra)
    got = {s: w.launches for s, w in wrappers.items()}
    for s in ("fold_lazy", "subchunk_minima", "bcap_minima", "bitonic_sort"):
        if got[s] == 0:
            raise AssertionError(f"main_opt_in launched no {s} kernel")
    emit("main_opt_in", launches=got)
    return got


# ---- the radius family and the ball tree (plain PyTorch on the card) -------

#: the JAX package's config 1 (benchmarks/run.py:109-127): BallTree over
#: 100k x 2 N(0,1) points, 10k queries, k=2
BALL_N, BALL_Q, BALL_K, BALL_SEED = 100_000, 10_000, 2, 1
#: its config 4 (:173-189): the first 4,096 points as queries, an epsilon
#: sweep, capped lists
RADIUS_SEED, RADIUS_Q, RADIUS_EPS, RADIUS_CAP = 4, 4096, (0.01, 0.05, 0.2), 512
#: the device build's regime (the JAX package's trees/ball.py:91-93)
BUILD_N = 1_000_000
#: |device - host| / (1 + |host|) allowed for its centroids and radii
BUILD_TOL = 1e-6
#: the matmul-form leaf scan and the direct rescore (d > 32)
HIGHDIM_N, HIGHDIM_D, HIGHDIM_Q, HIGHDIM_K, HIGHDIM_SEED = (65_536, 40, 1_024,
                                                           10, 40)
#: the flat index's radius phase: queries of the mask form
RADIUS_FLAT_Q = 1024
#: a flat radius pair may differ between two forms only this many f32
#: ulp of rr from the boundary (PARITY.md:129-135)
BOUNDARY_ULP = 2.0


def timed(fn, reps: int = 2, warm: bool = True):
    """(the last call's result, its least wall seconds over ``reps``
    calls, after one warm call where ``warm``)."""
    if warm:
        fn()
        torch.cuda.synchronize()
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best


def ulp32(x: float) -> float:
    return float(np.spacing(np.float32(x)))


def phase_radius_flat(index, pdev, qdev, d100):
    """``BruteForce.query_radius_batch`` on the SIFT index: the band form
    on the first 1,024 queries against a plain direct-form mask, then the
    capped and count forms on all queries.  Returns r, the mask's row sums
    and each row's pairs within 2 ulp of r."""
    import warnings

    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    t_phase = time.perf_counter()
    q1 = qdev[:RADIUS_FLAT_Q]
    r = float(d100[:RADIUS_FLAT_Q, 99].median())
    band_calls = []
    band = bf._radius_mask_matmul

    def counted(*a, **kw):
        band_calls.append(kw["cap"])
        return band(*a, **kw)
    bf._radius_mask_matmul = counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mask, mask_s = timed(lambda: index.query_radius_batch(q1, r),
                                 reps=1)
    finally:
        bf._radius_mask_matmul = band
    if not band_calls:
        raise AssertionError("radius_flat: the band form did not run")
    amb = bf.last_band_ambiguous
    overflow = any("error band" in str(w.message) for w in caught)

    # the plain direct form, chunk by chunk, on the index's centred copy
    pts, qc = index._pts[:N], q1 - index._center
    dev = qdev.device
    rr = torch.tensor(r, dtype=torch.float32, device=dev) ** 2
    tol = BOUNDARY_ULP * ulp32(float(rr))
    plain = torch.empty_like(mask)
    near = torch.zeros((RADIUS_FLAT_Q,), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for s in range(0, N, 512):
        diff = qc[:, None, :] - pts[None, s:s + 512, :]
        rd = torch.sum(diff * diff, dim=-1)
        plain[:, s:s + 512] = (rd <= rr) & ~index._invalid[None, s:s + 512]
        near += torch.sum((rd - rr).abs() <= tol, dim=1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    qi, pi = torch.nonzero(mask != plain, as_tuple=True)
    worst = 0.0
    if qi.numel():
        rd64 = ((qc[qi].double() - pts[pi].double()) ** 2).sum(1)
        worst = float((rd64 - float(rr)).abs().max()) / ulp32(float(rr))
        if worst > BOUNDARY_ULP:
            raise AssertionError(f"radius_flat: a pair {worst:.2f} ulp from "
                                 "the radius differs from the direct form")
    rowsum = mask.sum(1)

    qs_all = qdev
    # one call each: a call is seconds long
    (ids, counts), capped_s = timed(
        lambda: index.query_radius_batch(qs_all, r, cap=RADIUS_CAP), reps=1,
        warm=False)
    count_only, count_s = timed(
        lambda: index.query_radius_count_batch(qs_all, r), reps=1,
        warm=False)
    if not bool(torch.equal(counts, count_only)):
        raise AssertionError("radius_flat: capped and count forms disagree")
    off = (counts[:RADIUS_FLAT_Q].long() - rowsum).abs()
    if bool((off > near).any()):
        raise AssertionError("radius_flat: counts differ from the mask's "
                             "row sums away from the boundary")
    # the capped ids are the mask's first members, ascending
    want, _ = bf.compact_mask(mask, RADIUS_CAP)
    exact = near == 0
    if not bool(torch.equal(ids[:RADIUS_FLAT_Q][exact], want[exact])):
        raise AssertionError("radius_flat: capped ids differ from the mask")
    emit("radius_flat", n=N, d=DIM, radius=r, rr=float(rr),
         mask_queries=RADIUS_FLAT_Q, mask_qps=RADIUS_FLAT_Q / mask_s,
         mask_s=mask_s, mask_gb=mask.numel() / 1e9, band_form=True,
         band_cap=band_calls[-1], band_overflow=overflow,
         ambiguous_per_query=float(amb.double().mean()),
         ambiguous_max=int(amb.max()), pairs_differing=int(qi.numel()),
         worst_differing_ulp=worst, pairs_within_2ulp=int(near.sum()),
         plain_mask_s=plain_s, members_per_query=float(
             rowsum.double().mean()), queries=qs_all.shape[0],
         capped_qps=qs_all.shape[0] / capped_s, capped_s=capped_s,
         count_qps=qs_all.shape[0] / count_s, count_s=count_s,
         over_cap=int((counts > RADIUS_CAP).sum()),
         seconds=time.perf_counter() - t_phase)
    return r, rowsum, near


def check_tree_knn(pdev, qdev, ids, oracle_ids, label: str):
    """Every query's ids against the f64 oracle's: an id may differ only
    by a swap that f32 direct-form distances cannot order (within
    4·d·2⁻²⁴ of the oracle's farthest kept distance); swaps are capped at
    SWAPS_PER_MILLION per 10^6 ids.  Returns (recall, swaps)."""
    a = torch.sort(ids.long(), dim=1).values
    b = torch.sort(oracle_ids.long(), dim=1).values
    rows = torch.nonzero((a != b).any(dim=1)).flatten().tolist()
    n_ids = a.numel()
    if len(rows) > max(1, SWAPS_PER_MILLION * n_ids // 10 ** 6):
        raise AssertionError(f"{label}: {len(rows)} queries differ from the "
                             "f64 oracle")
    d = pdev.shape[1]
    swaps = 0
    for r in rows:
        got = set(a[r].tolist()) - set(b[r].tolist())
        missed = set(b[r].tolist()) - set(a[r].tolist())
        q64 = qdev[r].double()

        def rd64(p):
            return float(((pdev[p].double() - q64) ** 2).sum())
        edge = min(rd64(o) for o in missed)
        if max(rd64(p) for p in got) - edge > 4 * d * 2.0 ** -24 * edge:
            raise AssertionError(f"{label}: query {r} returned an id the "
                                 "oracle orders farther beyond f32 rounding")
        swaps += len(got)
    return 1.0 - swaps / n_ids, swaps


def phase_ball_knn(pt):
    """Config 1: the host-built tree, k=2 on the tiled ("auto") and the
    per-query schemes, every query against the f64 oracle."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(BALL_SEED)
    pts = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    qs = rng.normal(size=(BALL_Q, 2)).astype(np.float32)
    t0 = time.perf_counter()
    tree = pt.BallTree.euclidean(pts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if tree.builder != "vectorized":
        raise AssertionError(f"config 1 built on {tree.builder}")
    pdev, qdev = tree.points, torch.from_numpy(qs).cuda()
    _, oi = f64_oracle(pdev, qdev, BALL_K)
    for scheme in ("auto", "per_query"):
        (d, i), wall = timed(lambda: tree.query_batch(qdev, BALL_K,
                                                      scheme=scheme))
        _, _, stats = tree.query_batch(qdev, BALL_K, scheme=scheme,
                                       with_stats=True)
        if d.shape != (BALL_Q, BALL_K) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"ball_knn {scheme}: bad output")
        recall, swaps = check_tree_knn(pdev, qdev, i, oi, f"ball_knn {scheme}")
        emit("ball_knn", scheme=scheme,
             ran="tiled" if "n_tiles" in stats else "per_query", n=BALL_N,
             d=2, queries=BALL_Q, k=BALL_K,
             qps=BALL_Q / wall, batch_s=wall, recall=recall,
             boundary_swaps=swaps, loop_chunks=int(stats["loop_chunks"]),
             chunk_leaves=int(stats["chunk_leaves"]),
             n_leaves=int(stats["n_leaves"]), leaf_size=128,
             builder=tree.builder, build_s=build_s)
    emit("ball_knn", seconds=time.perf_counter() - t_phase)
    return qs


def phase_ball_radius(pt) -> None:
    """Config 4: capped lists (tiled and per-query), the count form and
    the mask form at each epsilon; counts equal across the forms, ids the
    mask's members."""
    from petal_neighbors_tpu_torch.ops.bruteforce import compact_mask

    t_phase = time.perf_counter()
    rng = np.random.default_rng(RADIUS_SEED)
    pts = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    tree = pt.BallTree.euclidean(pts)
    qdev = tree.points[:RADIUS_Q]
    for eps in RADIUS_EPS:
        row = {}
        mask, row["mask_s"] = timed(lambda: tree.query_radius_batch(qdev, eps))
        rowsum = mask.sum(1).to(torch.int32)
        counts = {}
        for scheme in ("tiled", "per_query"):
            (ids, cnt), row[f"{scheme}_s"] = timed(
                lambda: tree.query_radius_batch(qdev, eps, cap=RADIUS_CAP,
                                                scheme=scheme))
            counts[scheme] = cnt
            fits = torch.nonzero(cnt <= RADIUS_CAP).flatten()
            got = torch.sort(torch.where(ids[fits] >= 0, ids[fits],
                                         torch.iinfo(torch.int32).max),
                             dim=1).values
            want, _ = compact_mask(mask[fits], RADIUS_CAP)
            want = torch.where(want >= 0, want, torch.iinfo(torch.int32).max)
            if not bool(torch.equal(got, want)):
                raise AssertionError(f"ball_radius eps={eps} {scheme}: ids "
                                     "differ from the mask's members")
        cnt_only, row["count_s"] = timed(
            lambda: tree.query_radius_count_batch(qdev, eps))
        for name, c in (("tiled", counts["tiled"]),
                        ("per_query", counts["per_query"]),
                        ("count", cnt_only)):
            if not bool(torch.equal(c, rowsum)):
                raise AssertionError(f"ball_radius eps={eps}: {name} counts "
                                     "differ from the mask's")
        emit("ball_radius", eps=eps, n=BALL_N, d=2, queries=RADIUS_Q,
             cap=RADIUS_CAP, **{f"{k[:-2]}_qps": RADIUS_Q / v
                                for k, v in row.items()}, **row,
             members_per_query=float(rowsum.double().mean()),
             over_cap=int((rowsum > RADIUS_CAP).sum()))
    emit("ball_radius", seconds=time.perf_counter() - t_phase)


def phase_ball_device_build(pt, config1_queries):
    """The 1M-point "auto" build on the card against the host build, then
    config 1's queries on it against the f64 oracle.  Returns the
    device-built tree."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(BALL_SEED)
    pts = rng.normal(size=(BUILD_N, 2)).astype(np.float32)
    builds = []
    for _ in range(2):                       # cold, then warm
        t0 = time.perf_counter()
        tree = pt.BallTree.euclidean(pts)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    if tree.builder != "device":
        raise AssertionError(f"the 1M auto build took {tree.builder}")
    t0 = time.perf_counter()
    host = pt.BallTree.euclidean(pts, builder="vectorized")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not np.array_equal(tree.idx, host.idx):
        raise AssertionError("device build idx differs from the host's")
    # both sum in f64 (the card's atomics in any order): the f32 centroids
    # and radii may differ by an ulp or two
    def err(a, b):
        return float(((a - b).abs() / (1.0 + b.abs())).max())
    c_err = err(tree.nodes.centroids, host.nodes.centroids)
    r_err = err(tree.nodes.radii, host.nodes.radii)
    if c_err > BUILD_TOL or r_err > BUILD_TOL:
        raise AssertionError(f"device build geometry off: centroids "
                             f"{c_err}, radii {r_err}")
    qdev = torch.from_numpy(config1_queries).cuda()
    (d, i), wall = timed(lambda: tree.query_batch(qdev, BALL_K))
    _, oi = f64_oracle(tree.points, qdev, BALL_K)
    recall, swaps = check_tree_knn(tree.points, qdev, i, oi,
                                   "ball_device_build")
    emit("ball_device_build", n=BUILD_N, d=2, builder=tree.builder,
         device_build_s=builds, host_build_s=host_s, idx_equal=True,
         centroid_max_err=c_err, radius_max_err=r_err,
         tolerance=BUILD_TOL, queries=BALL_Q, k=BALL_K, qps=BALL_Q / wall,
         batch_s=wall, recall=recall, boundary_swaps=swaps,
         seconds=time.perf_counter() - t_phase)
    return tree


def phase_ball_highdim(pt) -> None:
    """65,536 x 40 uniform points: the per-query scan's matmul-form leaf
    scan and direct rescore, k=10 against the f64 oracle."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(HIGHDIM_SEED)
    pts = rng.random((HIGHDIM_N, HIGHDIM_D), dtype=np.float32)
    qs = rng.random((HIGHDIM_Q, HIGHDIM_D), dtype=np.float32)
    t0 = time.perf_counter()
    tree = pt.BallTree.euclidean(pts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qdev = torch.from_numpy(qs).cuda()
    (d, i), wall = timed(lambda: tree.query_batch(
        qdev, HIGHDIM_K, scheme="per_query"))
    _, _, stats = tree.query_batch(qdev, HIGHDIM_K, scheme="per_query",
                                   with_stats=True)
    _, oi = f64_oracle(tree.points, qdev, HIGHDIM_K)
    recall, swaps = check_tree_knn(tree.points, qdev, i, oi, "ball_highdim")
    emit("ball_highdim", n=HIGHDIM_N, d=HIGHDIM_D, queries=HIGHDIM_Q,
         k=HIGHDIM_K, scheme="per_query", qps=HIGHDIM_Q / wall,
         batch_s=wall, recall=recall, boundary_swaps=swaps,
         loop_chunks=int(stats["loop_chunks"]),
         n_leaves=int(stats["n_leaves"]),
         prune_ratio=float(stats["prune_ratio"].double().mean()),
         builder=tree.builder, build_s=build_s,
         seconds=time.perf_counter() - t_phase)


# ---- the vantage-point tree and the mutable index (PR 14) ------------------

#: the JAX package's config 2 (benchmarks/run.py:128-149): VantagePointTree
#: over 100k x 2 N(0,1) points, k=10, the first 1,000 and all 4,096 queries
VP_N, VP_Q, VP_K, VP_SEED, VP_BATCHES = 100_000, 4096, 10, 2, (1000, 4096)
#: the capped radius search's cap, and the dynamic mix: rows added and ids
#: removed (10% of the base, under the 0.25 rebuild threshold)
VP_CAP, DYN_ADD, DYN_REMOVE, DYN_EPS = 512, 5000, 5000, 0.05


def zero_launches(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def read_launches(wrappers) -> dict:
    return {s: w.launches for s, w in wrappers.items() if w.launches}


def hold_vp_kernels(tree, qdev, k: int, repaired: int) -> dict:
    """The VP route's capped and fold kernels against their plain versions
    at the shapes the route gives them (``hold_route_kernels``)."""
    return hold_route_kernels(*tree._kernel_tables(), qdev, tree.n,
                              tree.dim, k, repaired)


def hold_route_kernels(mu, pp, pn, planes, qdev, n: int, d: int, k: int,
                       repaired: int) -> dict:
    """The kernel route's capped and fold kernels against their plain
    versions at the shapes the route gives them (capped: the batch
    ``qdev``; fold: its repair, at least one query), timed beside the
    plain version, a library call and the bound.  ``mu``, ``pp``, ``pn``,
    ``planes`` are the route's centre, padded points, norms and piece
    planes over ``n`` real rows.  Launches here are not the path's."""
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    qc = qdev - mu
    out = {}
    for scheme in ("capped", "fold"):
        k_scan, tile, passes = kernel_args(scheme, k, n)
        qs = qc if scheme == "capped" else qc[:max(repaired, 1)]
        err, tied, plan = compare_kernel(scheme, pp, qs, pn, k_scan, tile,
                                         passes, tier_band=True)
        if scheme == "capped":
            run = lambda: kk.knn_capped(pp, qs, pn, k=k_scan, tile=tile,
                                        passes=passes, point_planes=planes)
            plain = lambda: kk.knn_capped_reference(
                pp, qs, pn, k=k_scan, tile=tile, passes=passes,
                splits=plan[0])
            bound, by = tc_bound_ms(n, qs.shape[0], d, k_scan)
        else:
            run = lambda: kk.knn_fold(pp, qs, pn, k=k_scan)
            plain = lambda: kk.knn_fold_reference(pp, qs, pn, k=k_scan)
            bound, by = bound_ms(n, qs.shape[0], d, k_scan)
        out[scheme] = {
            "n": n, "q": qs.shape[0], "d": d, "k": k_scan, "tile": tile,
            "passes": passes, "plan": list(plan), "max_abs_err": err,
            "tied_rows": tied, "ms": cuda_ms(run, reps=5, hold=True),
            "plain_ms": cuda_ms(plain, reps=1),
            "library_ms": cuda_ms(lambda: library_topk(pp[:n], qs, pn[:n],
                                                       k_scan), reps=2),
            "bound_ms": bound, "bound_by": by}
        if scheme == "fold":
            out[scheme]["path"] = kk.fold_path(qs.shape[0], k_scan, d, n)
    return out


def phase_vp_knn(pt, wrappers, fold_rows) -> dict:
    """Config 2: the host-built VP tree, k=10 on the first 1,000 and all
    4,096 queries under "auto" (the kernel route: capped with the fold
    repair), "per_query" and "tiled"; every query against the f64 oracle;
    then the route's kernels against their plain versions at this shape.
    Returns the launches of the "auto" runs, the kernels' rows, the tree
    and its queries."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(VP_SEED)
    pts = rng.normal(size=(VP_N, 2)).astype(np.float32)
    qs = rng.normal(size=(VP_Q, 2)).astype(np.float32)
    t0 = time.perf_counter()
    tree = pt.VantagePointTree.euclidean(pts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if tree.builder != "host":
        raise AssertionError(f"config 2 built on {tree.builder}")
    pdev, qdev = tree.points, torch.from_numpy(qs).cuda()
    _, oi = f64_oracle(pdev, qdev, VP_K)
    launches, repaired_max = {}, 0
    for nq in VP_BATCHES:
        q = qdev[:nq]
        for scheme in ("auto", "per_query", "tiled"):
            fold_rows.clear()
            zero_launches(wrappers)
            (d, i), wall = timed(lambda: tree.query_batch(q, VP_K,
                                                          scheme=scheme))
            got = read_launches(wrappers)
            row = {}
            if scheme == "auto":
                if not got.get("capped"):
                    raise AssertionError(f"vp_knn auto q={nq}: the capped "
                                         f"kernel did not run ({got})")
                for s, c in got.items():
                    launches[s] = launches.get(s, 0) + c
                row = {"launches_in_calls": got, "calls": 3,
                       "repaired_queries_per_call": list(fold_rows)}
                repaired_max = max([repaired_max] + fold_rows)
            else:
                if got:
                    raise AssertionError(f"vp_knn {scheme}: kernels ran "
                                         f"({got})")
                _, _, stats = tree.query_batch(q, VP_K, scheme=scheme,
                                               with_stats=True)
                row = {"loop_chunks": int(stats["loop_chunks"]),
                       "chunk_size": int(stats["chunk_size"]),
                       "n_subtrees": int(stats["n_subtrees"]),
                       "trunk_size": int(stats["trunk_size"])}
            if d.shape != (nq, VP_K) or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"vp_knn {scheme}: bad output")
            if not bool((d[:, 1:] >= d[:, :-1]).all()):
                raise AssertionError(f"vp_knn {scheme}: not ascending")
            recall, swaps = check_tree_knn(pdev, q, i, oi[:nq],
                                           f"vp_knn {scheme} q={nq}")
            emit("vp_knn", scheme=scheme, n=VP_N, d=2, queries=nq, k=VP_K,
                 qps=nq / wall, batch_s=wall, recall=recall,
                 boundary_swaps=swaps, builder=tree.builder,
                 build_s=build_s, **row)
    kernels = hold_vp_kernels(tree, qdev, VP_K, repaired_max)
    emit("vp_knn", kernels=kernels, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return {"launches": launches, "kernels": kernels, "tree": tree,
            "queries": qdev}


def phase_vp_sift(pt, points, qdev, oracle_ids, wrappers, fold_rows) -> dict:
    """The VP tree over the SIFT points at full width: "auto" builds on
    the card and answers all 10,240 queries at k=10 on the kernel route
    (capped and the fold repair); ids against the main phase's f64
    oracle.  Returns the launches."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tree = pt.VantagePointTree.euclidean(points)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if tree.builder != "device":
        raise AssertionError(f"the SIFT VP tree built on {tree.builder}")
    fold_rows.clear()
    zero_launches(wrappers)
    (d, i), wall = timed(lambda: tree.query_batch(qdev, VP_K), reps=3)
    got = read_launches(wrappers)
    repaired = list(fold_rows)
    if not got.get("capped"):
        raise AssertionError(f"vp_sift: the capped kernel did not run "
                             f"({got})")
    if d.shape != (N_Q, VP_K) or not bool(torch.isfinite(d).all()):
        raise AssertionError("vp_sift: bad output")
    recall, swaps = check_tree_knn(tree.points, qdev, i,
                                   oracle_ids[:, :VP_K], "vp_sift")
    kernels = hold_vp_kernels(tree, qdev, VP_K, max([0] + repaired))
    emit("vp_sift", n=N, d=DIM, queries=N_Q, k=VP_K, qps=N_Q / wall,
         batch_s=wall, recall=recall, boundary_swaps=swaps,
         launches_in_calls=got, calls=4, repaired_queries_per_call=repaired,
         builder=tree.builder, device_build_s=build_s, depth=tree.depth,
         kernels=kernels, seconds=time.perf_counter() - t_phase)
    return {"launches": got, "kernels": kernels}


def plain_radius_counts(pdev, qdev, r: float, strict: bool):
    """Direct-form counts within r, chunk by chunk on the card, and the
    pairs within 2 f32 ulp of r (where two forms may differ)."""
    rr = torch.tensor(r, dtype=torch.float32, device=qdev.device) ** 2
    tol = BOUNDARY_ULP * ulp32(float(rr))
    cnt = torch.zeros((qdev.shape[0],), dtype=torch.int64,
                      device=qdev.device)
    near = torch.zeros_like(cnt)
    for s in range(0, pdev.shape[0], 4096):
        diff = qdev[:, None, :] - pdev[None, s:s + 4096, :]
        rd = torch.sum(diff * diff, dim=-1)
        rd = torch.where(torch.isnan(rd), torch.inf, rd)
        cnt += torch.sum((rd < rr) if strict else (rd <= rr), dim=1)
        near += torch.sum((rd - rr).abs() <= tol, dim=1)
    return cnt, near


def check_radius(label, ids, cnt, want, near, member) -> None:
    """Counts equal to the plain ones except for pairs within 2 ulp of r;
    every listed id a member (``member(rows, ids)``)."""
    off = (cnt.long() - want).abs()
    if bool((off > near).any()):
        raise AssertionError(f"{label}: counts differ from the plain form "
                             "away from the boundary")
    listed = ids >= 0
    if not bool(torch.equal(listed.sum(1), torch.clamp_max(cnt, ids.shape[1]
                                                           ).long())):
        raise AssertionError(f"{label}: listed ids do not match the counts")
    rows = torch.nonzero(listed, as_tuple=True)
    if not bool(member(rows[0], ids[rows].long()).all()):
        raise AssertionError(f"{label}: a listed id is not a member")


def phase_vp_radius(pt) -> None:
    """Config 4's data on the VP tree: the capped search (cap 512) and the
    mask form at each epsilon, counts against a plain inclusive count."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(RADIUS_SEED)
    pts = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    tree = pt.VantagePointTree.euclidean(pts)
    pdev = tree.points
    qdev = pdev[:RADIUS_Q]
    for eps in RADIUS_EPS:
        (ids, cnt), capped_s = timed(lambda: tree.query_radius_batch(
            qdev, eps, cap=RADIUS_CAP))
        steps = tree.last_radius_steps
        mask, mask_s = timed(lambda: tree.query_radius_batch(qdev, eps))
        want, near = plain_radius_counts(pdev, qdev, eps, strict=False)
        check_radius(f"vp_radius eps={eps}", ids, cnt, want, near,
                     lambda r, c: mask[r, c])
        if bool(((mask.sum(1) - want).abs() > near).any()):
            raise AssertionError(f"vp_radius eps={eps}: mask differs from "
                                 "the plain form")
        emit("vp_radius", eps=eps, n=BALL_N, d=2, queries=RADIUS_Q,
             cap=RADIUS_CAP, capped_qps=RADIUS_Q / capped_s,
             capped_s=capped_s, mask_qps=RADIUS_Q / mask_s, mask_s=mask_s,
             loop_steps=steps, depth=tree.depth,
             members_per_query=float(want.double().mean()),
             over_cap=int((cnt > RADIUS_CAP).sum()),
             pairs_within_2ulp=int(near.sum()))
    emit("vp_radius", seconds=time.perf_counter() - t_phase)


def phase_vp_device_build(pt, config1_queries) -> None:
    """1M x 2: the device build cold and warm against the host build; the
    two number their nodes differently, so config 1's queries at k=10 on
    both trees' per-query scans must give equal distances, and ids equal
    away from ties."""
    from petal_neighbors_tpu_torch.trees.vantage_build_device import vp_shape

    t_phase = time.perf_counter()
    rng = np.random.default_rng(BALL_SEED)
    pts = rng.normal(size=(BUILD_N, 2)).astype(np.float32)
    builds = []
    vp_shape.cache_clear()                   # vp_sift built at this n
    for _ in range(2):                       # cold, then warm
        t0 = time.perf_counter()
        tree = pt.VantagePointTree.euclidean(pts)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    if tree.builder != "device":
        raise AssertionError(f"the 1M auto VP build took {tree.builder}")
    t0 = time.perf_counter()
    host = pt.VantagePointTree.euclidean(pts, builder="host")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    qdev = torch.from_numpy(config1_queries).cuda()
    out = {}
    for name, t in (("device", tree), ("host", host)):
        (d, i), wall = timed(lambda: t.query_batch(qdev, VP_K,
                                                   scheme="per_query"))
        out[name] = (d, i, wall)
    (dd, di, dwall), (hd, hi, hwall) = out["device"], out["host"]
    if not bool(torch.equal(dd, hd)):
        raise AssertionError("vp_device_build: the trees' distances differ")
    # ids may differ only between points at the same distance (within the
    # row, or at its k-th)
    tied = ((dd[:, None, :] == dd[:, :, None]).sum(2) > 1) | (
        dd == dd[:, -1:])
    if bool(((di != hi) & ~tied).any()):
        raise AssertionError("vp_device_build: ids differ away from ties")
    _, oi = f64_oracle(tree.points, qdev, VP_K)
    recall, swaps = check_tree_knn(tree.points, qdev, di, oi,
                                   "vp_device_build")
    emit("vp_device_build", n=BUILD_N, d=2, builder=tree.builder,
         device_build_s=builds, host_build_s=host_s, depth=tree.depth,
         queries=BALL_Q, k=VP_K, device_tree_qps=BALL_Q / dwall,
         host_tree_qps=BALL_Q / hwall, ids_differing_at_ties=int(
             (di != hi).sum()), recall=recall, boundary_swaps=swaps,
         seconds=time.perf_counter() - t_phase)


def phase_dynamic(pt) -> None:
    """``DynamicIndex`` over config 1's points: 5,000 rows added and 5,000
    ids removed (10% of the base, no rebuild), 10,000 queries at k=10
    against the f64 oracle over the live rows and the capped radius
    (strict, cap 512) against a plain strict count; then ``rebuild()``,
    timed, and both checks again."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(BALL_SEED)
    pts = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    qs = rng.normal(size=(BALL_Q, 2)).astype(np.float32)
    t0 = time.perf_counter()
    idx = pt.DynamicIndex(pts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    new = np.random.default_rng(BALL_SEED + 1).normal(
        size=(DYN_ADD, 2)).astype(np.float32)
    t0 = time.perf_counter()
    idx.add(new)
    gone = np.random.default_rng(BALL_SEED + 2).choice(
        BALL_N + DYN_ADD, DYN_REMOVE, replace=False)
    idx.remove(gone)
    mutate_s = time.perf_counter() - t0
    if idx._delta_rows == [] or len(idx._tombstones) != DYN_REMOVE:
        raise AssertionError("dynamic: the mutations rebuilt the index")
    qdev = torch.from_numpy(qs).cuda()
    by_id = np.full((BALL_N + DYN_ADD, 2), np.nan, dtype=np.float32)
    by_id[:BALL_N], by_id[BALL_N:] = pts, new
    by_id[gone] = np.nan                   # dead rows: never a member
    rows = torch.from_numpy(by_id).cuda()
    live = torch.from_numpy(np.setdiff1d(np.arange(len(by_id)), gone)).cuda()
    _, opos = f64_oracle(rows[live], qdev, VP_K)
    oracle_ids = live[opos]
    for stage in ("mutated", "rebuilt"):
        if stage == "rebuilt":
            t0 = time.perf_counter()
            idx.rebuild()
            torch.cuda.synchronize()
            rebuild_s = time.perf_counter() - t0
        (d, i), knn_s = timed(lambda: idx.query_batch(qdev, VP_K))
        if d.shape != (BALL_Q, VP_K) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"dynamic {stage}: bad output")
        recall, swaps = check_tree_knn(rows, qdev, i, oracle_ids,
                                       f"dynamic {stage}")
        (ids, cnt), radius_s = timed(lambda: idx.query_radius_batch(
            qdev, DYN_EPS, cap=VP_CAP))
        want, near = plain_radius_counts(rows, qdev, DYN_EPS, strict=True)
        rr = DYN_EPS ** 2 * (1 + 4 * 2.0 ** -24)

        def member(r, c):
            return ((rows[c] - qdev[r]) ** 2).sum(1) <= rr
        check_radius(f"dynamic {stage}", ids, cnt, want, near, member)
        emit("dynamic", stage=stage, n=BALL_N, d=2, added=DYN_ADD,
             removed=DYN_REMOVE, live=idx.num_points, queries=BALL_Q,
             k=VP_K, knn_qps=BALL_Q / knn_s, knn_s=knn_s, recall=recall,
             boundary_swaps=swaps, eps=DYN_EPS, cap=VP_CAP,
             radius_qps=BALL_Q / radius_s, radius_s=radius_s,
             members_per_query=float(want.double().mean()),
             over_cap=int((cnt > VP_CAP).sum()), build_s=build_s,
             mutate_s=mutate_s,
             **({"rebuild_s": rebuild_s} if stage == "rebuilt" else {}))
    emit("dynamic", seconds=time.perf_counter() - t_phase)


# ---- HDBSCAN and the dual-tree join --------------------------------------

MST_SOURCE = "petal_neighbors_tpu_torch/ops/cuda/csrc/mst_scan.cu"
MST_REPLACES = "petal_neighbors_tpu/trees/boruvka.py:330"
#: the JAX package's MST workload (benchmarks/mst_probe.py:47-48): 1M x 8
#: uniform f32, seed 0xB0, min_samples 5, and the weight sum it recorded
#: (BENCH_NOTES.md:722-723), an output to cross-check
MST_N, MST_D, MST_SEED, MST_K = 1_000_000, 8, 0xB0, 5
MST_WEIGHT_SUM, MST_SUM_RTOL = 186891.1277, 1e-6
#: the dense f64 Prim oracle's size (the same generator's first rows), the
#: core-distance sample, and the reduced shape (query rows x the full
#: corpus) of the plain version and the yardstick
MST_SMALL_N, MST_CORE_SAMPLE, MST_REDUCED_Q = 10_000, 4096, 16_384
#: an MST weight against its f64 re-derivation: the d rounded terms of the
#: f32 rd, the square of the core and two square roots, in f32 ulp
MST_ULP = 8.0
#: the capped kernel held to its plain version on this many of the core
#: pass's queries (a block is 131,072)
MST_HOLD_Q = 8192
#: the join cells: k; the kernel engine's self-join (d > 3); the sweep's
#: A-tree against config 1's tree at k > 16
JOIN_K, JOIN_KERNEL_N, JOIN_KERNEL_D, JOIN_KERNEL_SEED = 5, 300_000, 8, 8
SWEEP_NA, SWEEP_K, SWEEP_SEED = 20_000, 32, 20
#: mst_kernel_small: (n, d, labels, data, +inf cores, separate query
#: rows, dtype); n ragged against the 256-row stages and 64-query blocks.
#: data: small integers (exact sums, ties), "real" in [0, 1), or "wide",
#: exponents spread over 2^-12 to 2^12, where the fused f32 step and a
#: separately rounded one give other bits.  Float32 at d = 1 to 8 runs the
#: direct kernel, other d and float64 the tile kernel.
MST_CASES = (
    (1, 2, "distinct", "real", False, False, "f32"),
    (63, 3, "few", "int", False, False, "f32"),
    (65, 8, "distinct", "int", True, False, "f32"),
    (1000, 17, "few", "real", False, False, "f32"),
    (4097, 8, "few", "int", True, False, "f32"),
    (3001, 2, "single", "real", False, False, "f32"),
    (2049, 40, "few", "real", True, True, "f32"),
    (777, 3, "distinct", "int", False, True, "f32"),
    (1500, 8, "few", "int", True, False, "f64"),
    (300, 17, "single", "real", False, True, "f64"),
    (2500, 2, "few", "wide", False, False, "f32"),
    (2300, 8, "few", "wide", True, True, "f32"),
    (600, 8, "distinct", "wide", False, False, "f32"),
    (1300, 1, "few", "real", False, True, "f32"),
    (1100, 4, "few", "wide", False, False, "f32"),
    (700, 5, "few", "real", True, False, "f32"),
    (900, 6, "distinct", "wide", False, True, "f32"),
    (513, 7, "few", "real", False, False, "f32"),
    (640, 8, "few", "wide", False, False, "f64"),
)


def mst_instructions(d: int, dtype: str = "f32") -> int:
    """The scan's least instructions a pair, from csrc/mst_scan.cu.  In
    float32 (the direct kernel) a sub and one FFMA a feature (the fused
    step), then two max, the label compare, the compare with the running
    best (the label test folded into its predicate) and its two updates:
    2d + 6.  In float64 (the tile kernel) a sub, a mul and an add a
    feature, and the label's select besides: 3d + 7."""
    return 2 * d + 6 if dtype == "f32" else 3 * d + 7


def mst_bound_ms(nq: int, n: int, d: int, itemsize: int = 4):
    """The scan's least time: its instructions at the SIMT lanes' rate
    against each input read once and (bw, bj) written once."""
    ops = nq * n * mst_instructions(d) / PEAK_FP32_INSTR_S * 1e3
    byts = ((n + nq) * (d + 1) * itemsize + (n + nq) * 4
            + nq * (itemsize + 4)) / PEAK_BYTES_S * 1e3
    return (ops, "operations") if ops >= byts else (byts, "bytes")


def mst_case(rng, n, d, labels, data, inf_core, separate, dtype):
    """A scan input: rows (small integers give exact ties; "wide" rows
    spread their exponents), duplicated rows, core distances (some +inf),
    labels (all distinct, three large components, or one), and query rows
    (the corpus, or rows of their own with labels drawn from the
    corpus's)."""
    def rows(m):
        if data == "int":
            return rng.integers(-3, 4, size=(m, d))
        if data == "wide":
            return rng.standard_normal((m, d)) * 2.0 ** rng.integers(
                -12, 13, size=(m, d))
        return rng.random((m, d))
    pts = rows(n)
    if n > 8:
        pts[n // 2:n // 2 + 3] = pts[1]
    core = (rng.integers(0, 4, size=n) if data == "int"
            else rng.random(n) * 0.3)
    core_rd = (core * core).astype(np.float64)
    if inf_core:
        core_rd[::7] = np.inf
    comp = {"distinct": np.arange(n), "few": rng.integers(0, 3, size=n),
            "single": np.zeros(n)}[labels].astype(np.int32)
    if separate:
        nq = max(1, n // 2 + 5)
        q, cq = rows(nq), core_rd[rng.integers(0, n, size=nq)]
        compq = comp[rng.integers(0, n, size=nq)]
    else:
        q, cq, compq = pts, core_rd, comp
    dt = torch.float32 if dtype == "f32" else torch.float64
    dev = torch.device("cuda")
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev, dt)
    i = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return f(pts), f(core_rd), i(comp), f(q), f(cq), i(compq)


def same_bits(a, b) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


#: the rescore's shapes: (cell, index rows, d, queries, ids a query, block)
RESCORE_SHAPES = (
    ("sift1m.batch-k10", 1_000_000, 128, 10_000, 18, 16),
    ("gist1m.batch-k10", 1_000_000, 960, 1_000, 18, 1),
    ("glove100.batch-k10", 1_183_514, 100, 10_000, 18, 1),
    ("sift1m.batch-k100", 1_000_000, 128, 10_000, 108, 1),
    ("nytimes256.batch-k1000", 290_000, 256, 10_000, 1008, 1),
    ("sift1m.batch-k1000", 1_000_000, 128, 10_000, 1008, 1),
    ("sift1m.single-k10", 1_000_000, 128, 1, 18, 1))


def phase_rescore() -> dict:
    """The direct-form rescore (``rescore_kernel.rescore_rd``,
    ``csrc/rescore.cu``) at ``RESCORE_SHAPES``: random rows (bcap's with
    the index's norms and a padded tail), random int32 ids; the kernel's
    device time (held behind a sleep, so a short call is not timed at the
    host's launch rate) beside its byte bound (rows gathered, ids, queries
    and rdist, each once, at 3.35 TB/s) and its plain version's on the
    card.  Raises unless its +inf lie where the plain version's do and
    its rdist on the first 64 queries lie within ``rescore_rounding`` of
    a float64 sum of the same rounded differences' squares.  Returns the
    rows by cell."""
    from petal_neighbors_tpu_torch.ops.cuda import rescore_kernel as rk

    out = {}
    for cell, n, d, q, width, block in RESCORE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n + d + width)
        n_pad = -(-n // 64) * 64
        points = torch.rand((n_pad, d), generator=g, device="cuda") * 255.0
        norms = None
        if block > 1:
            points[n:] = 0.0
            norms = torch.sum(points * points, dim=1)
            norms[n:] = torch.inf
        queries = torch.rand((q, d), generator=g, device="cuda") * 255.0
        ids = torch.randint(0, -(-n_pad // block), (q, width), generator=g,
                            device="cuda", dtype=torch.int32)
        run = lambda: rk.rescore_rd(points, queries, ids, block=block,
                                    norms=norms)
        plain = lambda: rk.rescore_rd_reference(points, queries, ids,
                                                block=block, norms=norms)
        got, want = run(), plain()
        if not torch.equal(torch.isinf(got), torch.isinf(want)):
            raise AssertionError(f"rescore {cell}: +inf differ from the "
                                 "plain version's")
        fin = torch.isfinite(want)
        gap = float(torch.max(torch.abs(got[fin] - want[fin])
                              / want[fin]).item())
        head = min(q, 64)
        off = torch.arange(block, device="cuda", dtype=torch.int64)
        rows = (ids[:head].long()[:, :, None] * block + off).reshape(head, -1)
        ok = fin[:head]
        diff = queries[:head, None, :] - points[torch.where(ok, rows, 0)]
        oracle = torch.sum(diff.double() ** 2, dim=-1)
        vec = d % 4 == 0
        err = float(torch.max(torch.abs(got[:head].double() - oracle)[ok]
                              / oracle[ok]).item())
        if err > rk.rescore_rounding(d, torch.float32, vec):
            raise AssertionError(f"rescore {cell}: relative error {err} over "
                                 f"{rk.rescore_rounding(d, torch.float32, vec)}")
        del diff, oracle, want
        pairs = q * width * block
        bytes_ = 4 * (pairs * d + q * width + q * d + pairs)
        ms = cuda_ms(run, reps=5, hold=True)
        out[cell] = {
            "q": q, "width": width, "block": block, "d": d, "n": n,
            "plan": rk.rescore_plan(q, width * block, d, 4, vec,
                                    torch.cuda.get_device_properties(0)
                                    .multi_processor_count),
            "ms": ms, "plain_ms": cuda_ms(plain, reps=2),
            "bound_ms": bytes_ / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "bound_share": bytes_ / PEAK_BYTES_S * 1e3 / ms,
            "max_rel_err_f64": err, "max_rel_gap_plain": gap}
        emit("rescore", cell=cell, **out[cell])
        del points, norms, queries, ids, got
        torch.cuda.empty_cache()
    return out


def phase_mst_kernel_small() -> int:
    """The scan kernel against its plain version on the card, bit for bit
    in bw and bj, at MST_CASES.  Returns the cases held."""
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as mk

    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    for case in MST_CASES:
        args = mst_case(rng, *case)
        bw, bj = mk.scan_minout(*args)
        torch.cuda.synchronize()
        pw, pj = mk.scan_minout_reference(*args)
        if not (same_bits(bw, pw) and torch.equal(bj, pj)):
            bad = int(((bw != pw) | (bj != pj)).sum())
            raise AssertionError(f"mst scan kernel differs from its plain "
                                 f"version at {case}: {bad} rows")
        if case[2] == "single" and not (bool(torch.isinf(bw).all())
                                        and bool((bj == -1).all())):
            raise AssertionError(f"one component must give (+inf, -1): "
                                 f"{case}")
        emit("mst_kernel_small", n=case[0], d=case[1], labels=case[2],
             data=case[3], inf_core=case[4], separate_q=case[5],
             dtype=case[6], q=args[3].shape[0],
             finite_rows=int(torch.isfinite(bw).sum()), bits_equal=True)
    # a d = 8 float32 corpus (16-byte feature planes) as a view 4 bytes off
    # 16-byte alignment: the wrapper copies it for the direct kernel
    f32 = (2300, 8, "few", "wide", True, True, "f32")
    args = list(mst_case(np.random.default_rng(16), *f32))
    buf = torch.empty(args[0].numel() + 1, device=args[0].device)
    args[0] = buf[1:].view(args[0].shape).copy_(args[0])
    if args[0].data_ptr() % 16 == 0:
        raise AssertionError("the misaligned corpus view is aligned")
    bw, bj = mk.scan_minout(*args)
    pw, pj = mk.scan_minout_reference(*args)
    if not (same_bits(bw, pw) and torch.equal(bj, pj)):
        raise AssertionError(f"mst scan kernel differs from its plain "
                             f"version on a misaligned corpus at {f32}")
    emit("mst_kernel_small", n=f32[0], d=f32[1], misaligned_corpus=True,
         bits_equal=True)
    emit("mst_kernel_small", cases=len(MST_CASES) + 1,
         seconds=time.perf_counter() - t_phase)
    return len(MST_CASES) + 1


def f64_oracle_blocks(points_dev, queries_dev, k: int, qblock: int = 8192):
    """``f64_oracle`` over blocks of queries (a self-join's query count
    would make one (Q, chunk) f64 matrix too large)."""
    ds, ids = [], []
    for s in range(0, queries_dev.shape[0], qblock):
        d, i = f64_oracle(points_dev, queries_dev[s:s + qblock], k)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def kth_f64(pdev, rows, k: int, chunk: int = 32768):
    """The f64 direct-form k-th-NN distance of ``pdev[rows]`` against all
    of ``pdev`` (self included), summed feature by feature."""
    x = pdev.double()
    q = x[rows]
    best = None
    for s in range(0, x.shape[0], chunk):
        p = x[s:s + chunk]
        rd = torch.zeros((q.shape[0], p.shape[0]), dtype=torch.float64,
                         device=x.device)
        for f in range(x.shape[1]):
            t = q[:, f, None] - p[None, :, f]
            rd += t * t
        cand = rd if best is None else torch.cat([best, rd], dim=1)
        best = torch.topk(cand, k, dim=1, largest=False).values
    return best.amax(dim=1).sqrt()


def prim_f64(pdev, k: int):
    """The dense f64 mutual-reachability MST by Prim on the card: its
    n - 1 weights in the order Prim adds them."""
    x = pdev.double()
    n = x.shape[0]
    rd = torch.zeros((n, n), dtype=torch.float64, device=x.device)
    for f in range(x.shape[1]):
        t = x[:, f, None] - x[None, :, f]
        rd += t * t
    dist = rd.sqrt_()
    core = torch.kthvalue(dist, k, dim=1).values           # self included
    m = torch.maximum(dist, torch.maximum(core[:, None], core[None, :]))
    del dist, rd
    in_tree = torch.zeros(n, dtype=torch.bool, device=x.device)
    in_tree[0] = True
    best = m[0].clone()
    ws = torch.empty(n - 1, dtype=torch.float64, device=x.device)
    for t in range(n - 1):                  # no host read inside the loop
        masked = torch.where(in_tree, torch.inf, best)
        j = torch.argmin(masked).view(1)
        ws[t:t + 1] = masked.gather(0, j)
        in_tree.index_fill_(0, j, True)
        best = torch.minimum(best, m.index_select(0, j)[0])
    return ws


def library_minout(pts, core_rd, comp, q, cq, compq, chunk: int = 4096):
    """Yardstick for the scan: chunked ``torch.cdist`` in its direct mode
    (``donot_use_mm_for_euclid_dist``), squared, with the same max, label
    mask and a ``min`` over each chunk — timed here, used nowhere in the
    port."""
    bw = torch.full((q.shape[0],), torch.inf, dtype=pts.dtype,
                    device=pts.device)
    bj = torch.full((q.shape[0],), -1, dtype=torch.int64, device=pts.device)
    for s in range(0, pts.shape[0], chunk):
        dd = torch.cdist(q, pts[s:s + chunk],
                         compute_mode="donot_use_mm_for_euclid_dist")
        w = torch.maximum(torch.maximum(dd * dd, cq[:, None]),
                          core_rd[s:s + chunk][None, :])
        w = w.masked_fill(comp[s:s + chunk][None, :] == compq[:, None],
                          torch.inf)
        m, a = w.min(dim=1)
        better = m < bw
        bw = torch.where(better, m, bw)
        bj = torch.where(better, a + s, bj)
    return bw, bj


def timed_once(fn):
    """(fn's result, its device milliseconds by CUDA events), one call: a
    slow plain version or yardstick runs once and its output is kept."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def spanning(us, vs, n: int) -> bool:
    """Whether n - 1 edges join all n points (a spanning tree)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(us)), (us, vs)), shape=(n, n))
    return len(us) == n - 1 and connected_components(g, directed=False)[0] == 1


def mst_levers(pdev, core_rd, labels_seen, qn: int) -> list:
    """What two pruning levers of the scan would cover, round by round
    (printed only; the MST does not use them).  For each round r: the
    share of the (q x n) pairs inside one component under its labelling,
    sum of size^2 / n^2 (what skipping same-component pairs saves); and,
    for r and r + 1, the share of the first ``qn`` rows whose best j under
    labelling r still carries another label than the row's under r + 1
    (those rows keep (bw, bj) exactly, since the eligible rows only
    shrink), checked by a reduced launch under each labelling."""
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as mk

    n = pdev.shape[0]
    out = []
    for r, comp in enumerate(labels_seen):
        sizes = torch.bincount(comp.long() - int(comp.min())).double()
        row = {"round": r + 1, "components": int((sizes > 0).sum()),
               "same_component_share": float((sizes * sizes).sum()) / n / n}
        if r + 1 < len(labels_seen):
            nxt = labels_seen[r + 1]
            args = (pdev, core_rd, comp, pdev[:qn], core_rd[:qn], comp[:qn])
            bw, bj = mk.scan_minout(*args)
            bw2, bj2 = mk.scan_minout(pdev, core_rd, nxt, pdev[:qn],
                                      core_rd[:qn], nxt[:qn])
            found = bj >= 0
            keep = found & (nxt[bj.clamp_min(0).long()] != nxt[:qn])
            row["kept_share"] = float(keep.double().mean())
            row["kept_but_moved"] = int((keep & ((bw2 != bw) | (bj2 != bj)))
                                        .sum())
            if row["kept_but_moved"]:
                raise AssertionError(f"hdbscan levers: {row} — a kept row "
                                     "changed its edge")
        out.append(row)
    return out


def phase_hdbscan(pt, wrappers, fold_rows) -> dict:
    """The MST workload: ``mutual_reachability_mst`` over 1M x 8 points
    (seed 0xB0, k=5) on the card, its core distances (kernel route) and
    rounds (the scan kernel) timed as it runs; the MST's edges spanning,
    each weight against max(core_u, core_v, d(u, v)) in f64, 4,096 core
    distances against an f64 k-th NN, the weight sum beside the JAX
    package's; the host stages; then the 10,000-point MST against a dense
    f64 Prim, ``hdbscan`` end to end there, and the scan kernel and the
    core pass's capped and fold held to their plain versions."""
    from petal_neighbors_tpu_torch import cluster
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as mk
    from petal_neighbors_tpu_torch.ops.cuda.tc_planes import split_planes
    from petal_neighbors_tpu_torch.trees import boruvka as tb

    t_phase = time.perf_counter()
    pts = np.random.default_rng(MST_SEED).random((MST_N, MST_D),
                                                 dtype=np.float32)
    rec, round_ms, labels_seen = {}, [], []
    real_core, real_scan = tb._core_distances, tb.scan_minout

    def timed_core(p, *, k, **kw):
        before = {s: w.launches for s, w in wrappers.items()}
        fold_at = len(fold_rows)
        t0 = time.perf_counter()
        out = real_core(p, k=k, **kw)
        torch.cuda.synchronize()
        rec.update(core_s=time.perf_counter() - t0, core=out,
                   core_launches={s: w.launches - before[s]
                                  for s, w in wrappers.items()
                                  if w.launches - before[s]},
                   repairs=list(fold_rows[fold_at:]))
        return out

    def timed_scan(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_scan(*args)
        stop.record()
        stop.synchronize()
        round_ms.append(start.elapsed_time(stop))
        labels_seen.append(args[2])
        return out

    tb._core_distances, tb.scan_minout = timed_core, timed_scan
    try:
        zero_launches(wrappers)
        t0 = time.perf_counter()
        us, vs, ws = pt.mutual_reachability_mst(pts, MST_K)
        mst_s = time.perf_counter() - t0
        launches = read_launches(wrappers)
    finally:
        tb._core_distances, tb.scan_minout = real_core, real_scan
    rounds = [dict(r, kernel_ms=ms) for r, ms in zip(tb.last_rounds,
                                                     round_ms)]
    for need in ("capped", "mst_scan"):
        if not launches.get(need):
            raise AssertionError(f"hdbscan: the MST launched no {need}")
    if launches["mst_scan"] != len(rounds):
        raise AssertionError("hdbscan: one scan launch a round expected")

    # ---- the MST against f64 re-derivations ----
    if not spanning(us, vs, MST_N):
        raise AssertionError("hdbscan: the edges do not span the points")
    pdev = torch.from_numpy(pts).cuda()
    core = rec["core"]
    u_t, v_t = torch.from_numpy(us).cuda(), torch.from_numpy(vs).cuda()
    d64 = (pdev[u_t].double() - pdev[v_t].double()).pow(2).sum(1).sqrt()
    c64 = core.double()
    w64 = torch.maximum(d64, torch.maximum(c64[u_t], c64[v_t]))
    w_err = float(((torch.from_numpy(ws).cuda() - w64).abs()
                   / w64.clamp_min(1e-30)).max()) / 2.0 ** -24
    if w_err > MST_ULP:
        raise AssertionError(f"hdbscan: an edge weight is {w_err} ulp from "
                             "its f64 re-derivation")
    sample = torch.from_numpy(np.random.default_rng(MST_SEED + 1).choice(
        MST_N, MST_CORE_SAMPLE, replace=False)).cuda()
    core64 = kth_f64(pdev, sample, MST_K)
    core_err = float(((core[sample].double() - core64).abs()
                      / core64.clamp_min(1e-30)).max()) / 2.0 ** -24
    if core_err > MST_ULP:
        raise AssertionError(f"hdbscan: a core distance is {core_err} ulp "
                             "from the f64 k-th NN")
    weight_sum = float(ws.sum())
    sum_rel = abs(weight_sum - MST_WEIGHT_SUM) / MST_WEIGHT_SUM
    if sum_rel > MST_SUM_RTOL:
        raise AssertionError(f"hdbscan: weight sum {weight_sum} against "
                             f"{MST_WEIGHT_SUM}")

    # ---- the host stages ----
    stages = {}
    t0 = time.perf_counter()
    z = cluster.single_linkage(us, vs, ws, MST_N)
    stages["single_linkage_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ct = cluster.condense_tree(z, MST_K)
    stages["condense_tree_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels, probs, _ = cluster.extract_clusters(ct)
    stages["extract_clusters_s"] = time.perf_counter() - t0
    if labels.shape != (MST_N,) or not np.all((probs >= 0) & (probs <= 1)):
        raise AssertionError("hdbscan: bad labels or probabilities")
    round_s = sum(r["round_s"] for r in rounds)
    host_s = sum(r["host_s"] for r in rounds)
    emit("hdbscan", n=MST_N, d=MST_D, k=MST_K, seed=MST_SEED,
         mst_s=mst_s, core_s=rec["core_s"], rounds_s=round_s,
         rounds_host_s=host_s, round_count=len(rounds),
         kernel_ms_per_round=[r["kernel_ms"] for r in rounds],
         round_s_per_round=[r["round_s"] for r in rounds],
         host_s_per_round=[r["host_s"] for r in rounds],
         edges_per_round=[r["edges"] for r in rounds],
         core_launches=rec["core_launches"], core_repairs=rec["repairs"],
         launches=launches, edges=len(us), spanning=True,
         weight_max_ulp=w_err, core_sample=MST_CORE_SAMPLE,
         core_max_ulp=core_err, weight_sum=weight_sum,
         weight_sum_reference=MST_WEIGHT_SUM, weight_sum_rel=sum_rel,
         clusters=int(labels.max() + 1), noise=int((labels < 0).sum()),
         host_stages_s=stages)

    # ---- the kernels of this path against their plain versions ----
    kernel_ms = float(np.mean(round_ms))
    comp = labels_seen[len(labels_seen) // 2]       # a mid-run labelling
    core_rd = core * core
    qn = MST_REDUCED_Q
    args = (pdev, core_rd, comp, pdev[:qn], core_rd[:qn], comp[:qn])
    bw, bj = mk.scan_minout(*args)
    (pw, pj), plain_ms = timed_once(lambda: mk.scan_minout_reference(*args))
    if not (same_bits(bw, pw) and torch.equal(bj, pj)):
        raise AssertionError("mst scan kernel differs from its plain "
                             "version at the reduced shape")
    (lw, lj), library_ms = timed_once(lambda: library_minout(*args))
    reduced = {
        "q": qn, "n": MST_N, "d": MST_D,
        "ms": cuda_ms(lambda: mk.scan_minout(*args), reps=3),
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_w_max_rel": float(((lw - bw).abs()
                                    / bw.clamp_min(1e-30)).max()),
        "library_j_differs": int((lj != bj).sum()),
        "bound_ms": mst_bound_ms(qn, MST_N, MST_D)[0]}
    reduced["bound_share"] = reduced["bound_ms"] / reduced["ms"]
    bound, by = mst_bound_ms(MST_N, MST_N, MST_D)
    scan_row = {"ms": kernel_ms, "bound_ms": bound, "bound_by": by,
                "bound_share": bound / kernel_ms,
                "plain_ms": reduced["plain_ms"],
                "library_ms": reduced["library_ms"], "max_abs_err": 0.0,
                "reduced": reduced,
                "instructions_per_pair": mst_instructions(MST_D)}
    emit("hdbscan", scan_ms_per_round=kernel_ms, scan_bound_ms=bound,
         scan_bound_share=scan_row["bound_share"],
         reduced_ms=reduced["ms"], reduced_bound_share=reduced["bound_share"],
         levers=mst_levers(pdev, core_rd, labels_seen, qn))
    mu, pp, pn, _ = bf.prepare_euclidean_index(pdev)
    held = hold_route_kernels(mu, pp, pn, split_planes(pp),
                              pdev[:MST_HOLD_Q], MST_N, MST_D, MST_K,
                              max([0] + rec["repairs"]))
    del mu, pp, pn

    # ---- 10,000 points against the dense f64 Prim ----
    small = pts[:MST_SMALL_N]
    t0 = time.perf_counter()
    us2, vs2, ws2 = pt.mutual_reachability_mst(small, MST_K)
    small_s = time.perf_counter() - t0
    prim = torch.sort(prim_f64(torch.from_numpy(small).cuda(), MST_K)).values
    mine = torch.sort(torch.from_numpy(ws2).cuda()).values
    small_err = float(((mine - prim).abs() / prim.clamp_min(1e-30)).max()
                      ) / 2.0 ** -24
    total_rel = abs(float(mine.sum()) - float(prim.sum())) / float(prim.sum())
    if not spanning(us2, vs2, MST_SMALL_N) or small_err > MST_ULP \
            or total_rel > MST_SUM_RTOL:
        raise AssertionError(f"hdbscan small: against Prim {small_err} ulp, "
                             f"total {total_rel}")
    # the dual engine (a caller's knob, plain PyTorch on the card)
    t0 = time.perf_counter()
    us3, vs3, ws3 = pt.mutual_reachability_mst(small, MST_K, scheme="dual")
    dual_s = time.perf_counter() - t0
    dual_err = float(((torch.sort(torch.from_numpy(ws3).cuda()).values - prim)
                      .abs() / prim.clamp_min(1e-30)).max()) / 2.0 ** -24
    if not spanning(us3, vs3, MST_SMALL_N) or dual_err > MST_ULP:
        raise AssertionError(f"hdbscan small, dual: {dual_err} ulp from Prim")
    t0 = time.perf_counter()
    res = pt.hdbscan(small, MST_K)
    hd_s = time.perf_counter() - t0
    emit("hdbscan", n=MST_SMALL_N, mst_s=small_s,
         weights_max_ulp_vs_prim=small_err, total_rel_vs_prim=total_rel,
         dual_mst_s=dual_s, dual_weights_max_ulp_vs_prim=dual_err,
         total=float(mine.sum()), hdbscan_s=hd_s,
         clusters=int(res.labels.max() + 1),
         noise=int((res.labels < 0).sum()), scan_kernel=scan_row,
         held=held,
         seconds=time.perf_counter() - t_phase)
    return {"scan": scan_row, "launches": launches,
            "core_launches": rec["core_launches"], "held": held,
            "weights": ws}


def phase_dual_join(pt, wrappers) -> dict:
    """``dual_tree_knn`` on each engine against the f64 oracle: the tree
    engine on config 1's self-join (k=5), the kernel engine on a 300k x 8
    self-join (k=5), the leaf-pair sweep with a 20,000-point A-tree
    against config 1's tree at k=32; and ``query_tree`` once."""
    from petal_neighbors_tpu_torch.trees import dual

    t_phase = time.perf_counter()
    ran = {"_join_via_kernel": 0, "_join_via_tree": 0, "_dual_knn": 0}
    real = {name: getattr(dual, name) for name in ran}

    def counted(name):
        def run(*a, **kw):
            ran[name] += 1
            return real[name](*a, **kw)
        return run

    for name in ran:
        setattr(dual, name, counted(name))
    out = {}
    try:
        rng = np.random.default_rng(BALL_SEED)
        config1 = pt.BallTree.euclidean(
            rng.normal(size=(BALL_N, 2)).astype(np.float32))
        rng = np.random.default_rng(JOIN_KERNEL_SEED)
        wide = pt.BallTree.euclidean(rng.random(
            (JOIN_KERNEL_N, JOIN_KERNEL_D), dtype=np.float32))
        rng = np.random.default_rng(SWEEP_SEED)
        small_a = pt.BallTree.euclidean(
            rng.normal(size=(SWEEP_NA, 2)).astype(np.float32))
        for engine, ta, tb_, k in (
                ("_join_via_tree", config1, config1, JOIN_K),
                ("_join_via_kernel", wide, wide, JOIN_K),
                ("_dual_knn", small_a, config1, SWEEP_K)):
            for name in ran:
                ran[name] = 0
            zero_launches(wrappers)
            (d, i), wall = timed(lambda: pt.dual_tree_knn(ta, tb_, k),
                                 reps=1)
            launches = read_launches(wrappers)
            took = {name for name, c in ran.items() if c}
            if took != {engine}:
                raise AssertionError(f"dual_join: {engine} expected, ran "
                                     f"{sorted(took)}")
            if d.shape != (ta.n, k) or not bool(torch.isfinite(d).all()) \
                    or not bool((d[:, 1:] >= d[:, :-1]).all()):
                raise AssertionError(f"dual_join {engine}: bad output")
            _, oi = f64_oracle_blocks(tb_.points, ta.points, k)
            recall, swaps = check_tree_knn(tb_.points, ta.points, i, oi,
                                           f"dual_join {engine}")
            row = {"engine": engine, "n_a": ta.n, "n_b": tb_.n, "d": ta.dim,
                   "k": k, "self_join": ta is tb_, "wall_s": wall,
                   "qps": ta.n / wall, "recall": recall,
                   "boundary_swaps": swaps, "launches": launches}
            if engine == "_dual_knn":
                row["sweep"] = dict(dual.last_sweep)
            if engine == "_join_via_tree":
                d2, i2 = config1.query_tree(config1, k)
                if not (torch.equal(d2, d) and torch.equal(i2, i)):
                    raise AssertionError("query_tree differs from "
                                         "dual_tree_knn")
                row["query_tree_equal"] = True
            emit("dual_join", **row)
            out[engine] = row
        if not out["_join_via_kernel"]["launches"].get("capped"):
            raise AssertionError("dual_join: the kernel engine launched no "
                                 "capped kernel")
    finally:
        for name, fn in real.items():
            setattr(dual, name, fn)
    emit("dual_join", seconds=time.perf_counter() - t_phase)
    return out


# ---- the adapters and the utilities ---------------------------------------

#: the requests of ``bf.knn(backend="auto")`` on the uncentred SIFT points
#: and the scheme each must take (``pick_scheme(k, n, bcap_planes=False)``)
ROUTE_K = {10: "capped", 100: "capped", 2000: "merge"}
#: the flat knn's fault case: N(10^4, 1) rows at d = 64, seed 13
FAULT_N, FAULT_Q, FAULT_D, FAULT_K, FAULT_SEED = 5_000, 300, 64, 5, 13
FAULT_OFFSET = 1e4
#: DynamicIndex off the origin: N(10^3, 1) f32 rows at d = 64, seed 16; the
#: first DYN64_BASE build it, the rest are added, DYN64_REMOVE ids removed
DYN64_N, DYN64_BASE, DYN64_D, DYN64_SEED = 200_000, 180_000, 64, 16
DYN64_OFFSET, DYN64_REMOVE, DYN64_Q, DYN64_K = 1e3, 2_000, 1_024, 10
#: NearestNeighbors.kneighbors' requests on the SIFT points and the scheme
#: each must take (BruteForce's, with bcap planes at 1M x 128)
SKLEARN_K = {10: "bcap", 100: "capped"}
#: serving: single submits, the group sizes they are flushed in, k, and
#: the scheme each flush must run
SERVE_N, SERVE_GROUPS, SERVE_K = 1_000, (1, 10, 100, 1_000), 10
SERVE_SCHEME = "bcap"
#: the DBSCAN example on config 4's points
EX_EPS, EX_MIN_SAMPLES = 0.05, 10
#: bcap's entry function as the profiler names it (MODE_BCAP = 2 in
#: knn_fold.cu), demangled or not
BCAP_KERNEL = r"knn_kernel(<2,|ILi2E)"


def host_bits_equal(a, b) -> bool:
    """Two arrays or tensors equal bit for bit, dtype and shape included."""
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def phase_knn_route(index, pdev, qdev, oracles, flat_qps, wrappers,
                    fold_rows) -> dict:
    """``bf.knn`` with backend "auto" on the SIFT points as users pass
    them (uncentred): it centres them and takes the kernel route (capped
    at k=10 and 100 on all queries, merge at k=2000 on the first 2,048,
    fold repairs); ids against the main phases' f64 oracles.  Then the
    fault case on both backends, recall 1.0 against f64.  Returns the
    launches of the SIFT calls."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf

    t_phase = time.perf_counter()
    launches = {}
    for k, scheme in ROUTE_K.items():
        qs = qdev if k < 1000 else qdev[:N_Q_LARGE]
        fold_rows.clear()
        zero_launches(wrappers)
        (d, i), wall = timed(lambda: bf.knn(pdev, qs, k))
        got = read_launches(wrappers)
        if not got.get(scheme):
            raise AssertionError(f"knn_route k={k}: no {scheme} kernel "
                                 f"ran ({got})")
        for s, c in got.items():
            launches[s] = launches.get(s, 0) + c
        if d.shape != (qs.shape[0], k) or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"knn_route k={k}: bad output")
        if not bool((d[:, 1:] >= d[:, :-1]).all()):
            raise AssertionError(f"knn_route k={k}: not ascending")
        recall, swaps, worst = check_vs_oracle(index, pdev, qs, i,
                                               oracles[k][:, :k])
        emit("knn_route", k=k, scheme=scheme, queries=qs.shape[0],
             qps=qs.shape[0] / wall, batch_s=wall,
             bruteforce_qps=flat_qps[k], launches_in_calls=got, calls=3,
             repaired_queries_per_call=list(fold_rows), recall=recall,
             boundary_swaps=swaps, worst_swap_gap_over_band=worst)
    if not launches.get("fold"):
        raise AssertionError("knn_route: no fold repair ran")

    rng = np.random.default_rng(FAULT_SEED)
    fp = torch.from_numpy((rng.normal(size=(FAULT_N, FAULT_D))
                           + FAULT_OFFSET).astype(np.float32)).cuda()
    fq = torch.from_numpy((rng.normal(size=(FAULT_Q, FAULT_D))
                           + FAULT_OFFSET).astype(np.float32)).cuda()
    c64 = fp.double().mean(0)
    rd64 = ((fq.double() - c64)[:, None, :]
            - (fp.double() - c64)[None]).pow(2).sum(-1)
    want = torch.topk(rd64, FAULT_K, dim=1, largest=False).indices
    for backend in ("auto", "xla"):
        zero_launches(wrappers)
        (d, i), wall = timed(lambda: bf.knn(fp, fq, FAULT_K,
                                            backend=backend), reps=1)
        got = read_launches(wrappers)
        # both backends rescore through the rescore kernel; only "auto"
        # scans on a kernel
        scanned = any(c for s, c in got.items() if s != "rescore")
        if scanned != (backend == "auto") or not got.get("rescore"):
            raise AssertionError(f"knn_route fault case {backend}: "
                                 f"launches {got}")
        a = torch.sort(i.long(), dim=1).values
        b = torch.sort(want, dim=1).values
        recall = float((a == b).double().mean())
        if recall != 1.0:
            raise AssertionError(f"knn_route fault case {backend}: recall "
                                 f"{recall}")
        emit("knn_route", case="fault", n=FAULT_N, d=FAULT_D,
             offset=FAULT_OFFSET, queries=FAULT_Q, k=FAULT_K,
             backend=backend, recall=recall, launches_in_calls=got,
             batch_s=wall)
    emit("knn_route", launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_sklearn(pt, index, points, queries, qdev, flat_radius,
                  wrappers) -> dict:
    """``NearestNeighbors`` on the card: fitted on the SIFT points it
    takes ``BruteForce``, and ``kneighbors`` at k=10 (bcap) and 100
    (capped) equals ``query_batch`` bit for bit; ``kneighbors_graph``;
    ``radius_neighbors`` on the first 1,024 queries at radius_flat's r
    against the mask's row sums; config 1's self-query (k=5, the ball
    tree) against the f64 oracle of k=6 less each point itself; config
    4's ``radius_neighbors_graph`` at eps 0.05 against a plain count.
    Returns the launches of the kneighbors calls."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    nn = pt.NearestNeighbors(n_neighbors=10).fit(points)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if not isinstance(nn._index, pt.BruteForce):
        raise AssertionError("sklearn: auto did not choose brute on SIFT")
    launches = {}
    for k, scheme in SKLEARN_K.items():
        zero_launches(wrappers)
        (d, i), wall = timed(lambda: nn.kneighbors(queries, k))
        got = read_launches(wrappers)
        if not got.get(scheme):
            raise AssertionError(f"sklearn k={k}: no {scheme} kernel ran "
                                 f"({got})")
        for s, c in got.items():
            launches[s] = launches.get(s, 0) + c
        want_d, want_i = index.query_batch(qdev, k)
        if not (i.dtype == np.int64 and host_bits_equal(d, want_d)
                and host_bits_equal(i, want_i.long())):
            raise AssertionError(f"sklearn k={k}: kneighbors differs from "
                                 "BruteForce.query_batch")
        emit("sklearn", call="kneighbors", n=N, d=DIM, k=k, queries=N_Q,
             qps=N_Q / wall, seconds=wall, launches_in_calls=got, calls=3,
             equal_to_query_batch=True, fit_s=fit_s)
    g, graph_s = timed(lambda: nn.kneighbors_graph(queries), reps=1,
                       warm=False)
    if g.shape != (N_Q, N) or g.nnz != N_Q * 10:
        raise AssertionError(f"sklearn: kneighbors_graph {g.shape} "
                             f"nnz {g.nnz}")
    emit("sklearn", call="kneighbors_graph", k=10, queries=N_Q,
         qps=N_Q / graph_s, seconds=graph_s, nnz=int(g.nnz))

    r, rowsum, near = flat_radius
    q1 = queries[:RADIUS_FLAT_Q]
    (rd, rids), radius_s = timed(lambda: nn.radius_neighbors(q1, r),
                                 reps=1, warm=False)
    got = torch.tensor([len(x) for x in rids])
    if bool(((got - rowsum.cpu()).abs() > near.cpu()).any()):
        raise AssertionError("sklearn: radius_neighbors counts differ from "
                             "the mask's away from the boundary")
    far = max((float(x.max()) for x in rd if len(x)), default=0.0)
    if far > r + 2 * ulp32(r):
        raise AssertionError(f"sklearn: a radius neighbour at {far} > {r}")
    emit("sklearn", call="radius_neighbors", n=N, d=DIM, radius=r,
         queries=RADIUS_FLAT_Q, qps=RADIUS_FLAT_Q / radius_s,
         seconds=radius_s, members_per_query=float(got.double().mean()),
         pairs_within_2ulp=int(near.sum()))
    del nn, g, rd, rids
    torch.cuda.empty_cache()

    rng = np.random.default_rng(BALL_SEED)
    pts1 = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    nn1 = pt.NearestNeighbors().fit(pts1)
    if not isinstance(nn1._index, pt.BallTree):
        raise AssertionError("sklearn: auto did not choose ball_tree at d=2")
    (d1, i1), self_s = timed(lambda: nn1.kneighbors(n_neighbors=5), reps=1)
    rows = np.arange(BALL_N)
    if (i1 == rows[:, None]).any():
        raise AssertionError("sklearn: a self-query row holds its own id")
    p1 = nn1._index.points
    _, oi = f64_oracle_blocks(p1, p1, 6)
    oi = oi.cpu().numpy()
    own = oi == rows[:, None]
    drop = np.where(own.any(axis=1), own.argmax(axis=1), 5)
    keep = np.ones_like(oi, dtype=bool)
    keep[rows, drop] = False
    recall, swaps = check_tree_knn(
        p1, p1, torch.from_numpy(i1).cuda(),
        torch.from_numpy(oi[keep].reshape(BALL_N, 5)).cuda(),
        "sklearn self-query")
    emit("sklearn", call="kneighbors(X=None)", n=BALL_N, d=2, k=5,
         queries=BALL_N, qps=BALL_N / self_s, seconds=self_s,
         recall=recall, boundary_swaps=swaps)

    rng = np.random.default_rng(RADIUS_SEED)
    pts4 = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    nn4 = pt.NearestNeighbors(radius=EX_EPS).fit(pts4)
    g4, g4_s = timed(lambda: nn4.radius_neighbors_graph(pts4[:RADIUS_Q]),
                     reps=1)
    p4 = nn4._index.points
    want, near4 = plain_radius_counts(p4, p4[:RADIUS_Q], EX_EPS,
                                      strict=False)
    cnt = torch.from_numpy(np.diff(g4.indptr)).cuda()
    if g4.shape != (RADIUS_Q, BALL_N) or bool(
            ((cnt - want).abs() > near4).any()):
        raise AssertionError("sklearn: radius_neighbors_graph differs from "
                             "the plain count")
    qi = torch.from_numpy(np.repeat(np.arange(RADIUS_Q), np.diff(
        g4.indptr))).cuda()
    rd4 = ((p4[qi].double() - p4[torch.from_numpy(g4.indices).cuda()]
            .double()) ** 2).sum(1)
    if bool((rd4 > EX_EPS ** 2 * (1 + 4 * 2.0 ** -24)).any()):
        raise AssertionError("sklearn: radius_neighbors_graph lists a "
                             "non-member")
    emit("sklearn", call="radius_neighbors_graph", n=BALL_N, d=2,
         radius=EX_EPS, queries=RADIUS_Q, qps=RADIUS_Q / g4_s,
         seconds=g4_s, nnz=int(g4.nnz), launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


def phase_serving(pt, index, queries, qdev, wrappers) -> dict:
    """A ``QueryStream`` over the SIFT index at k=10: 1,000 single submits
    flushed in groups of 1, 10, 100 and 1,000, each group one
    ``query_batch``; the answers equal one ``query_batch``'s rows bit for
    bit.  Returns the launches of each group size's run."""
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    t_phase = time.perf_counter()
    want_d, want_i = index.query_batch(qdev[:SERVE_N], SERVE_K)
    out = {}
    for g in SERVE_GROUPS:
        stream = pt.QueryStream(index, SERVE_K)
        zero_launches(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = []
        for s in range(0, SERVE_N, g):
            handles = [stream.submit(queries[j]) for j in range(s, s + g)]
            res.extend(h.result() for h in handles)
        wall = time.perf_counter() - t0
        got = read_launches(wrappers)
        # a flush of few queries takes the fold route on the few-query
        # kernel
        k_scan = bf.scan_width(SERVE_SCHEME, SERVE_K, N)
        ran = ("few" if kk.fold_path(g, k_scan, DIM, index._pts.shape[0])
               == "few" else SERVE_SCHEME)
        if not got.get(ran):
            raise AssertionError(f"serving group {g}: no {ran} kernel ran")
        ids = np.stack([r[0] for r in res])
        ds = np.stack([r[1] for r in res])
        if not (host_bits_equal(ids, want_i.long())
                and host_bits_equal(ds, want_d)):
            raise AssertionError(f"serving group {g}: answers differ from "
                                 "one query_batch")
        flushes = SERVE_N // g
        out[g] = got
        emit("serving", group=g, queries=SERVE_N, k=SERVE_K,
             flushes=flushes, seconds=wall,
             ms_per_query=wall * 1e3 / SERVE_N,
             launches_per_flush={s: c / flushes for s, c in got.items()},
             equal_to_query_batch=True)
    emit("serving", seconds=time.perf_counter() - t_phase)
    return out


def scratch_dir():
    """A temporary directory under the checkout's ignored build/, deleted
    when its ``with`` block ends."""
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=root)


def phase_profiling(index, qdev) -> None:
    """``utils.profiling.trace`` around one SIFT k=10 ``query_batch``: the
    exported Chrome trace must exist and name the bcap kernel; the traced
    kernels' device time, and ``wall_time`` of the same call."""
    import re

    from petal_neighbors_tpu_torch.utils.profiling import trace, wall_time

    index.query_batch(qdev, SERVE_K)
    torch.cuda.synchronize()
    with scratch_dir() as tmp:
        with trace(tmp):
            index.query_batch(qdev, SERVE_K)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    bcap = [e for e in events if re.search(BCAP_KERNEL, e.get("name", ""))]
    if not bcap:
        raise AssertionError("profiling: the trace names no bcap kernel")
    timing = {}
    with wall_time(timing) as o:
        o["result"] = index.query_batch(qdev, SERVE_K)
    emit("profiling", k=SERVE_K, queries=N_Q, trace_bytes=trace_bytes,
         kernels_traced=len(kernels),
         kernel_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
         bcap_kernel=bcap[0]["name"][:60],
         bcap_ms=sum(e.get("dur", 0) for e in bcap) / 1e3,
         wall_time_s=timing["seconds"])


def phase_dynamic_d64(pt):
    """``DynamicIndex`` at d = 64 off the origin: 180,000 rows build it,
    20,000 are added and 2,000 ids removed (no rebuild), and 1,024
    queries at k=10 must find the f64 oracle's ids over the live rows
    exactly.  Returns the index and its queries."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(DYN64_SEED)
    rows = (rng.normal(size=(DYN64_N, DYN64_D))
            + DYN64_OFFSET).astype(np.float32)
    qs = (rng.normal(size=(DYN64_Q, DYN64_D))
          + DYN64_OFFSET).astype(np.float32)
    t0 = time.perf_counter()
    idx = pt.DynamicIndex(rows[:DYN64_BASE])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add(rows[DYN64_BASE:])
    gone = rng.choice(DYN64_N, DYN64_REMOVE, replace=False)
    idx.remove(gone)
    mutate_s = time.perf_counter() - t0
    if not idx._delta_rows or len(idx._tombstones) != DYN64_REMOVE:
        raise AssertionError("dynamic d64: the mutations rebuilt the index")
    qdev = torch.from_numpy(qs).cuda()
    (d, i), knn_s = timed(lambda: idx.query_batch(qdev, DYN64_K), reps=1)
    if d.shape != (DYN64_Q, DYN64_K) or not bool(torch.isfinite(d).all()):
        raise AssertionError("dynamic d64: bad output")
    by_id = torch.from_numpy(rows).cuda()
    live = torch.from_numpy(np.setdiff1d(np.arange(DYN64_N), gone)).cuda()
    c64 = by_id[live].double().mean(0)
    _, opos = f64_oracle(by_id[live].double() - c64, qdev.double() - c64,
                         DYN64_K)
    recall, swaps = check_tree_knn(by_id, qdev, i, live[opos],
                                   "dynamic d64")
    if swaps:
        raise AssertionError(f"dynamic d64: recall {recall}")
    emit("dynamic", stage="d64 mutated", n=DYN64_BASE, d=DYN64_D,
         offset=DYN64_OFFSET, added=DYN64_N - DYN64_BASE,
         removed=DYN64_REMOVE, live=idx.num_points, queries=DYN64_Q,
         k=DYN64_K, knn_qps=DYN64_Q / knn_s, knn_s=knn_s, recall=recall,
         build_s=build_s, mutate_s=mutate_s,
         seconds=time.perf_counter() - t_phase)
    return idx, qdev


def _index_arrays(kind: str, index) -> dict:
    """The arrays ``save_index`` keeps of an index, and for a flat index
    the layout its load prepares again, by name."""
    if kind == "brute":
        return {"points": index.points, "center": index._center,
                "ppad": index._pts, "pnorm": index._norms,
                "bad": index._invalid}
    if kind == "dynamic":
        base = index._base
        return {"points": index._base_rows, "idx": base.idx,
                "centroids": base.nodes.centroids, "radii": base.nodes.radii,
                "base_ids": index._base_ids,
                "delta_rows": np.concatenate(index._delta_rows),
                "delta_ids": np.concatenate(index._delta_ids),
                "tombstones": np.asarray(sorted(index._tombstones)),
                "next_id": np.int64(index._next_id)}
    out = {"points": index.points}
    if kind == "ball":
        out |= {"idx": index.idx, "centroids": index.nodes.centroids,
                "radii": index.nodes.radii}
    else:
        out |= {k: v for k, v in index.nodes.items()}
        out |= {f"flat_{j}": a for j, a in enumerate(index._flat_tables())}
        out |= {"root": np.int64(index.root), "depth": np.int64(index.depth)}
    return out


def phase_serialize(pt, kind: str, index, query) -> None:
    """``save_index`` and ``load_index`` on the card for one kind: after
    the load every array equals the saved index's bit for bit, and the
    reloaded index answers ``query`` (its cell's queries) with the same
    distances and ids bit for bit.  The file is deleted."""
    with scratch_dir() as tmp:
        path = os.path.join(tmp, f"{kind}.npz")
        t0 = time.perf_counter()
        pt.save_index(index, path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = pt.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if type(back) is not type(index):
        raise AssertionError(f"serialize {kind}: loaded a "
                             f"{type(back).__name__}")
    want, got = _index_arrays(kind, index), _index_arrays(kind, back)
    bad = [name for name in want if not host_bits_equal(want[name],
                                                        got[name])]
    if bad:
        raise AssertionError(f"serialize {kind}: arrays differ: {bad}")
    a, b = query(index), query(back)
    if not all(host_bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"serialize {kind}: the reloaded index answers "
                             "differently")
    emit("serialize", kind=kind, file_bytes=nbytes, save_s=save_s,
         load_s=load_s, arrays_equal=sorted(want), answers_equal=True,
         queries=a[0].shape[0])


def phase_examples(pt) -> None:
    """The port's examples on the card and with ``device="cpu"``:
    ``torch_dbscan`` on config 4's points (eps 0.05, min_samples 10) with
    the same core mask and partition of core points; ``torch_optics`` and
    ``torch_hdbscan_core`` on their own ``__main__`` data with the same
    ordering and reachability (within f32), MST weights and labels."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import torch_dbscan
    import torch_hdbscan_core as hdb
    import torch_optics

    rng = np.random.default_rng(RADIUS_SEED)
    pts4 = rng.normal(size=(BALL_N, 2)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        core = torch_dbscan.core_mask(pts4, EX_EPS, EX_MIN_SAMPLES,
                                      device=dev)
        labels = torch_dbscan.dbscan(pts4, EX_EPS, EX_MIN_SAMPLES,
                                     device=dev)
        runs[dev] = (core, labels, time.perf_counter() - t0)
    (c1, l1, s1), (c2, l2, s2) = runs["cuda"], runs["cpu"]
    if not np.array_equal(c1, c2):
        raise AssertionError("examples dbscan: core masks differ")
    pairs = set(zip(l1[c1].tolist(), l2[c2].tolist()))
    if len(pairs) != len(set(l1[c1].tolist())) or len(pairs) != len(
            set(l2[c2].tolist())):
        raise AssertionError("examples dbscan: core partitions differ")
    emit("examples", example="torch_dbscan", n=BALL_N, eps=EX_EPS,
         min_samples=EX_MIN_SAMPLES, core=int(c1.sum()),
         clusters=int(l1.max()) + 1, noise=int((l1 < 0).sum()),
         labels_equal=bool(np.array_equal(l1, l2)), cuda_s=s1, cpu_s=s2)

    blobs = torch_optics.demo_points()
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = torch_optics.optics(blobs, eps=1.0, min_samples=10, cap=4096,
                                  device=dev)
        runs[dev] = (out, time.perf_counter() - t0)
    (o1, r1, k1), s1 = runs["cuda"]
    (o2, r2, k2), s2 = runs["cpu"]
    fin = np.isfinite(r1)
    if not (np.array_equal(o1, o2) and np.array_equal(fin, np.isfinite(r2))
            and np.allclose(r1[fin], r2[fin], rtol=2.0 ** -23, atol=0)
            and np.array_equal(np.isfinite(k1), np.isfinite(k2))):
        raise AssertionError("examples optics: cuda and cpu runs differ")
    emit("examples", example="torch_optics", n=len(blobs), eps=1.0,
         min_samples=10, reachable=int(fin.sum()),
         reach_max_rel_diff=float(np.max(np.abs(r1[fin] - r2[fin])
                                         / r2[fin], initial=0.0)),
         ordering_equal=True, cuda_s=s1, cpu_s=s2)

    pts = hdb.demo_points()
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        core = hdb.core_distances(pts, 5, device=dev)
        w = np.sort([e[2] for e in hdb.mst_edges(pts, 5, device=dev)])
        labels, _ = hdb.hdbscan_labels(pts, min_cluster_size=10, device=dev)
        runs[dev] = (core, w, labels, time.perf_counter() - t0)
    (cd1, w1, lb1, s1), (cd2, w2, lb2, s2) = runs["cuda"], runs["cpu"]
    tol = 2.0 ** -23
    if not (np.allclose(cd1, cd2, rtol=tol, atol=0)
            and np.allclose(w1, w2, rtol=tol, atol=0)
            and np.array_equal(lb1, lb2)):
        raise AssertionError("examples hdbscan_core: cuda and cpu differ")
    emit("examples", example="torch_hdbscan_core", n=len(pts), k=5,
         mst_weight=float(w1.sum()), clusters=int(lb1.max()) + 1,
         core_max_rel_diff=float(np.max(np.abs(cd1 - cd2) / cd2)),
         weight_max_rel_diff=float(np.max(np.abs(w1 - w2) / w2)),
         cuda_s=s1, cpu_s=s2)


#: phase parallel: the k of the sharded k-NN on all SIFT queries and on
#: the large-k batch; the feature-sharded and radius queries; the cap
PAR_K, PAR_LARGE_K = (10, 100), (2000, 3000)
PAR_FEATURE_Q, PAR_RADIUS_Q, PAR_CAP = 1024, 1024, 512
#: feature sharding's distances against f64: the direct form's relative
#: bound on a sum of DIM f32 squares (the square root halves it)
FEATURE_RTOL = DIM * 2.0 ** -24
#: the kernels the phase's sharded calls must launch
PAR_KERNELS = ("fold", "capped", "merge", "bitonic_sort", "rank_sort",
               "mst_scan")
#: ranks of the multi-rank dryrun on the CPU (gloo)
PAR_CPU_RANKS = 4


def phase_parallel(pt, points, queries, oracles, r, mst_weights, wrappers,
                   smi) -> dict:
    """The sharded entry points at world size 1 on NCCL, through
    ``default_mesh()``: each call timed, the launches of all of them read
    after the last; then each output against the single-device call on
    the same inputs (distances bit for bit, ids against the f64 oracles),
    and the multi-rank dryrun on the CPU (gloo), with one on NCCL over
    every card where there are two or more."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from petal_neighbors_tpu_torch import parallel
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    mesh1 = parallel.default_mesh()
    mesh2 = parallel.default_mesh(axis_names=("q", "p"))
    pdev = torch.from_numpy(points).cuda()
    qdev = torch.from_numpy(queries).cuda()
    qlarge, qfeat, qrad = (qdev[:N_Q_LARGE], qdev[:PAR_FEATURE_Q],
                           qdev[:PAR_RADIUS_Q])
    rng = np.random.default_rng(BALL_SEED)
    tree = pt.BallTree.euclidean(rng.normal(size=(BALL_N, 2)).astype(
        np.float32))
    tq = torch.from_numpy(rng.normal(size=(BALL_Q, 2)).astype(
        np.float32)).cuda()
    mst_pts = np.random.default_rng(MST_SEED).random((MST_N, MST_D),
                                                     dtype=np.float32)
    torch.cuda.synchronize()

    outs, secs = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    zero_launches(wrappers)
    for k in PAR_K:
        run(f"knn_query_sharded k={k}", lambda: parallel.knn_query_sharded(
            pdev, qdev, k, mesh=mesh1))
        run(f"knn_points_sharded k={k}", lambda: parallel.knn_points_sharded(
            pdev, qdev, k, mesh=mesh1))
        run(f"knn_ring k={k}", lambda: parallel.knn_ring(pdev, qdev, k,
                                                          mesh=mesh2))
    for k in PAR_LARGE_K:
        run(f"knn_query_sharded k={k}", lambda: parallel.knn_query_sharded(
            pdev, qlarge, k, mesh=mesh1))
    run("knn_feature_sharded k=10", lambda: parallel.knn_feature_sharded(
        pdev, qfeat, 10, mesh=mesh1))
    run(f"tree_query_sharded k={BALL_K}", lambda: parallel.tree_query_sharded(
        tree, tq, BALL_K, mesh=mesh1))
    for form in ("query", "points"):
        fn = getattr(parallel, f"radius_{form}_sharded")
        run(f"radius_{form}_sharded counts", lambda: fn(pdev, qrad, r,
                                                        mesh=mesh1))
        run(f"radius_{form}_sharded cap={PAR_CAP}", lambda: fn(
            pdev, qrad, r, mesh=mesh1, cap=PAR_CAP))
    run("mutual_reachability_mst_sharded", lambda:
        parallel.mutual_reachability_mst_sharded(mst_pts, MST_K, mesh=mesh1))
    launches = read_launches(wrappers)
    for need in PAR_KERNELS:
        if not launches.get(need):
            raise AssertionError(f"parallel: the sharded calls launched no "
                                 f"{need} kernel")

    # ---- each output against the single-device call ----
    checks = {}
    mu, pp, _, _ = bf.prepare_euclidean_index(pdev)
    centred = SimpleNamespace(_center=mu, _pts=pp)
    for name, (d, i) in ((n, o) for n, o in outs.items()
                         if n.startswith("knn_") and "feature" not in n):
        k = int(name.rsplit("=", 1)[1])
        qs = qdev if k in PAR_K else qlarge
        t0 = time.perf_counter()
        want_d, want_i = bf.knn(pdev, qs, k)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        if not (d.shape == want_d.shape and same_bits(d, want_d)):
            raise AssertionError(f"parallel {name}: distances differ from "
                                 "bf.knn's")
        recall, swaps, _ = check_vs_oracle(centred, pdev, qs, i,
                                           oracles[k][:, :k])
        checks[name] = {"distances_equal_bf_knn": True,
                        "ids_equal_bf_knn": bool(torch.equal(i, want_i)),
                        "recall": recall, "boundary_swaps": swaps,
                        "single_device_s": single_s}
    d, i = outs["knn_feature_sharded k=10"]
    od, oi = f64_oracle(pdev, qfeat, 10)
    rel = float(((d.double() - od).abs() / od.clamp_min(1e-30)).max())
    if rel > FEATURE_RTOL:
        raise AssertionError(f"parallel feature: distances {rel} from f64")
    recall, swaps, _ = check_vs_oracle(centred, pdev, qfeat, i, oi)
    checks["knn_feature_sharded k=10"] = {
        "max_rel_err_vs_f64": rel, "recall": recall, "boundary_swaps": swaps}
    del mu, pp, centred
    d, i = outs[f"tree_query_sharded k={BALL_K}"]
    want_d, want_i = tree.query_batch(tq, BALL_K, scheme="per_query")
    if not (same_bits(d, want_d) and torch.equal(i, want_i)):
        raise AssertionError("parallel tree: differs from query_batch")
    checks[f"tree_query_sharded k={BALL_K}"] = {"equal_per_query": True}
    counts = bf.radius_counts_streaming(pdev, qrad, r)
    ids, cnt = bf.radius_capped(pdev, qrad, r, cap=PAR_CAP)
    for form in ("query", "points"):
        got_ids, got_cnt = outs[f"radius_{form}_sharded cap={PAR_CAP}"]
        if not (torch.equal(outs[f"radius_{form}_sharded counts"], counts)
                and torch.equal(got_cnt, cnt) and torch.equal(got_ids, ids)):
            raise AssertionError(f"parallel radius_{form}_sharded differs "
                                 "from the single-device forms")
        checks[f"radius_{form}_sharded"] = {
            "equal_single_device": True,
            "members_per_query": float(counts.double().mean())}
    us, vs, ws = outs["mutual_reachability_mst_sharded"]
    weight_sum = float(ws.sum())
    if not (spanning(us, vs, MST_N)
            and np.array_equal(np.sort(ws), np.sort(mst_weights))
            and abs(weight_sum - MST_WEIGHT_SUM) / MST_WEIGHT_SUM
            <= MST_SUM_RTOL):
        raise AssertionError("parallel MST differs from the single-device "
                             f"MST (weight sum {weight_sum})")
    checks["mutual_reachability_mst_sharded"] = {
        "weights_equal_single_device": True, "weight_sum": weight_sum}
    world = {"backend": dist.get_backend(), "world_size":
             dist.get_world_size(), "mesh1": list(mesh1.shape),
             "mesh2": list(mesh2.shape)}
    dist.destroy_process_group()
    del pdev, qdev, qlarge, qfeat, qrad, tree, tq, outs
    torch.cuda.empty_cache()
    emit("parallel", nvidia_smi=smi, **world, seconds_per_call=secs,
         checks=checks, launches=launches)

    # ---- the multi-rank stage ----
    print(f"parallel: dryrun_multichip({PAR_CPU_RANKS}) runs on the CPU "
          "(gloo), whatever the card", flush=True)
    stages = [(PAR_CPU_RANKS, "cpu")]
    if torch.cuda.device_count() >= 2:
        stages.append((torch.cuda.device_count(), None))
    for n, device in stages:
        t0 = time.perf_counter()
        dryrun.dryrun_multichip(n, device=device)
        emit("parallel", stage="dryrun_multichip", ranks=n,
             backend="gloo" if device == "cpu" else "nccl",
             seconds=time.perf_counter() - t0)
    emit("parallel", seconds=time.perf_counter() - t_phase)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops import bruteforce as bf
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk
    from petal_neighbors_tpu_torch.ops.cuda import lp_kernel as lk
    from petal_neighbors_tpu_torch.ops.cuda import minima_kernel as mk
    from petal_neighbors_tpu_torch.ops.cuda import mst_kernel as msk

    smi = smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         dir=os.path.relpath(_build.build_dir(),
                             os.path.dirname(os.path.abspath(__file__))))
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    emit("build_ptxas", **{name: ptxas_summary(log) for name, log in
                           logs.items() if name in ("knn_fold",
                                                    "knn_select",
                                                    "knn_minima",
                                                    "mst_scan",
                                                    "split_planes",
                                                    "rescore")},
         wgmma_notes={name: wgmma_notes(log) for name, log in logs.items()
                      if name in ("knn_fold", "knn_select", "knn_minima")})
    tc_ratio = phase_tc_probe()
    plane_rows = phase_planes()
    rescore_rows = phase_rescore()
    mst_cases = phase_mst_kernel_small()

    rng = np.random.default_rng(SEED)
    points = rng.random((N, DIM), dtype=np.float32) * 255.0
    queries = rng.random((N_Q, DIM), dtype=np.float32) * 255.0

    t0 = time.perf_counter()
    index = pt.BruteForce.euclidean(points)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qdev = torch.from_numpy(queries).cuda()

    # ---- kernel vs plain (launches here are not the main paths') -------
    rows, errs = phase_kernel(index._pts, index._norms, index._planes,
                              qdev - index._center)
    fold_rows_sift = fold_table(index._pts, index._norms,
                                qdev - index._center, "SIFT")
    few_rows, few_err = phase_few_query(pt, index,
                                        torch.from_numpy(points).cuda(), qdev)
    sorts = phase_sorts(index, qdev)
    errs["lp_knn"] = phase_lp_small()

    # ---- the main paths ------------------------------------------------
    from petal_neighbors_tpu_torch.ops.cuda import rank_sort_kernel as rk
    from petal_neighbors_tpu_torch.ops.cuda import sort_kernel as sk
    from petal_neighbors_tpu_torch.ops.cuda import rescore_kernel
    from petal_neighbors_tpu_torch.ops.cuda import tc_planes as tp

    wrappers = {"fold": kk.knn_fold, "capped": kk.knn_capped,
                "bcap": kk.knn_bcap, "merge": kk.knn_merge,
                "bitonic_sort": sk.bitonic_sort_pairs,
                "rank_sort": rk.rank_sort_pairs, "lp_knn": lk.lp_knn,
                "fold_lazy": kk.knn_fold_lazy,
                "subchunk_minima": mk.subchunk_minima,
                "bcap_minima": mk.bcap_minima,
                "mst_scan": msk.scan_minout, "few": kk.knn_few,
                "split_planes": tp.split_planes,
                "rescore": rescore_kernel.rescore_rd}
    # the route's fold calls, with their query counts: under bcap and
    # capped they are the repairs of the queries the proof left uncovered
    fold_rows = []
    # the path each of the route's fold calls took, per phase
    fold_paths = {"few": 0, "select": 0, "stream": 0}

    def counted_fold(points, queries, norms, *, k):
        fold_rows.append(queries.shape[0])
        out = kk.knn_fold(points, queries, norms, k=k)
        fold_paths[kk.knn_fold.last_path] += 1
        return out

    bf.knn_fold = counted_fold
    # the route's proofs: a proof-gated call takes the tensor-core tier's
    # bound once
    proofs = []
    proof_err = bf.tc_proof_err

    def counted_proof_err(dim, qn, xn_max):
        proofs.append(dim)
        return proof_err(dim, qn, xn_max)

    bf.tc_proof_err = counted_proof_err
    pdev = torch.from_numpy(points).cuda()
    launches, fold_by_path, flat_qps = {}, {}, {}
    for phase, ks, qs, reps, need in (
            ("main", MAIN_K, qdev, 3, ("fold", "capped", "bcap", "few",
                                       "split_planes", "rescore")),
            ("main_large_k", LARGE_K, qdev[:N_Q_LARGE], 2,
             ("capped", "merge", "bitonic_sort", "rank_sort", "rescore"))):
        for w in wrappers.values():
            w.launches = 0
        fold_paths.update(few=0, select=0, stream=0)
        out, per_k, repaired, radix_passes, tiers = {}, {}, {}, {}, {}
        for k, scheme in ks.items():
            before = {s: w.launches for s, w in wrappers.items()}
            fold_rows.clear()
            proofs.clear()
            d, i = index.query_batch(qs, k)          # warm
            torch.cuda.synchronize()
            if (index.last_backend, index.last_scheme) != ("kernel", scheme):
                raise AssertionError(f"k={k} served by {index.last_backend} "
                                     f"{index.last_scheme}, not {scheme}")
            walls, radix = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                d, i = index.query_batch(qs, k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if scheme == "merge":
                    radix.append(list(kk.knn_merge.last_passes))
            out[k] = (d, i, min(walls))
            flat_qps[k] = qs.shape[0] / min(walls)
            radix_passes[k] = radix
            per_k[k] = {s: w.launches - before[s]
                        for s, w in wrappers.items()}
            repaired[k] = list(fold_rows) if scheme != "fold" else []
            tiers[k] = "tc" if proofs else None
        got = {s: w.launches for s, w in wrappers.items()}
        for s in need:
            if got[s] == 0:
                raise AssertionError(f"{phase} launched no {s} kernel")
            # a kernel's count comes from the path of its kernels-line row
            launches.setdefault(s, got[s])
        fold_by_path[phase] = dict(fold_paths)
        if not fold_paths["select"]:
            # the repairs at k=100 and 200, and at k=1000, are small batches
            raise AssertionError(f"{phase}: no fold repair took the select "
                                 "path")

        _, oi = f64_oracle(pdev, qs, max(ks))
        if phase == "main":
            main_oracle, main_d100 = oi, out[100][0]
        else:
            large_oracle = oi
        for k, scheme in ks.items():
            d, i, wall = out[k]
            if d.shape != (qs.shape[0], k) or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"k={k}: bad output {tuple(d.shape)}")
            if not bool((d[:, 1:] >= d[:, :-1]).all()):
                raise AssertionError(f"k={k}: distances not ascending")
            recall, swaps, worst = check_vs_oracle(index, pdev, qs, i,
                                                   oi[:, :k])
            kernel_ms = {f"knn_{s}": rows[s, k_req]["ms"]
                         for s, k_req in rows
                         if k_req == k and s in (scheme, "fold")}
            extra = {}
            if tiers[k] is not None:
                # the bound the repaired counts were proved under
                extra["proof_tier"] = tiers[k]
            if radix_passes[k]:
                extra["radix_passes_per_call"] = radix_passes[k]
            if phase == "main_large_k":
                kernel_ms.update({kind: row["ms"] for kind, row in
                                  sorts.items()})
            if repaired[k]:
                # the repair's kernel on the repaired count of queries, on
                # the path fold_path picks, beside the streaming kernel
                # (and merge, at large k) on the same work
                qr = (qs - index._center)[:repaired[k][-1]]
                k_scan = bf.scan_width(scheme, k, N)
                runs = {"fold": kk.knn_fold,
                        "fold_stream": lambda *a, **kw: kk.knn_fold(
                            *a, **kw, path="stream")}
                if phase == "main_large_k":
                    runs["merge"] = kk.knn_merge
                extra |= {f"repair_{name}_ms": cuda_ms(
                    lambda: run(index._pts, qr, index._norms, k=k_scan),
                    reps=2) for name, run in runs.items()}
                extra["repair_fold_path"] = kk.fold_path(
                    qr.shape[0], k_scan, DIM, N)
            emit(phase, k=k, scheme=scheme, queries=qs.shape[0],
                 qps=qs.shape[0] / wall, batch_s=wall, kernel_ms=kernel_ms,
                 launches_in_calls={s: c for s, c in per_k[k].items() if c},
                 calls=reps + 1, repaired_queries_per_call=repaired[k],
                 recall=recall, oracle_queries=qs.shape[0],
                 boundary_swaps=swaps, worst_swap_gap_over_band=worst,
                 backend=index.last_backend, build_s=build_s, **extra)
        emit(phase, launches=got, fold_launches_by_path=fold_by_path[phase])

    for s, c in phase_main_opt_in(index, pdev, qdev, main_oracle, rows,
                                  wrappers, fold_rows, proofs).items():
        if s in ("fold_lazy", "subchunk_minima", "bcap_minima"):
            launches[s] = c
    flat_radius = phase_radius_flat(index, pdev, qdev, main_d100)
    vp_sift = phase_vp_sift(pt, points, qdev, main_oracle, wrappers,
                            fold_rows)

    # ---- the adapters and the utilities --------------------------------
    phase_serialize(pt, "brute", index,
                    lambda ix: ix.query_batch(qdev, SERVE_K))
    adapters = {"knn_route": phase_knn_route(
        index, pdev, qdev, {10: main_oracle, 100: main_oracle,
                            2000: large_oracle}, flat_qps, wrappers,
        fold_rows)}
    adapters["sklearn"] = phase_sklearn(pt, index, points, queries, qdev,
                                        flat_radius, wrappers)
    serving = phase_serving(pt, index, queries, qdev, wrappers)
    adapters["serving"] = {s: sum(got.get(s, 0) for got in serving.values())
                           for s in wrappers}
    phase_profiling(index, qdev)

    del index, pdev, qdev
    torch.cuda.empty_cache()
    lp_row, generic_launches, capped_gist, fold_rows_gist = (
        phase_main_generic(wrappers, fold_rows))
    launches["lp_knn"] = generic_launches["lp_knn"]

    config1_queries = phase_ball_knn(pt)
    phase_ball_radius(pt)
    tree_1m = phase_ball_device_build(pt, config1_queries)
    q1_dev = torch.from_numpy(config1_queries).cuda()
    phase_serialize(pt, "ball", tree_1m,
                    lambda ix: ix.query_batch(q1_dev, BALL_K))
    del tree_1m
    phase_ball_highdim(pt)
    vp_config2 = phase_vp_knn(pt, wrappers, fold_rows)
    if not any(vp["launches"].get(s) for vp in (vp_config2, vp_sift)
               for s in ("fold", "few")):
        raise AssertionError("the VP kernel route repaired no query: fold "
                             "did not run on its path")
    phase_serialize(pt, "vantage", vp_config2["tree"],
                    lambda ix: ix.query_batch(vp_config2["queries"], VP_K))
    phase_vp_radius(pt)
    phase_vp_device_build(pt, config1_queries)
    phase_dynamic(pt)
    dyn64, dyn64_q = phase_dynamic_d64(pt)
    phase_serialize(pt, "dynamic", dyn64,
                    lambda ix: ix.query_batch(dyn64_q, DYN64_K))
    del dyn64
    mst = phase_hdbscan(pt, wrappers, fold_rows)
    joins = phase_dual_join(pt, wrappers)
    phase_examples(pt)
    par_launches = phase_parallel(
        pt, points, queries, {10: main_oracle, 100: main_oracle,
                              2000: large_oracle, 3000: large_oracle},
        flat_radius[0], mst["weights"], wrappers, smi)

    kernels = []
    for scheme, k_req in MAIN_ROW.items():
        row = rows[scheme, k_req]
        kernels.append({
            "name": f"knn_{scheme}", "route": "cuda",
            "source": SELECT_SOURCE if scheme == "merge" else KNN_SOURCE,
            "replaces": REPLACES[scheme], "launches": launches[scheme],
            "max_abs_err": errs[scheme], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "tier": row["tier"],
            **({"tc_probe_max_err_over_bound": tc_ratio}
               if row["tier"] == "tc" else {}),
            **{key: row[key] for key in ("simt_bound_ms", "tc_bound_ms",
                                         "radix_passes") if key in row},
            "shape": {key: row[key] for key in
                      ("n", "q", "d", "k", "tile", "passes", "plan")}})
        if scheme == "fold":
            # the main path's fold calls are its repairs: the line reports
            # the largest (SIFT k=100, 187 queries at k_scan 108), and the
            # whole batch on the streaming kernel beside it
            table = fold_rows_sift + fold_rows_gist
            repair = next(r for r in table if r.get("repair") and (
                r["shape"], r["q"], r["k"]) == FOLD_MAIN_REPAIR)
            kernels[-1].update(
                {key: repair[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                path=repair["rule"],
                tc_bound_ms=tc_bound_ms(repair["n"], repair["q"],
                                        repair["d"], repair["k"])[0],
                shape={key: repair[key] for key in ("n", "q", "d", "k")}
                | {"plan": repair[f"plan_{repair['rule']}"]},
                full_batch={"path": kk.fold_path(row["q"], row["k"],
                                                 row["d"], row["n"]),
                            **{key: row[key] for key in (
                                "q", "k", "ms", "plain_ms", "bound_ms",
                                "library_ms", "plan")}},
                select_source=SELECT_SOURCE,
                launches_by_path=fold_by_path,
                cutover={"select_q_by_d_and_k": kk.FOLD_SELECT_Q,
                         "few_rule": kk.FEW_RULE,
                         "rule_is_faster_at": sum(r["rule_is_faster"]
                                                  for r in table),
                         "least_margin": min(r["margin"] for r in table),
                         "table_points": len(table)},
                repairs=[{key: r.get(key) for key in (
                    "shape", "q", "k", "rule", "ms", "select_ms",
                    "stream_ms", "few_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "max_abs_err",
                    "collect_passes")}
                    for r in table if r.get("repair")])
        if scheme in ("capped", "fold"):
            # the VP tree's kernel route (PR 14): its launches in the
            # "auto" runs of each cell, and the kernel held to its plain
            # version at that cell's shape
            kernels[-1]["vp_launches"] = {
                "config2": vp_config2["launches"].get(scheme, 0),
                "sift": vp_sift["launches"].get(scheme, 0)}
            kernels[-1]["vp"] = {"config2": vp_config2["kernels"][scheme],
                                 "sift": vp_sift["kernels"][scheme]}
            # the HDBSCAN path: the core distances' kernel route
            # at 1M x 8 and the join's kernel engine, and the kernel held
            # to its plain version at the core pass's shape
            kernels[-1]["mst_launches"] = {
                "hdbscan_core": mst["core_launches"].get(scheme, 0),
                "dual_join_kernel": joins["_join_via_kernel"][
                    "launches"].get(scheme, 0)}
            kernels[-1]["mst"] = mst["held"][scheme]
        # the adapters' paths: bf.knn's kernel route on the
        # uncentred SIFT points, NearestNeighbors and QueryStream
        if scheme in ("bcap", "capped", "fold", "merge"):
            kernels[-1]["adapter_launches"] = {
                name: got.get(scheme, 0) for name, got in adapters.items()}
        if scheme == "capped":
            kernels[-1]["gist"] = {key: capped_gist[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "simt_bound_ms", "k", "passes", "plan")}
        if scheme == "merge":
            kernels[-1]["k_scan_2048"] = {key: rows["merge", 2000][key]
                                          for key in ("ms", "library_ms",
                                                      "bound_ms",
                                                      "simt_bound_ms",
                                                      "radix_passes")}
    # the few-query kernel (no TPU counterpart): the main path's launches
    # (the k=10 repairs), timed at the single queries' shapes (one query,
    # k_scan 18, beside SIFT's bcap and GIST's capped tile kernels) and at
    # the route's repair shapes of the sweep, beside the paths the rule did
    # not pick
    few_at = {(r["shape"], r["q"], r["k"]): r for r in few_rows}
    one = few_at["SIFT", 1, 18]
    bound, by = bound_ms(one["n"], 1, one["d"], 18)
    kernels.append({
        "name": "knn_few", "route": "cuda", "source": FEW_SOURCE,
        "replaces": None, "launches": launches["few"],
        "max_abs_err": few_err, "ms": one["few_ms"],
        "plain_ms": one["plain_ms"], "bound_ms": bound, "bound_by": by,
        "library_ms": one["library_ms"], "tier": "fp32",
        "shape": {key: one[key] for key in ("n", "q", "d", "k", "plan")},
        "gist": {key: few_at["GIST", 1, 18][key] for key in (
            "few_ms", "plain_ms", "library_ms", "bytes_bound_ms",
            "capped_tile_ms", "knn_few_ms", "plan")},
        "sift_bcap": {key: one[key] for key in ("bcap_tile_ms",
                                                "knn_few_ms")},
        "repairs": [{key: few_at[at].get(key) for key in (
            "shape", "q", "k", "rule", "few_ms", "select_ms", "stream_ms",
            "bytes_bound_ms")} for at in FEW_REPAIRS],
        "rule": kk.FEW_RULE,
        "vp_launches": {"config2": vp_config2["launches"].get("few", 0),
                        "sift": vp_sift["launches"].get("few", 0)},
        "mst_launches": {
            "hdbscan_core": mst["core_launches"].get("few", 0),
            "dual_join_kernel": joins["_join_via_kernel"][
                "launches"].get("few", 0)},
        "adapter_launches": {name: got.get("few", 0)
                             for name, got in adapters.items()}})
    # the planes' split (no TPU counterpart: the MXU splits its operands
    # itself): the main path's launches (each bcap or capped call's
    # queries), timed at SIFT's index shape
    split = plane_rows["sift"]
    kernels.append({
        "name": "split_planes", "route": "cuda", "source": SPLIT_SOURCE,
        "replaces": None, "launches": launches["split_planes"],
        "max_abs_err": 0.0, "ms": split["ms"], "plain_ms": split["plain_ms"],
        "bound_ms": split["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "shape": {"rows": split["rows"], "d": split["d"]},
        "queries": plane_rows["queries"],
        "adapter_launches": {name: got.get("split_planes", 0)
                             for name, got in adapters.items()}})
    # the direct-form rescore (no TPU kernel: XLA fuses the JAX package's
    # jnp rescore), timed at each batch cell's shape; no one PyTorch call
    # gathers and scores, so no library call
    kernels.append({
        "name": "rescore", "route": "cuda", "source": RESCORE_SOURCE,
        "replaces": None, "launches": launches["rescore"],
        "max_rel_err_f64": max(r["max_rel_err_f64"]
                               for r in rescore_rows.values()),
        "library_ms": None, "bound_by": "bytes",
        "cells": {cell: {key: r[key] for key in ("ms", "plain_ms",
                                                 "bound_ms", "plan")}
                  for cell, r in rescore_rows.items()},
        "adapter_launches": {name: got.get("rescore", 0)
                             for name, got in adapters.items()}})
    for kind, row in sorts.items():
        kernels.append({
            "name": kind, "route": "cuda", "source": SORT_SOURCE,
            "replaces": REPLACES[kind], "launches": launches[kind],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "route_rows_ms": row.get("route_ms"),
            "adapter_launches": {name: got.get(kind, 0)
                                 for name, got in adapters.items()},
            "shape": {"rows": row["rows"], "width": row["width"]}})
    for name in ("subchunk_minima", "bcap_minima"):
        row = rows[name, None]
        kernels.append({
            "name": name, "route": "cuda", "source": MINIMA_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "tier": row["tier"],
            **({"tc_probe_max_err_over_bound": tc_ratio}
               if row["tier"] == "tc" else {}),
            **{key: row[key] for key in ("simt_bound_ms", "tc_bound_ms")
               if key in row},
            "shape": {key: row[key] for key in ("n", "q", "d", "rows",
                                                "splits")}})
    kernels.append({
        "name": "lp_knn", "route": "cuda", "source": LP_SOURCE,
        "replaces": REPLACES["lp_knn"], "launches": launches["lp_knn"],
        "max_abs_err": max(errs["lp_knn"], lp_row["max_abs_err"]),
        "ms": lp_row["ms"], "plain_ms": lp_row["plain_ms"],
        "bound_ms": lp_row["bound_ms"], "bound_by": lp_row["bound_by"],
        "library_ms": lp_row["library_ms"],
        "shape": {key: lp_row[key] for key in ("n", "q", "d", "k",
                                               "splits")} | {"p": 3.0}})
    scan = mst["scan"]
    kernels.append({
        "name": "mst_scan", "route": "cuda", "source": MST_SOURCE,
        "replaces": MST_REPLACES, "launches": mst["launches"]["mst_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": scan["library_ms"],
        "tier": "fp32", "shape": {"n": MST_N, "q": MST_N, "d": MST_D},
        "per": "one Borůvka round at full width; plain and library at "
               "the reduced shape",
        "reduced": scan["reduced"],
        "instructions_per_pair": scan["instructions_per_pair"],
        "small_cases_bit_equal": mst_cases})
    for row in kernels:
        # the sharded entry points' launches (phase parallel)
        row["parallel_launches"] = par_launches.get(row["name"].removeprefix(
            "knn_"), 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
