"""petal_neighbors_tpu_torch — the PyTorch / CUDA port of
``petal_neighbors_tpu`` for one NVIDIA H100.

It carries the exact flat index, ``BruteForce``, for every metric of the
JAX package (Euclidean, squared Euclidean, Cosine, Minkowski, Manhattan,
Chebyshev, Haversine), with its k-NN and radius search, the ball tree,
``BallTree`` (its builders, k-NN and radius search), the vantage-point
tree, ``VantagePointTree`` (its builders, its k-NN on the kernel route and
the subtree scans, its radius search), the mutable ``DynamicIndex``,
``pairwise``, the dual-tree join ``dual_tree_knn`` (``BallTree.query_tree``),
the mutual-reachability MST (``boruvka_mst``, ``mutual_reachability_mst``)
and ``hdbscan`` (the ``cluster`` module's host stages on top of the MST),
with the adapters: the scikit-learn-shaped ``NearestNeighbors``,
``save_index`` / ``load_index`` (the JAX package's ``.npz`` format, either
way), the micro-batching ``QueryStream`` and ``utils.profiling``; and
the sharded search on ``torch.distributed`` in ``parallel`` (not imported
here, as in the JAX package: ``from petal_neighbors_tpu_torch import
parallel``).
On the card the index runs
hand-written kernels: Euclidean and Cosine through the fold, capped, bcap
and merge kernels (``ops/cuda/csrc/knn_fold.cu``) with the row sorts
(``csrc/row_sort.cu``), Minkowski, Manhattan and Chebyshev through the Lp
kernel (``csrc/lp_knn.cu``); the rest through the streamed scan.  The
MST's scan rounds run ``csrc/mst_scan.cu``, and its core distances at
scale the Euclidean kernel route.  Entry
points take ``device=None``, which means ``"cuda"``; pass
``device="cpu"`` to run on the CPU, where each kernel is replaced by its
plain PyTorch version.  The radius search and the trees are plain
PyTorch on the card, as they are plain XLA in the JAX package, except the
VP tree's kernel route and the join's kernel engine, which run the flat
index's kernels.  The port imports neither ``jax`` nor the JAX package.
"""

from . import cluster
from .cluster import hdbscan
from .convert import (balltree_from_jax_arrays, bruteforce_from_jax_arrays,
                      dynamic_from_jax_state, vptree_from_jax_arrays)
from .distance import (Chebyshev, Cosine, Euclidean, Haversine, Manhattan,
                       Metric, Minkowski, SqEuclidean, get_metric, pairwise)
from .errors import ArrayError, EmptyArrayError, NotContiguousError
from .sklearn import NearestNeighbors
from .trees import (BallTree, BruteForce, DynamicIndex, VantagePointTree,
                    boruvka_mst, dual_tree_knn, mutual_reachability_mst)
from .utils.serialize import load_index, save_index
from .utils.serving import AsyncResult, QueryStream

__all__ = ["BallTree", "BruteForce", "VantagePointTree", "DynamicIndex",
           "dual_tree_knn", "boruvka_mst", "mutual_reachability_mst",
           "cluster", "hdbscan", "NearestNeighbors", "save_index",
           "load_index", "QueryStream", "AsyncResult",
           "Euclidean", "SqEuclidean", "Cosine", "Minkowski",
           "Manhattan", "Chebyshev", "Haversine", "Metric", "get_metric",
           "pairwise", "ArrayError", "EmptyArrayError", "NotContiguousError",
           "balltree_from_jax_arrays", "bruteforce_from_jax_arrays",
           "vptree_from_jax_arrays", "dynamic_from_jax_state"]
