"""petal_neighbors_tpu_torch — the PyTorch / CUDA port of
``petal_neighbors_tpu`` for one NVIDIA H100.

It carries the exact flat index, ``BruteForce``, for every metric of the
JAX package (Euclidean, squared Euclidean, Cosine, Minkowski, Manhattan,
Chebyshev, Haversine), with its k-NN and radius search, the ball tree,
``BallTree`` (its builders, k-NN and radius search), the vantage-point
tree, ``VantagePointTree`` (its builders, its k-NN on the kernel route and
the subtree scans, its radius search), the mutable ``DynamicIndex``, and
``pairwise``.  On the card the index runs
hand-written kernels: Euclidean and Cosine through the fold, capped, bcap
and merge kernels (``ops/cuda/csrc/knn_fold.cu``) with the row sorts
(``csrc/row_sort.cu``), Minkowski, Manhattan and Chebyshev through the Lp
kernel (``csrc/lp_knn.cu``); the rest through the streamed scan.  Entry
points take ``device=None``, which means ``"cuda"``; pass
``device="cpu"`` to run on the CPU, where each kernel is replaced by its
plain PyTorch version.  The radius search and the trees are plain
PyTorch on the card, as they are plain XLA in the JAX package, except the
VP tree's kernel route, which runs the flat index's kernels.  The port
imports neither ``jax`` nor the JAX package.
"""

from .convert import (balltree_from_jax_arrays, bruteforce_from_jax_arrays,
                      dynamic_from_jax_state, vptree_from_jax_arrays)
from .distance import (Chebyshev, Cosine, Euclidean, Haversine, Manhattan,
                       Metric, Minkowski, SqEuclidean, get_metric, pairwise)
from .errors import ArrayError, EmptyArrayError, NotContiguousError
from .trees.ball import BallTree
from .trees.bruteforce import BruteForce
from .trees.dynamic import DynamicIndex
from .trees.vantage import VantagePointTree

__all__ = ["BallTree", "BruteForce", "VantagePointTree", "DynamicIndex",
           "Euclidean", "SqEuclidean", "Cosine", "Minkowski",
           "Manhattan", "Chebyshev", "Haversine", "Metric", "get_metric",
           "pairwise", "ArrayError", "EmptyArrayError", "NotContiguousError",
           "balltree_from_jax_arrays", "bruteforce_from_jax_arrays",
           "vptree_from_jax_arrays", "dynamic_from_jax_state"]
