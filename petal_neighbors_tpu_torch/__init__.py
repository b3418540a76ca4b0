"""petal_neighbors_tpu_torch — the PyTorch / CUDA port of
``petal_neighbors_tpu`` for one NVIDIA H100.

This slice carries the exact flat index: ``BruteForce`` with the
Euclidean and squared-Euclidean metrics, served on the card by the
hand-written fold kernel (``ops/cuda/csrc/knn_fold.cu``).  Entry points
take ``device=None``, which means ``"cuda"``; pass ``device="cpu"`` to run
on the CPU, where each kernel is replaced by its plain PyTorch version.
The port imports neither ``jax`` nor the JAX package.
"""

from .convert import bruteforce_from_jax_arrays
from .distance import Euclidean, Metric, SqEuclidean, get_metric
from .errors import ArrayError, EmptyArrayError, NotContiguousError
from .trees.bruteforce import BruteForce

__all__ = ["BruteForce", "Euclidean", "SqEuclidean", "Metric", "get_metric",
           "ArrayError", "EmptyArrayError", "NotContiguousError",
           "bruteforce_from_jax_arrays"]
