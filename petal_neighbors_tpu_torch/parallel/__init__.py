"""Multi-card scaling: sharded exact search over a
``torch.distributed.device_mesh.DeviceMesh`` (the JAX package's
``parallel/``).

The programming model.  The JAX API has one controller process that
passes global arrays and gets global arrays back.  Here each rank is a
process (``torchrun --nproc_per_node=N`` with ``init_distributed()``, or
one process whose ``default_mesh()`` starts a world of one), and every
rank calls an entry point with the same full inputs and the same mesh.
Each rank moves only its own shard to its device (for point, feature and
ring sharding no rank holds the whole corpus on its card), and every rank
gets the full result back as tensors on its device: what ``np.asarray``
of the JAX call's global array gives.  ``default_mesh(device=None)`` is a
CUDA mesh on NCCL, one rank a card; ``device="cpu"`` is gloo.  Entry
points compute on the mesh's device unless given ``device``.

The schemes:

* **query data parallelism** — queries sharded over a mesh axis, index
  replicated, then an ``all_gather`` over the query axis.
* **point sharding** — points row-sharded, queries replicated: each rank
  computes a local exact top-k, then the k-lists are gathered and merged
  (a k-way merge is associative and exact); the radius forms sum their
  counts and merge their capped id lists.
* **feature sharding** — the feature axis sharded, partial squared
  distances summed over the axis.
* **ring search** — both sharded on a 2-D mesh: point shards rotate
  around the ring (``batch_isend_irecv``) while each rank keeps a running
  top-k for its resident query shard.
* **the sharded MST** — HDBSCAN's Borůvka scan with the query rows
  sharded.

``dryrun.dryrun_multichip(n, device=...)`` starts n ranks and checks every
scheme against single-rank calls.
"""

from .api import (
    default_mesh,
    init_distributed,
    knn_feature_sharded,
    knn_points_sharded,
    knn_query_sharded,
    knn_ring,
    mutual_reachability_mst_sharded,
    radius_points_sharded,
    radius_query_sharded,
    tree_query_sharded,
)

__all__ = [
    "default_mesh",
    "init_distributed",
    "knn_query_sharded",
    "knn_points_sharded",
    "knn_feature_sharded",
    "knn_ring",
    "tree_query_sharded",
    "radius_query_sharded",
    "radius_points_sharded",
    "mutual_reachability_mst_sharded",
]
