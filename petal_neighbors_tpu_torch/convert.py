"""Carry a JAX ``BruteForce``, ``BallTree``, ``VantagePointTree`` or
``DynamicIndex`` across to the port without a rebuild.

The index's "weights" are its resident arrays, the outputs of the JAX
package's ``prepare_*_index`` for its kernel layout:

* Euclidean — ``prepare_euclidean_index``: ``center`` (``_center``),
  ``ppad`` (``_pallas_pts``), ``pnorm`` (``_pallas_norms``), ``bad``
  (``_invalid``);
* cosine — ``prepare_cosine_index``: ``ppad``, ``pnorm``, ``bad``;
* Lp — ``prepare_lp_index``: ``ppad`` (``_lp_pts``), ``mask``
  (``_lp_mask``), ``bad``, with the Minkowski, Manhattan or Chebyshev
  metric;

each beside ``points``, the original on the host.  Handed over as numpy
arrays, they make a port index that answers the same queries with the
same arithmetic.

A ``BallTree``'s are ``points``, ``centroids`` (``.nodes.centroids``),
``radii`` (``.nodes.radii``) and ``idx`` (``.idx``), with its metric and
leaf size, and optionally its centre ``center`` (``_qcenter``).  A
``VantagePointTree``'s are ``points``, ``vp``, ``radius``, ``near`` and
``far`` (``.nodes``), ``root`` and ``depth``.  A
``DynamicIndex``'s state is its base tree's arrays, its id tables and its
pending mutations, the arguments of its ``_from_state``.
"""

from __future__ import annotations

from .distance import Cosine, Euclidean, get_metric
from .ops.cuda.lp_kernel import lp_spec_for
from .trees.ball import BallTree
from .trees.bruteforce import BruteForce
from .trees.dynamic import DynamicIndex
from .trees.vantage import VantagePointTree

__all__ = ["balltree_from_jax_arrays", "bruteforce_from_jax_arrays",
           "vptree_from_jax_arrays", "dynamic_from_jax_state"]

_VP_KEYS = ("points", "vp", "radius", "near", "far", "root", "depth")
_DYNAMIC_KEYS = ("base_rows", "leaf_size", "centroids", "radii", "idx",
                 "base_ids", "delta_rows", "delta_ids", "tombstones",
                 "next_id", "rebuild_threshold")


def _need(arrays, keys) -> None:
    missing = [key for key in keys if key not in arrays]
    if missing:
        raise KeyError(f"missing arrays: {missing}; need {list(keys)}")

_KEYS = {"euclidean": ("points", "center", "ppad", "pnorm", "bad"),
         "cosine": ("points", "ppad", "pnorm", "bad"),
         "lp": ("points", "ppad", "mask", "bad")}


def bruteforce_from_jax_arrays(arrays, *, metric="euclidean",
                               device=None) -> BruteForce:
    """A port ``BruteForce`` in the kernel layout of ``metric`` from a JAX
    index's resident arrays: ``arrays`` maps the layout's keys to numpy
    arrays, as the JAX ``prepare_*_index`` returns them (``ppad`` may be
    padded to any row count >= n).  Keys: ``points``, ``center``,
    ``ppad``, ``pnorm``, ``bad`` (Euclidean); ``points``, ``ppad``,
    ``pnorm``, ``bad`` (Cosine); ``points``, ``ppad``, ``mask``, ``bad``
    (Minkowski, Manhattan, Chebyshev)."""
    metric = get_metric(metric)
    layout = ("lp" if lp_spec_for(metric) is not None
              else "cosine" if type(metric) is Cosine
              else "euclidean" if type(metric) is Euclidean else None)
    if layout is None:
        raise ValueError(f"no kernel layout serves {metric!r}")
    _need(arrays, _KEYS[layout])
    extra = {key: arrays[key] for key in ("center", "pnorm", "mask")
             if key in _KEYS[layout]}
    return BruteForce._from_prepared(arrays["points"], arrays["ppad"],
                                     arrays["bad"], metric=metric,
                                     device=device, **extra)


def balltree_from_jax_arrays(arrays, *, metric="euclidean", leaf_size,
                             device=None) -> BallTree:
    """A port ``BallTree`` from a JAX tree's arrays, as numpy: ``points``,
    ``centroids`` (``.nodes.centroids``), ``radii`` (``.nodes.radii``) and
    ``idx`` (``.idx``), with the tree's ``metric`` and ``leaf_size``, and
    optionally ``center`` (a Euclidean tree's ``_qcenter``, the centre of
    its product-form bounds; recomputed by ``center_of`` when absent).  It
    answers the same queries with no rebuild (the JAX package's
    ``BallTree._from_arrays``); the join and the dual Borůvka read the
    permutation tables (``_orig_ids``, ``_pos_of_id``) and the leaf
    geometry it derives from these arrays."""
    _need(arrays, ("points", "centroids", "radii", "idx"))
    return BallTree._from_arrays(arrays["points"], metric, leaf_size,
                                 arrays["centroids"], arrays["radii"],
                                 arrays["idx"], center=arrays.get("center"),
                                 device=device)


def vptree_from_jax_arrays(arrays, *, metric="euclidean",
                           device=None) -> VantagePointTree:
    """A port ``VantagePointTree`` from a JAX tree's arrays, as the JAX
    ``VantagePointTree._from_arrays`` takes them (vantage.py:767-775):
    ``points``, ``vp``, ``radius``, ``near`` and ``far`` (the tree's
    ``.nodes``: ``vantage_point``, ``radius``, ``near``, ``far``), ``root``
    and ``depth``, with the tree's ``metric``.  It answers the same queries
    with no rebuild."""
    _need(arrays, _VP_KEYS)
    points, vp, radius, near, far, root, depth = (arrays[key]
                                                  for key in _VP_KEYS)
    return VantagePointTree._from_arrays(points, metric, vp, radius, near,
                                         far, root, depth, device=device)


def dynamic_from_jax_state(state, *, metric="euclidean",
                           device=None) -> DynamicIndex:
    """A port ``DynamicIndex`` from a JAX index's state, the arguments of
    the JAX ``DynamicIndex._from_state`` (dynamic.py:145-167): the base
    tree's ``base_rows``, ``centroids``, ``radii``, ``idx`` and
    ``leaf_size``; ``base_ids``, ``delta_rows``, ``delta_ids``,
    ``tombstones``, ``next_id`` and ``rebuild_threshold``; with the
    index's ``metric``.  Its pending mutations carry across as they
    stand."""
    _need(state, _DYNAMIC_KEYS)
    base_rows, leaf_size, *rest = (state[key] for key in _DYNAMIC_KEYS)
    return DynamicIndex._from_state(base_rows, metric, leaf_size, *rest,
                                    device=device)
