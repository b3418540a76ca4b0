"""Carry a JAX ``BruteForce`` or ``BallTree`` index across to the port
without a rebuild.

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
leaf size.
"""

from __future__ import annotations

from .distance import Cosine, Euclidean, get_metric
from .ops.cuda.lp_kernel import lp_spec_for
from .trees.ball import BallTree
from .trees.bruteforce import BruteForce

__all__ = ["balltree_from_jax_arrays", "bruteforce_from_jax_arrays"]

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
    missing = [key for key in _KEYS[layout] if key not in arrays]
    if missing:
        raise KeyError(f"missing arrays: {missing}; need "
                       f"{list(_KEYS[layout])}")
    extra = {key: arrays[key] for key in ("center", "pnorm", "mask")
             if key in _KEYS[layout]}
    return BruteForce._from_prepared(arrays["points"], arrays["ppad"],
                                     arrays["bad"], metric=metric,
                                     device=device, **extra)


def balltree_from_jax_arrays(arrays, *, metric="euclidean", leaf_size,
                             device=None) -> BallTree:
    """A port ``BallTree`` from a JAX tree's arrays, as numpy: ``points``,
    ``centroids`` (``.nodes.centroids``), ``radii`` (``.nodes.radii``) and
    ``idx`` (``.idx``), with the tree's ``metric`` and ``leaf_size``.  It
    answers the same queries with no rebuild (the JAX package's
    ``BallTree._from_arrays``)."""
    missing = [key for key in ("points", "centroids", "radii", "idx")
               if key not in arrays]
    if missing:
        raise KeyError(f"missing arrays: {missing}; need points, "
                       "centroids, radii, idx")
    return BallTree._from_arrays(arrays["points"], metric, leaf_size,
                                 arrays["centroids"], arrays["radii"],
                                 arrays["idx"], device=device)
