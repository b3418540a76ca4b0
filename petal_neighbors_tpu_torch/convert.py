"""Carry a JAX ``BruteForce`` index across to the port without a rebuild.

The index's "weights" are its resident arrays.  A JAX kernel-layout
``BruteForce`` holds them as ``points`` (the original, on the host),
``_center``, ``_pallas_pts``, ``_pallas_norms`` and ``_invalid`` — the
outputs of its ``prepare_euclidean_index`` (``mu, ppad, pnorm, bad``).
Handed over as numpy arrays, they make a port index that answers the same
queries with the same arithmetic.
"""

from __future__ import annotations

from .trees.bruteforce import BruteForce

__all__ = ["bruteforce_from_jax_arrays"]

_KEYS = ("points", "center", "ppad", "pnorm", "bad")


def bruteforce_from_jax_arrays(arrays, *, device=None) -> BruteForce:
    """A port ``BruteForce`` (Euclidean, kernel layout) from a JAX index's
    resident arrays: ``arrays`` maps ``points``, ``center``, ``ppad``,
    ``pnorm`` and ``bad`` to numpy arrays, as the JAX
    ``prepare_euclidean_index`` returns them (``ppad`` may be padded to
    any row count)."""
    missing = [key for key in _KEYS if key not in arrays]
    if missing:
        raise KeyError(f"missing arrays: {missing}; need {list(_KEYS)}")
    return BruteForce._from_prepared(
        arrays["points"], arrays["center"], arrays["ppad"], arrays["pnorm"],
        arrays["bad"], device=device)
