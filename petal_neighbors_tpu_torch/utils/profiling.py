"""Profiling helpers (the JAX package's ``utils/profiling.py``).

``trace`` wraps ``torch.profiler`` (the JAX package wraps
``jax.profiler``) and exports a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``wall_time`` times a block on the host clock,
synchronising the card first.  The indexes' own counters
(``query_batch(with_stats=True)``, the kernels' ``launches``) complete the
picture.

``span`` and ``count`` instrument the flat index's k-NN path.  A span is
a ``torch.profiler.record_function`` while a profiler is recording, so it
lands in the same trace as the kernels and copies it launches, on the
same clock, inside whatever span encloses it on the thread; with no
profiler recording it is a shared no-op context.  The spans:

* ``petal.query``: ``BruteForce.query``, the whole single-query call, and
  inside it ``petal.query.to_host``, the answers' two copies to NumPy;
* ``petal.query_batch``: ``BruteForce.query_batch``, validation and upload,
  the scheme's pick and the route (the Lp and scan routes have no spans
  below it);
* ``petal.route``: ``ops.bruteforce.knn_prepadded``, and inside it
  ``petal.route.prep`` (centring, normalising, the proof's error bound;
  inside it ``petal.route.normalize``, a cosine index's query
  normalisation),
  ``petal.route.candidates`` (the candidate kernel), ``petal.route.rescore``
  (the direct-form rescore and re-rank), ``petal.route.proof`` (the k-th
  distance against the threshold), ``petal.route.repair`` (the body of
  ``_prove_repair``) and ``petal.route.out`` (sqrt and clamp); every
  route call of ``knn_merge`` (the merge scheme's candidates, and the
  repair above ``k_scan = 1024``) lies in ``petal.route.merge``, inside
  ``petal.route.candidates`` or ``petal.route.repair``.

``count`` adds to in-memory integer counters, always on: one dict update,
never a sync with the card.  ``route.queries`` counts the queries of every
``knn_prepadded`` call; ``route.normalized`` those it normalised (a
cosine index's); ``route.repaired`` the queries its proof left to the
repair; ``knn.few_queries`` the queries of every launch of the
few-query kernel (``ops.cuda.knn_kernel.knn_few``); ``knn.merge_queries``
the queries of every ``ops.cuda.knn_kernel.knn_merge`` call.
``counters`` returns a copy, ``reset_counters`` clears them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "wall_time", "span", "count", "counters",
           "reset_counters"]

_recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_counters: dict[str, int] = {}


def span(name: str):
    """A ``record_function`` named ``name`` while a profiler is recording,
    else a shared no-op context: the check costs well under a
    microsecond, an unused ``record_function`` about ten."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add the host-known integer ``n`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block, on the card when one is present, and
    write its Chrome trace to ``log_dir/trace.json``.

    >>> with trace("knn-trace"):
    ...     index.query_batch(queries, 10)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(tree):
    """The first tensor leaf of nested tuples, lists and dicts, or None."""
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


@contextlib.contextmanager
def wall_time(out: dict, key: str = "seconds"):
    """Host wall seconds of the block into ``out[key]``.  When the block
    stores its result in ``out['result']``, the card holding its first
    tensor leaf is synchronised before the clock stops (kernels return
    before they finish)."""
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        leaf = _first_tensor(out.get("result"))
        if leaf is not None and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        out[key] = time.perf_counter() - t0
