"""Profiling helpers (the JAX package's ``utils/profiling.py``).

``trace`` wraps ``torch.profiler`` (the JAX package wraps
``jax.profiler``) and exports a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``wall_time`` times a block on the host clock,
synchronising the card first.  The indexes' own counters
(``query_batch(with_stats=True)``, the kernels' ``launches``) complete the
picture.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "wall_time"]


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
