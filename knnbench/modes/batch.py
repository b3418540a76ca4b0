"""Batch mode: ANN-Benchmarks' batch mode, one client in a closed loop.

Each batch is a contiguous slice of the host query pool, sent through
``index.query_batch(queries, k)`` as NumPy float32; its distances and ids
are copied back to the host before the next batch is sent.  The pool
holds ``pool`` distinct queries, a whole number of batches, cycled, so no
query repeats inside a batch.  ``qps`` is every query answered in the window over the
time from the window's start to the last batch's answers on the host;
only whole batches count.  The window's answers go to the check as the
batches made them, one ``(rows, dists, ids)`` part a batch.

Traffic keys: ``k``; ``batch`` (a number, or "published" for the
configuration's published query count); ``pool``; ``warmup_steps``.
"""

from __future__ import annotations

import time

import numpy as np

END_TO_END = {"qps": "queries/s"}


def batch_size(config: dict, traffic: dict) -> int:
    b = traffic["batch"]
    return int(config["queries"] if b == "published" else b)


def pool_size(config: dict, traffic: dict) -> int:
    b, pool = batch_size(config, traffic), int(traffic["pool"])
    if pool % b:
        raise ValueError(f"a pool of {pool} queries is no whole number of "
                         f"{b}-query batches")
    return pool


def queries_per_step(config: dict, traffic: dict) -> int:
    return batch_size(config, traffic)


def _call(index, pool, off, b, k, tracer):
    with tracer.span("knnbench.query_batch"):
        d, i = index.query_batch(pool[off:off + b], k)
    with tracer.span("knnbench.to_host"):
        return d.cpu().numpy(), i.cpu().numpy()


def warm(index, pool, config, traffic, tracer) -> None:
    """The window's one shape, ``warmup_steps`` times."""
    b = batch_size(config, traffic)
    for j in range(int(traffic["warmup_steps"])):
        _call(index, pool, (j * b) % pool.shape[0], b, traffic["k"], tracer)


def drive(index, pool, config, traffic, seconds, tracer):
    """Run batches until ``seconds`` have passed; returns the window's
    answers, its end-to-end metrics and notes for the run's earlier lines."""
    b, k = batch_size(config, traffic), int(traffic["k"])
    nb = pool.shape[0] // b
    offs, dists, ids, walls = [], [], [], []
    t0 = t = time.perf_counter()
    j = 0
    while True:
        off = (j % nb) * b
        ts = t
        d, i = _call(index, pool, off, b, k, tracer)
        t = time.perf_counter()
        tracer.step()
        offs.append(off)
        dists.append(d)
        ids.append(i)
        walls.append(t - ts)
        j += 1
        if t - t0 >= seconds:
            break
    elapsed = t - t0
    attempted = j * b
    walls_ms = np.asarray(walls) * 1e3
    return {
        "answers": [(np.arange(o, o + b), d, i)
                    for o, d, i in zip(offs, dists, ids)],
        "attempted": attempted,
        "metrics": {"qps": attempted / elapsed},
        "notes": {"batches": j, "batch": b, "window_s": elapsed,
                  "batch_ms_p50": float(np.percentile(walls_ms, 50)),
                  "batch_ms_p95": float(np.percentile(walls_ms, 95)),
                  "batch_ms_max": float(walls_ms.max())},
    }
