"""Single mode: one query at a time, as ANN-Benchmarks' default mode and a
single-query server send them.

One client sends query ``j`` of the host pool at its due time
``t0 + j / rate_qps`` (an open loop at a fixed rate; a query due while
the previous one runs is sent when it returns), through
``index.query(point, k)``, the reference-shaped single-query API that
takes a NumPy point and returns NumPy answers.  A query's time runs from
its due time to its answers on the host, so a stall counts against the
queries behind it.  ``query_p95_ms`` is the 95th percentile of every
query's time in the window.  With ``rate_qps`` null the loop is closed
(each query sent when the previous returns): the calibration's capacity
sweep uses it; no cell does.

Traffic keys: ``k``, ``rate_qps``, ``pool`` (distinct queries, cycled),
``warmup_batch`` (queries of the pool sent once as one batch in the
warm-up), ``warmup_steps``.
"""

from __future__ import annotations

import time

import numpy as np

END_TO_END = {"query_p95_ms": "ms"}


def pool_size(config: dict, traffic: dict) -> int:
    return int(traffic["pool"])


def queries_per_step(config: dict, traffic: dict) -> int:
    return 1


def _wait_until(due):
    """Spin to the due time: a thread that sleeps between queries wakes
    to a cold core, and the next query's host path runs slower (on the
    card, at 4/5 of capacity, the 95th percentile moved 3% from run to run
    with sleeps, 1% with spinning)."""
    while time.perf_counter() < due:
        pass


def warm(index, pool, config, traffic, tracer) -> None:
    k = int(traffic["k"])
    # one batch reaches the route's rarely taken repair, whose first call
    # loads its kernels
    d, i = index.query_batch(pool[:int(traffic["warmup_batch"])], k)
    d.cpu(), i.cpu()
    for j in range(int(traffic["warmup_steps"])):
        with tracer.span("knnbench.query"):
            index.query(pool[j % pool.shape[0]], k)


def drive(index, pool, config, traffic, seconds, tracer):
    """Send queries until ``seconds`` have passed; returns the window's
    answers, its end-to-end metric and notes for the run's earlier lines."""
    k = int(traffic["k"])
    rate = traffic.get("rate_qps")
    gap = 0.0 if rate is None else 1.0 / float(rate)
    n = pool.shape[0]
    rows, dists, ids, lat, late = [], [], [], [], []
    t0 = t = time.perf_counter()
    due = t0
    j = 0
    while True:
        if rate is None:
            due = t
        with tracer.span("knnbench.pace_wait"):
            _wait_until(due)
        sent = time.perf_counter()
        p = j % n
        with tracer.span("knnbench.query"):
            i, d = index.query(pool[p], k)
        t = time.perf_counter()
        tracer.step()
        rows.append(p)
        ids.append(i)
        dists.append(d)
        lat.append(t - due)
        late.append(sent - due)
        j += 1
        due += gap
        if t - t0 >= seconds:
            break
    lat_ms = np.asarray(lat) * 1e3
    return {
        "answers": [(np.asarray(rows, dtype=np.int64), np.stack(dists),
                     np.stack(ids))],
        "attempted": j,
        "metrics": {"query_p95_ms": float(np.percentile(lat_ms, 95))},
        "notes": {"queries": j, "window_s": t - t0,
                  "rate_qps": rate, "achieved_qps": j / (t - t0),
                  "query_ms_pcts": {p: float(np.percentile(lat_ms, p))
                                    for p in (50, 80, 90, 95, 97.5, 99)},
                  "query_ms_max": float(lat_ms.max()),
                  "sent_late_ms_p95": float(np.percentile(late, 95)) * 1e3,
                  "sent_late_ms_max": float(max(late)) * 1e3},
    }
