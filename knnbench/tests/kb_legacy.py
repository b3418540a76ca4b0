"""The check and the data as they stood before a cell could bring its own
(``check.compare`` over the whole window in one piece, ``make_points`` and
``make_pool`` for uniform values only): what the tests hold today's code
to, bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from knnbench import data

#: seeds are taken modulo 2**63: ``torch.Generator.manual_seed`` and
#: ``numpy.random.default_rng`` both take any whole number below it
SEED_MOD = 1 << 63


def _uniform(values: dict) -> tuple[float, float]:
    if values.get("distribution") != "uniform":
        raise ValueError(f"unknown value distribution {values!r}")
    return float(values["low"]), float(values["high"])


def make_points(config: dict, device) -> torch.Tensor:
    """(n, d) float32 points on ``device``, uniform in [low, high)."""
    low, high = _uniform(config["values"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["data_seed"]) % SEED_MOD)
    pts = torch.rand((config["n"], config["d"]), generator=gen,
                     device=device, dtype=torch.float32)
    if (low, high) != (0.0, 1.0):
        pts.mul_(high - low).add_(low)
    return pts


def make_pool(config: dict, seed: int, rows: int) -> np.ndarray:
    """(rows, d) float32 distinct queries on the host, uniform in
    [low, high), from a stream of their own, in the order ``seed`` draws."""
    low, high = _uniform(config["values"])
    rng = np.random.default_rng([int(config["data_seed"]) % SEED_MOD, 1])
    pool = rng.random((rows, config["d"]), dtype=np.float32)
    if (low, high) != (0.0, 1.0):
        pool *= np.float32(high - low)
        pool += np.float32(low)
    order = np.random.default_rng([int(seed) % SEED_MOD, 2]).permutation(rows)
    return pool[order]


#: answer rows checked together on the device
ROWS = 8192


def _distinct(rows, ids, dists):
    """Indices of the distinct answers (the first of each run of equal
    answers to one pool row), and for each answer the distinct one it
    equals."""
    order = np.argsort(rows, kind="stable")
    r, i, d = rows[order], ids[order], dists[order]
    same = np.zeros(order.size, dtype=bool)
    same[1:] = ((r[1:] == r[:-1]) & np.all(i[1:] == i[:-1], axis=1)
                & np.all((d[1:] == d[:-1]) | (np.isnan(d[1:])
                                              & np.isnan(d[:-1])), axis=1))
    group = np.cumsum(~same) - 1
    firsts = order[~same]
    owner = np.empty(order.size, dtype=np.int64)
    owner[order] = group
    return firsts, owner


def _gap(got, want):
    g = np.abs(got - want) / np.maximum(want, np.finfo(np.float64).tiny)
    return np.where(np.isfinite(g), g, np.inf)


def compare(window, config, pool, reference, limits, device):
    """``(numbers, wrong)``: ``numbers`` maps each compared number to
    ``(value, limit)``; ``wrong`` counts the window's answers over a
    limit."""
    rows, ids = window["rows"], np.asarray(window["ids"], dtype=np.int64)
    dists = np.asarray(window["dists"], dtype=np.float64)
    n = config["n"]
    k = ids.shape[1]
    firsts, owner = _distinct(rows, ids, dists)
    used = np.unique(rows)
    points = data.make_points(config, device)
    qs = torch.from_numpy(pool[used]).to(device)
    dref, _ = reference.search(points, qs, k)
    dref = dref.cpu().numpy()

    r, i, d = rows[firsts], ids[firsts], dists[firsts]
    pos = np.searchsorted(used, r)
    want = dref[pos]
    rank = _gap(d, want).max(axis=1)
    srt = np.sort(i, axis=1)
    bad = ((i < 0) | (i >= n)).sum(axis=1) + (
        srt[:, 1:] == srt[:, :-1]).sum(axis=1)
    idg = np.zeros(len(firsts))
    for s in range(0, len(firsts), ROWS):
        ib = np.clip(i[s:s + ROWS], 0, n - 1)
        got = reference.distances(
            points, qs[torch.from_numpy(pos[s:s + ROWS]).to(device)],
            torch.from_numpy(ib).to(device)).cpu().numpy()
        g = _gap(got, want[s:s + ROWS])
        ok = (i[s:s + ROWS] >= 0) & (i[s:s + ROWS] < n)
        idg[s:s + ROWS] = np.where(ok, g, 0.0).max(axis=1)
    del points, qs
    numbers = {
        "rank_gap": (float(rank.max()), float(limits["rank_gap"])),
        "id_gap": (float(idg.max()), float(limits["id_gap"])),
        "bad_ids": (int(bad[owner].sum()), int(limits["bad_ids"])),
    }
    wrong_distinct = ((rank > limits["rank_gap"]) | (idg > limits["id_gap"])
                      | (bad > 0))
    wrong = int(wrong_distinct[owner].sum())
    return numbers, wrong
