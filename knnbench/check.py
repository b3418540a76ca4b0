"""Whether the window's answers are right: every answer against the plain
reference, once the window has closed and the program's state is freed.

Three numbers are compared, each with its limit from the cell's file:

* ``rank_gap``: the largest relative gap between an answer's distance at
  rank r and the reference's r-th distance;
* ``id_gap``: the largest relative gap between the reference's own
  distance to the id served at rank r and its r-th distance (the id is
  the one it claims to be);
* ``bad_ids``: ids that are out of range, -1, or repeated in a row, over
  every answer of the window.

Both gaps are blind to the order of points that lie at equal distance, so
an exact answer passes wherever ties fall, and a skipped neighbour shows
as the gap to the next one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import data

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
