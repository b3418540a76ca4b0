"""Whether the window's k-NN answers are right: every answer against the
plain reference, once the window has closed and the program's state is
freed.

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

The window hands its answers over as it made them: ``window["answers"]``
is a list of ``(rows, dists, ids)`` parts in window order, ``rows`` the
pool rows answered and ``dists`` / ``ids`` their (rows, k) answers.  The
check compares each answer in place with the one before it for the same
pool row; an answer equal to it is checked once and counted as often as
it came.  Only those distinct answers are read again, a block at a time,
so the check holds no float64, sorted or joined copy of the window.
"""

from __future__ import annotations

import numpy as np
import torch

#: distinct answers checked together on the device
ROWS = 8192


def _gap(got, want):
    g = np.abs(got - want) / np.maximum(want, np.finfo(np.float64).tiny)
    return np.where(np.isfinite(g), g, np.inf)


def _once_a_row(parts):
    """The parts, each split where a pool row comes again in it: the j-th
    answer to a row goes to the part's j-th piece, so each row keeps its
    answers in window order."""
    out = []
    for rows, dists, ids in parts:
        order = np.argsort(rows, kind="stable")
        srt = rows[order]
        start = np.flatnonzero(np.r_[True, srt[1:] != srt[:-1]])
        if start.size == srt.size:
            out.append((rows, dists, ids))
            continue
        occ = np.empty_like(order)
        occ[order] = np.arange(srt.size) - np.repeat(
            start, np.diff(np.r_[start, srt.size]))
        for j in range(int(occ.max()) + 1):
            sel = np.flatnonzero(occ == j)
            out.append((rows[sel], dists[sel], ids[sel]))
    return out


def _take(a, sel):
    """``a[sel]``, as a view where ``sel`` is a run of positions."""
    if sel.size and np.all(np.diff(sel) == 1):
        return a[sel[0]:sel[-1] + 1]
    return a[sel]


def _equal(d1, i1, d2, i2):
    """Whether two sets of answers are equal, row by row; NaN distances
    equal NaN."""
    same = np.all(i1 == i2, axis=1)
    deq = np.all(d1 == d2, axis=1)
    redo = np.flatnonzero(same & ~deq)
    if redo.size:
        a, b = d1[redo], d2[redo]
        deq[redo] = np.all((a == b) | (np.isnan(a) & np.isnan(b)), axis=1)
    return same & deq


def _distinct(parts, pool_rows: int):
    """The distinct answers: for each run of equal answers to one pool row,
    its row, the part and position of its first answer, and how many
    answers it holds; in the order of their rows, each row's in window
    order."""
    last = np.full(pool_rows, -1)        # the part that answered a row last
    at = np.zeros(pool_rows, np.int64)   # and the row's position in it
    run = np.zeros(pool_rows, np.int64)  # the run its last answer is in
    row, part, pos, members = [], [], [], []
    held = 0
    for p, (rows, dists, ids) in enumerate(parts):
        same = np.zeros(rows.size, dtype=bool)
        prev = last[rows]
        for q in np.unique(prev[prev >= 0]):
            sel = np.flatnonzero(prev == q)
            qsel = at[rows[sel]]
            same[sel] = _equal(_take(dists, sel), _take(ids, sel),
                               _take(parts[q][1], qsel),
                               _take(parts[q][2], qsel))
        new = np.flatnonzero(~same)
        run[rows[new]] = held + np.arange(new.size)
        held += new.size
        row.append(rows[new])
        part.append(np.full(new.size, p))
        pos.append(new)
        members.append(run[rows])
        last[rows] = p
        at[rows] = np.arange(rows.size)
    row, part, pos, members = (np.concatenate(x)
                               for x in (row, part, pos, members))
    order = np.argsort(row, kind="stable")
    count = np.bincount(members, minlength=row.size)
    return row[order], part[order], pos[order], count[order]


def compare(window, config, pool, limits, device, make_points, *,
            reference):
    """``(numbers, wrong)``: ``numbers`` maps each compared number to
    ``(value, limit)``; ``wrong`` counts the window's answers over a
    limit.  ``make_points()`` makes the cell's points again on
    ``device``; ``reference`` is the plain reference module (``search``,
    ``distances``)."""
    parts = _once_a_row(window["answers"])
    n = config["n"]
    k = parts[0][2].shape[1]
    row, part, first, mult = _distinct(parts, pool.shape[0])
    used = np.unique(row)
    points = make_points()
    qs = torch.from_numpy(pool[used]).to(device)
    dref, _ = reference.search(points, qs, k)
    dref = dref.cpu().numpy()

    rank, bad, idg = [], [], []
    for s in range(0, row.size, ROWS):
        blk = slice(s, s + ROWS)
        i = np.empty((len(row[blk]), k), np.int64)
        d = np.empty((len(row[blk]), k), np.float64)
        for p in np.unique(part[blk]):
            m = part[blk] == p
            i[m] = parts[p][2][first[blk][m]]
            d[m] = parts[p][1][first[blk][m]]
        pos = np.searchsorted(used, row[blk])
        want = dref[pos]
        rank.append(_gap(d, want).max(axis=1))
        srt = np.sort(i, axis=1)
        bad.append(((i < 0) | (i >= n)).sum(axis=1)
                   + (srt[:, 1:] == srt[:, :-1]).sum(axis=1))
        got = reference.distances(
            points, qs[torch.from_numpy(pos).to(device)],
            torch.from_numpy(np.clip(i, 0, n - 1)).to(device)).cpu().numpy()
        ok = (i >= 0) & (i < n)
        idg.append(np.where(ok, _gap(got, want), 0.0).max(axis=1))
    del points, qs
    rank, bad, idg = (np.concatenate(x) for x in (rank, bad, idg))
    numbers = {
        "rank_gap": (float(rank.max()), float(limits["rank_gap"])),
        "id_gap": (float(idg.max()), float(limits["id_gap"])),
        "bad_ids": (int((bad * mult).sum()), int(limits["bad_ids"])),
    }
    wrong_distinct = ((rank > limits["rank_gap"]) | (idg > limits["id_gap"])
                      | (bad > 0))
    wrong = int(mult[wrong_distinct].sum())
    return numbers, wrong
