"""The k-NN check, read a range of pool rows at a time, gives the numbers
and the count of wrong answers that the check over the whole window gave,
on windows made by hand: pool rows that repeat, answers that change from
one visit of a row to the next, tied distances, and ids that are -1, out
of range or repeated."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kb_legacy
from kb_helpers import CHECKOUT  # noqa: F401  (puts the checkout on sys.path)
from knnbench import check, data, spec

K = 6
N = 60
LIMITS = {"rank_gap": 1e-5, "id_gap": 1e-5, "bad_ids": 0}
CONFIG = {"n": N, "d": 3}


@pytest.fixture
def grid(monkeypatch):
    """Points and queries on a small integer grid, so that many distances
    tie; both checks make the same points."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.integers(0, 4, (N, 3)).astype(np.float32))
    monkeypatch.setattr(data, "make_points",
                        lambda config, device, root=None: pts.clone())
    pool = rng.integers(0, 4, (24, 3)).astype(np.float32)
    return pts, pool


class Recorder:
    """The reference, with every block its ``distances`` reads kept."""

    def __init__(self, ref):
        self.ref, self.blocks = ref, []

    def search(self, *args, **kwargs):
        return self.ref.search(*args, **kwargs)

    def distances(self, points, queries, ids):
        self.blocks.append((queries.clone(), ids.clone()))
        return self.ref.distances(points, queries, ids)


def _answers(pts, pool, ref):
    d, i = ref.search(pts, torch.from_numpy(pool), K)
    return d.numpy().astype(np.float32), i.numpy().astype(np.int32)


def _faults(rng, rows, d, i, visit):
    """The answers to ``rows`` on one visit, some of them altered."""
    d, i = d[rows].copy(), i[rows].copy()
    if visit % 2:
        # ties listed in another order: the same distances, other ids
        # where two ranks tie
        for r in range(len(rows)):
            t = np.flatnonzero(d[r, 1:] == d[r, :-1])
            if t.size:
                a = t[0]
                i[r, [a, a + 1]] = i[r, [a + 1, a]]
    kind = visit % 5
    r = rng.integers(0, len(rows))
    if kind == 1:
        i[r, -1] = -1
    elif kind == 2:
        i[r, 2] = N + 3
    elif kind == 3:
        i[r, 1] = i[r, 0]
    elif kind == 4:
        d[r, 3] *= np.float32(1 + 1e-3)
    if visit == 3:
        d[r, 0] = np.nan
    return d, i


def _window(pts, pool, ref, mode, faulty, seed):
    rng = np.random.default_rng(seed)
    d, i = _answers(pts, pool, ref)
    parts = []
    if mode == "batch":
        b, last = 8, {}
        for visit, off in enumerate([0, 8, 16, 0, 8, 16, 0, 8]):
            rows = np.arange(off, off + b)
            if visit >= 6:
                # the previous visit's answers again, wrong ones included
                dd, ii = last[off]
            elif faulty:
                dd, ii = _faults(rng, rows, d, i, visit)
            else:
                dd, ii = d[rows], i[rows]
            last[off] = (dd, ii)
            parts.append((rows, dd, ii))
    else:
        # one query at a time, the pool cycled: one part of 41 answers
        rows = np.arange(41) % 20
        got = [(_faults(rng, rows[s:s + 8], d, i, s // 8) if faulty
                else (d[rows[s:s + 8]], i[rows[s:s + 8]]))
               for s in range(0, rows.size, 8)]
        parts.append((rows, np.concatenate([g[0] for g in got]),
                      np.concatenate([g[1] for g in got])))
    return parts


@pytest.mark.parametrize("rows_at_once", [8192, 7, 3, 1])
@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("mode", ["batch", "single"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_same_numbers_as_the_whole_window(grid, monkeypatch, mode,
                                              faulty, rows_at_once, seed):
    pts, pool = grid
    ref = spec.reference("euclidean")
    parts = _window(pts, pool, ref, mode, faulty, seed)
    whole = {"rows": np.concatenate([p[0] for p in parts]),
             "dists": np.concatenate([p[1] for p in parts]),
             "ids": np.concatenate([p[2] for p in parts])}
    monkeypatch.setattr(kb_legacy, "ROWS", rows_at_once)
    monkeypatch.setattr(check, "ROWS", rows_at_once)
    old_calls, new_calls = Recorder(ref), Recorder(ref)
    want = kb_legacy.compare(whole, CONFIG, pool, old_calls, LIMITS, "cpu")
    got = check.compare({"answers": parts}, CONFIG, pool, LIMITS, "cpu",
                        lambda: data.make_points(CONFIG, "cpu"),
                        reference=new_calls)
    assert got == want
    # the reference reads the same blocks, so its sums on the card, whose
    # order may follow a block's shape, are the same too
    assert len(new_calls.blocks) == len(old_calls.blocks)
    for a, b in zip(new_calls.blocks, old_calls.blocks):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    numbers, wrong = got
    if faulty:
        assert wrong > 0 and numbers["bad_ids"][0] > 0
        assert numbers["rank_gap"][0] > LIMITS["rank_gap"]
    else:
        assert wrong == 0 and numbers["bad_ids"][0] == 0
