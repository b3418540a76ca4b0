"""The plain reference of the mutual-reachability MST, in float64 NumPy
over the dense matrix: a point's core distance is the distance to its
``min_samples``-th nearest, itself counted; two points' mutual
reachability is the largest of their core distances and their distance;
Prim's algorithm takes the tree.  Every MST of a graph has the same sorted
edge weights, so a tree is held to the reference's by those:

* ``weight_gap``: the largest relative gap between the tree's sorted
  weights and the reference's;
* ``edge_gap``: the largest relative gap between an edge's weight and the
  reference's mutual reachability of its two ends;
* ``bad_edges``: edges out of range or from a point to itself, edges
  missing or too many, and components the edges leave unjoined.
"""

import numpy as np
import torch


def mutual_reachability(points, k):
    diff = points[:, None, :] - points[None, :, :]
    dist = np.sqrt((diff * diff).sum(-1))
    core = np.sort(dist, axis=1)[:, k - 1]
    return np.maximum(dist, np.maximum(core[:, None], core[None, :]))


def mst_weights(m):
    """Sorted edge weights of the MST of the dense graph ``m`` (Prim)."""
    n = m.shape[0]
    inside = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    best[0], out = 0.0, []
    for _ in range(n):
        j = int(np.argmin(np.where(inside, np.inf, best)))
        if inside.any():
            out.append(best[j])
        inside[j] = True
        best = np.minimum(best, m[j])
    return np.sort(np.asarray(out))


def components(n, us, vs):
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in zip(us, vs):
        parent[find(a)] = find(b)
    return len({find(a) for a in range(n)})


def _gap(got, want):
    g = np.abs(got - want) / np.maximum(want, np.finfo(np.float64).tiny)
    return float(np.max(np.where(np.isfinite(g), g, np.inf), initial=0.0))


def compare(window, config, pool, limits, device, make_points):
    pts = make_points().to(torch.float64).cpu().numpy()
    n = pts.shape[0]
    m = mutual_reachability(pts, int(config["min_samples"]))
    want = mst_weights(m)
    worst = {"weight_gap": 0.0, "edge_gap": 0.0, "bad_edges": 0}
    wrong = 0
    for us, vs, ws in window["results"]:
        us, vs = np.asarray(us, np.int64), np.asarray(vs, np.int64)
        ws = np.asarray(ws, np.float64)
        ok = (us >= 0) & (us < n) & (vs >= 0) & (vs < n) & (us != vs)
        bad = int((~ok).sum()) + abs(ws.size - (n - 1)) + components(
            n, us[ok], vs[ok]) - 1
        got = {"weight_gap": (_gap(np.sort(ws), want) if ws.size == n - 1
                              else np.inf),
               "edge_gap": _gap(ws[ok], m[us[ok], vs[ok]]),
               "bad_edges": bad}
        wrong += any(got[x] > limits[x] for x in got)
        worst = {x: max(worst[x], got[x]) for x in got}
    return {x: (worst[x], limits[x]) for x in worst}, wrong
