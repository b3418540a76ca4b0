"""Index checkpoint and resume (the JAX package's ``utils/serialize.py``).

Every index is its points, a few dense arrays and some static metadata, so
one ``.npz`` restores it exactly: the arrays bit for bit, with no rebuild
(a ``BruteForce`` prepares its layout again from its points, as the JAX
package's does).  The keys and dtypes are the JAX package's, so a file
written by either package loads in the other: the VP tree's flat query
tables are int32 in the file and int64 on the device here.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..distance import Minkowski, get_metric

__all__ = ["save_index", "load_index"]

_FORMAT_VERSION = 3          # v3: the VP tree's flat query tables
                             # (v2: DynamicIndex base, delta and tombstones)


def _metric_spec(metric) -> str:
    if isinstance(metric, Minkowski):
        return json.dumps({"name": "minkowski", "p": metric.p})
    return json.dumps({"name": metric.name})


def _metric_from_spec(spec: str):
    d = json.loads(spec)
    name = d.pop("name")
    return get_metric(name, **d)


def _host(a, dtype=None) -> np.ndarray:
    """A C-order host copy of a tensor or array, in ``dtype`` if given."""
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a if dtype is None else a.astype(dtype))


def _leaf(leaf_size) -> np.int64:
    return np.int64(-1 if leaf_size is None else leaf_size)


def save_index(index, path) -> None:
    """Write a ``BallTree``, ``VantagePointTree``, ``BruteForce`` or
    ``DynamicIndex`` to ``path`` (format v3)."""
    from ..trees.ball import BallTree
    from ..trees.bruteforce import BruteForce
    from ..trees.dynamic import DynamicIndex
    from ..trees.vantage import VantagePointTree

    if isinstance(index, DynamicIndex):
        _save_dynamic(index, path)
        return
    if not isinstance(index, (BallTree, VantagePointTree, BruteForce)):
        raise TypeError(f"cannot serialize {type(index).__name__}")
    common = {"format_version": np.int64(_FORMAT_VERSION),
              "metric": _metric_spec(index.metric),
              "points": _host(index.points)}
    if isinstance(index, BallTree):
        np.savez_compressed(
            path, kind="ball", **common, idx=_host(index.idx, np.int64),
            centroids=_host(index.nodes.centroids),
            radii=_host(index.nodes.radii), leaf_size=_leaf(index._leaf_size))
    elif isinstance(index, VantagePointTree):
        tp, mem, at, an, ar = index._flat_tables()
        nodes = index.nodes
        np.savez_compressed(
            path, kind="vantage", **common,
            vp=_host(nodes["vantage_point"], np.int64),
            radius=_host(nodes["radius"], index._np_dtype()),
            near=_host(nodes["near"], np.int64),
            far=_host(nodes["far"], np.int64),
            root=np.int64(index.root), depth=np.int64(index.depth),
            flat_trunk_pts=_host(tp, np.int32),
            flat_members=_host(mem, np.int32),
            flat_anc_t=_host(at, np.int32), flat_anc_near=_host(an, bool),
            flat_anc_rho=_host(ar))
    else:
        np.savez_compressed(path, kind="brute", **common)


def _save_dynamic(index, path) -> None:
    """The base tree's arrays, the id table and the pending mutations
    (delta rows and ids, tombstones): a save mid-stream restores the exact
    serving state."""
    base = index._base
    delta_rows = (np.concatenate(index._delta_rows, axis=0)
                  if index._delta_rows
                  else np.zeros((0, index.dim), dtype=index._base_rows.dtype))
    delta_ids = (np.concatenate(index._delta_ids)
                 if index._delta_ids else np.zeros(0, dtype=np.int64))
    np.savez_compressed(
        path, kind="dynamic",
        format_version=np.int64(_FORMAT_VERSION),
        metric=_metric_spec(index.metric),
        points=_host(index._base_rows), idx=_host(base.idx, np.int64),
        centroids=_host(base.nodes.centroids), radii=_host(base.nodes.radii),
        leaf_size=_leaf(index._leaf_size),
        base_ids=_host(index._base_ids, np.int64),
        delta_rows=_host(delta_rows), delta_ids=_host(delta_ids, np.int64),
        tombstones=np.asarray(sorted(index._tombstones), dtype=np.int64),
        next_id=np.int64(index._next_id),
        rebuild_threshold=np.float64(index.rebuild_threshold))


def load_index(path, *, device=None):
    """Load an index written by ``save_index`` (of either package) onto
    ``device`` (None means ``"cuda"``), restoring its arrays bit for bit
    with no rebuild.  Raises ``ValueError`` for a newer format or an
    unknown kind."""
    from ..trees.ball import BallTree
    from ..trees.bruteforce import BruteForce
    from ..trees.dynamic import DynamicIndex
    from ..trees.vantage import VantagePointTree

    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"unsupported index format v{version}")
        kind = str(z["kind"])
        metric = _metric_from_spec(str(z["metric"]))
        points = z["points"]
        if kind == "ball":
            leaf = int(z["leaf_size"])
            return BallTree._from_arrays(
                points, metric, None if leaf < 0 else leaf, z["centroids"],
                z["radii"], z["idx"], device=device)
        if kind == "vantage":
            tree = VantagePointTree._from_arrays(
                points, metric, z["vp"], z["radius"], z["near"], z["far"],
                int(z["root"]), int(z["depth"]), device=device)
            if "flat_members" in z.files:       # v3 (absent in v1 and v2)
                tree._set_flat(tuple(z[k] for k in (
                    "flat_trunk_pts", "flat_members", "flat_anc_t",
                    "flat_anc_near", "flat_anc_rho")))
            return tree
        if kind == "brute":
            return BruteForce(points, metric, device=device)
        if kind == "dynamic":
            leaf = int(z["leaf_size"])
            return DynamicIndex._from_state(
                points, metric, None if leaf < 0 else leaf, z["centroids"],
                z["radii"], z["idx"], z["base_ids"], z["delta_rows"],
                z["delta_ids"], z["tombstones"], int(z["next_id"]),
                float(z["rebuild_threshold"]), device=device)
        raise ValueError(f"unknown index kind {kind!r}")
