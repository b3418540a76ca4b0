"""The cell's data: a fixed data set, and an order of queries drawn from
``--seed``.

The data set stands in for the published files, which are one fixed set:
its points and its query pool are made from the configuration's
``data_seed``, so every run serves the same points and the same queries,
and ``--seed`` draws the order in which the pool is sent.  Every seed thus
gets the same work in another order (the proof's repairs, whose number
depends on the data, do not move with the seed).  The points are made on
the device by one ``torch.Generator`` call, in float32, the type they are
served in; the query pool on the host as NumPy float32, as a client would
hand it over.  The reference makes the points again after the program's
state is freed, so it takes nothing the program made.

The configuration's ``values.distribution`` names the data: ``uniform``
is built in; any other name is a file ``values/<name>.py`` of the
benchmark's folder (``root``) that defines ``make_points(config, device)``
and ``make_pool(config, seed, rows)`` with the contracts below.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec

#: seeds are taken modulo 2**63: ``torch.Generator.manual_seed`` and
#: ``numpy.random.default_rng`` both take any whole number below it
SEED_MOD = 1 << 63


def _uniform(values: dict) -> tuple[float, float]:
    return float(values["low"]), float(values["high"])


def _values_file(config: dict, root):
    """The configuration's ``values/`` file, or None for ``uniform``."""
    name = config["values"].get("distribution")
    return None if name == "uniform" else spec.values(name, root)


def make_points(config: dict, device, root=None) -> torch.Tensor:
    """(n, d) float32 points on ``device``, uniform in [low, high)."""
    own = _values_file(config, root)
    if own is not None:
        return own.make_points(config, device)
    low, high = _uniform(config["values"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["data_seed"]) % SEED_MOD)
    pts = torch.rand((config["n"], config["d"]), generator=gen,
                     device=device, dtype=torch.float32)
    if (low, high) != (0.0, 1.0):
        pts.mul_(high - low).add_(low)
    return pts


def make_pool(config: dict, seed: int, rows: int, root=None) -> np.ndarray:
    """(rows, d) float32 distinct queries on the host, uniform in
    [low, high), from a stream of their own, in the order ``seed`` draws."""
    own = _values_file(config, root)
    if own is not None:
        return own.make_pool(config, seed, rows)
    low, high = _uniform(config["values"])
    rng = np.random.default_rng([int(config["data_seed"]) % SEED_MOD, 1])
    pool = rng.random((rows, config["d"]), dtype=np.float32)
    if (low, high) != (0.0, 1.0):
        pool *= np.float32(high - low)
        pool += np.float32(low)
    order = np.random.default_rng([int(seed) % SEED_MOD, 2]).permutation(rows)
    return pool[order]
