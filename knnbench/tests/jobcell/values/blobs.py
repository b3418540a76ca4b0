"""Seeded Gaussian blobs: ``centers`` centres uniform in [0, ``box``)^d,
each point one of them, drawn at random, plus normal noise of ``spread``.
Made on the device by one generator from ``data_seed``, in float32."""

import numpy as np
import torch


def make_points(config, device):
    v = config["values"]
    n, d, c = int(config["n"]), int(config["d"]), int(v["centers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["data_seed"]))
    centres = torch.rand((c, d), generator=gen, device=device) * float(v["box"])
    which = torch.randint(0, c, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device)
    return centres[which] + noise * float(v["spread"])


def make_pool(config, seed, rows):
    """A job sends no queries: an empty pool."""
    return np.zeros((rows, int(config["d"])), dtype=np.float32)
