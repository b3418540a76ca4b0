"""The port's row sorts (bitonic and counting rank), as they run on the CPU
(their plain version, a stable ``torch.sort``), against the JAX kernels in
interpret mode, on the same seeded rows: duplicate keys, +inf tails, a
ragged row count and widths that are not powers of two.

Tolerance: none.  Keys must match exactly.  The counting rank breaks ties
by input position in both packages, so its payloads match exactly; the
JAX bitonic network orders ties arbitrarily, so there payloads match as
multisets within each run of equal finite keys.  Known difference: the
JAX bitonic pads a row to a power of two with (+inf, -1), and its padding
may land among a row's own +inf keys, so in the +inf run its payloads may
hold -1; the port's payloads there are the row's own."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petal_neighbors_tpu.ops.pallas.rank_sort_kernel import (
    rank_sort_pairs as jax_rank)
from petal_neighbors_tpu.ops.pallas.sort_kernel import (
    bitonic_sort_pairs as jax_bitonic)
from petal_neighbors_tpu_torch.ops.cuda import rank_sort_kernel as rk
from petal_neighbors_tpu_torch.ops.cuda import sort_kernel as sk

ROWS = 13


def _rows(width, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, max(2, width // 4), (ROWS, width))
            .astype(np.float32) * 0.25)
    keys[:, width - width // 5:] = np.inf          # +inf tails
    keys[2, ::7] = np.inf                          # scattered +inf
    keys[5] = 1.5                                  # one tie run
    vals = rng.permutation(ROWS * width).reshape(ROWS, width).astype(np.int32)
    return keys, vals


def _runs(keys):
    """(start, end) of each run of equal keys in a sorted row."""
    cut = np.flatnonzero(keys[1:] != keys[:-1]) + 1
    edges = np.concatenate([[0], cut, [len(keys)]])
    return zip(edges[:-1], edges[1:])


@pytest.mark.parametrize("width", [100, 1008, 2176])
@pytest.mark.parametrize("kind", ["bitonic", "rank"])
def test_row_sort_matches_jax(kind, width):
    keys, vals = _rows(width, width)
    jax_fn, port_fn = ((jax_bitonic, sk.bitonic_sort_pairs) if kind ==
                       "bitonic" else (jax_rank, rk.rank_sort_pairs))
    jk, jv = (np.asarray(a) for a in jax_fn(jnp.asarray(keys),
                                            jnp.asarray(vals),
                                            interpret=True))
    tk, tv = port_fn(torch.from_numpy(keys), torch.from_numpy(vals))
    tk, tv = tk.numpy(), tv.numpy()
    assert tk.shape == keys.shape and tv.dtype == np.int32
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tk, np.sort(keys, axis=1))
    order = np.argsort(keys, axis=1, kind="stable")
    # the port is a stable sort on the CPU (and on the card)
    np.testing.assert_array_equal(tv, np.take_along_axis(vals, order, 1))
    if kind == "rank":
        np.testing.assert_array_equal(tv, jv)
        return
    for r in range(ROWS):
        for s, e in _runs(tk[r]):
            if np.isfinite(tk[r, s]):
                assert sorted(tv[r, s:e]) == sorted(jv[r, s:e]), (r, s)
            else:
                assert set(jv[r, s:e]) <= set(tv[r, s:e]) | {-1}, r


@pytest.mark.parametrize("fn", [sk.bitonic_sort_pairs, rk.rank_sort_pairs])
def test_row_sort_cpu_counts_no_launch_and_checks_inputs(fn):
    keys, vals = _rows(64, 3)
    before = fn.launches
    out = fn(torch.from_numpy(keys), torch.from_numpy(vals))
    assert fn.launches == before
    ref = sk.sort_pairs_reference(torch.from_numpy(keys),
                                  torch.from_numpy(vals))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(TypeError):
        fn(torch.from_numpy(keys).double(), torch.from_numpy(vals))
    with pytest.raises(ValueError):
        fn(torch.from_numpy(keys), torch.from_numpy(vals[:, :10]))
    empty = fn(torch.zeros((0, 5)), torch.zeros((0, 5), dtype=torch.int32))
    assert empty[0].shape == (0, 5)
