"""The port's row sorts (bitonic and counting rank), as they run on the CPU
(their plain version, a stable ``torch.sort``), against the JAX kernels in
interpret mode, on the same seeded rows: duplicate keys, +inf tails, a row
of only +inf, a row of equal keys, negative keys, -0.0 among +0.0, a ragged
row count and widths from 1 to 3072, powers of two or not.

Tolerance: none.  Keys must match the JAX kernels' as numbers, and the
stable order bit for bit (-0.0 keeps its sign and its place).  The counting
rank breaks ties by input position in both packages, so its payloads match
exactly; the JAX bitonic network orders ties arbitrarily, so there payloads
match as multisets within each run of equal finite keys.  Known
differences: the JAX bitonic pads a row to a power of two with (+inf, -1),
and its padding may land among a row's own +inf keys, so in the +inf run
its payloads may hold -1 where the port's are the row's own; the JAX
counting rank places keys by a one-hot sum, which turns -0.0 into +0.0.
On the card both entry points give the stable order as well (held there by
``chip_smoke.py``)."""

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
    keys[5] = 1.5                                  # all keys equal
    keys[7] = -(rng.integers(0, max(2, width // 4), width) * 0.5)  # negative
    keys[8] = rng.choice(np.array([-0.25, -0.0, 0.0, 0.25], np.float32),
                         width)                    # -0.0 ties with +0.0
    keys[9] = np.inf                               # only +inf
    vals = rng.permutation(ROWS * width).reshape(ROWS, width).astype(np.int32)
    return keys, vals


def _runs(keys):
    """(start, end) of each run of equal keys in a sorted row."""
    cut = np.flatnonzero(keys[1:] != keys[:-1]) + 1
    edges = np.concatenate([[0], cut, [len(keys)]])
    return zip(edges[:-1], edges[1:])


@pytest.mark.parametrize("width", [1, 2, 100, 256, 1008, 2176, 3072])
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
    # the stable order bit for bit, -0.0 in its place
    np.testing.assert_array_equal(
        tk.view(np.int32), np.take_along_axis(keys, order, 1).view(np.int32))
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
