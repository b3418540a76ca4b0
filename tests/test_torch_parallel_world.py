"""The port's ``parallel`` outside the 8-rank world of
``test_torch_parallel.py``: every entry point in a world of one (no
process group: ``default_mesh`` starts one on a ``HashStore``) against the
single-device port call bit for bit, ``default_mesh``'s factoring against
the JAX meshes, the names and signatures against the JAX ``parallel``,
``dryrun_multichip`` on 4 gloo ranks, and the MST's row-block core scan
against the JAX one."""

import inspect
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from petal_neighbors_tpu import parallel as jpar
from petal_neighbors_tpu.trees import boruvka as jb

from petal_neighbors_tpu_torch import parallel as tpar
from petal_neighbors_tpu_torch.parallel import api, dryrun
from petal_neighbors_tpu_torch.trees import boruvka as tb

import torch_parallel_cases as cases

TIMEOUT_S = 300


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """The checks of ``cases.world_of_one``, run in a process of its own
    with no process group."""
    path = tmp_path_factory.mktemp("parallel_one")
    np.savez(path / "in.npz", **cases.make_inputs())
    proc = multiprocessing.get_context("spawn").Process(
        target=cases.world_of_one,
        args=(str(path / "in.npz"), str(path / "out.npz")))
    proc.start()
    proc.join(TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
    assert proc.exitcode == 0, proc.exitcode
    return dict(np.load(path / "out.npz"))


CHECKS = ("meshes", "n_devices_mismatch_raises", "knn_query_sharded",
                "knn_points_sharded", "knn_ring", "knn_feature_sharded",
                "tree_query_sharded", "radius_query_sharded",
                "radius_points_sharded", "mutual_reachability_mst_sharded")


@pytest.mark.parametrize("check", CHECKS)
def test_world_of_one_equals_single_device(world_of_one, check):
    """With no process group, ``default_mesh`` starts a world of one; every
    entry point there equals the single-device port call bit for bit."""
    assert world_of_one[check] == 1


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_default_mesh_factors_as_jax(n):
    assert api.mesh_shape(n, 1) == jpar.default_mesh(n).devices.shape
    assert api.mesh_shape(n, 2) == jpar.default_mesh(
        n, ("q", "p")).devices.shape


def test_default_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.default_mesh()
    assert not dist.is_initialized()


def test_names_and_signatures_match_jax():
    assert tpar.__all__ == jpar.__all__
    for name in jpar.__all__:
        want = inspect.signature(getattr(jpar, name)).parameters
        got = dict(inspect.signature(getattr(tpar, name)).parameters)
        if name != "init_distributed":
            assert got.pop("device").default is None, name
        assert [(p.name, p.kind, p.default) for p in got.values()] == [
            (p.name, p.kind, p.default) for p in want.values()], name


def test_dryrun_multichip_cpu():
    dryrun.dryrun_multichip(4, device="cpu")


def test_core_scan_block_matches_jax():
    """The MST's row-block core scan against the JAX one on ragged row
    blocks of the corpus, with tiles smaller than both: bit for bit on
    small integers, within 2·d ulp on real data (XLA's CPU jit fuses
    FMAs)."""
    rng = np.random.default_rng(5)
    for pts, rtol in ((rng.integers(-6, 7, size=(301, 6)), 0.0),
                      (rng.normal(size=(301, 6)), 2 * 6 * 2.0 ** -24)):
        pts = pts.astype(np.float32)
        for rows, k in ((slice(37, 130), 5), (slice(290, 301), 1)):
            got = tb._core_scan_block(torch.from_numpy(pts),
                                      torch.from_numpy(pts[rows]), k=k,
                                      qchunk=40, nchunk=64)
            want = jb._core_scan_block(jnp.asarray(pts),
                                       jnp.asarray(pts[rows]), k=k,
                                       qchunk=40, nchunk=64)
            # the JAX block pads the rows to whole tiles
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want)[:got.shape[0]],
                                       rtol=rtol, atol=0)
            np.testing.assert_array_equal(
                tb._core_distances_block(torch.from_numpy(pts),
                                         torch.from_numpy(pts[rows]),
                                         k=k).numpy(), got.numpy())
