"""What ``shard_map`` and the ``jax.lax`` collectives do for the JAX
package's ``parallel/api.py``, on ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes;
every rank of the world runs the same code, and each axis name gives the
process group of the ranks that share this rank's other coordinates.
Rows are sharded as ``shard_map``'s ``P(axis)`` shards them: padded to a
multiple of the axis size, then one contiguous block per axis
coordinate.  ``all_gather_rows`` is ``all_gather`` followed by the
concatenation ``out_specs=P(axis)`` implies, ``all_reduce_sum`` is
``psum`` and ``ring_shift`` is ``ppermute`` with ``j -> j + 1``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.validation import _np_float

__all__ = ["axis_group", "axis_size", "axis_rank", "mesh_device",
           "as_tensor", "pad_rows_nan", "shard_rows", "all_gather_rows",
           "all_reduce_sum", "ring_shift"]


def axis_group(mesh, axis: str):
    """The process group of this rank's line along the mesh axis."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(axis_group(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along the mesh axis."""
    return dist.get_rank(axis_group(mesh, axis))


def mesh_device(mesh, device=None) -> torch.device:
    """The device this rank computes on: ``device``, or where ``None``
    the mesh's device type (a CUDA mesh: the current card, which
    ``default_mesh`` sets to the local rank's).  A device of another type
    than the mesh's raises ``ValueError``: its collectives could not run
    on it."""
    dev = torch.device(mesh.device_type if device is None else device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} does not match the mesh's device "
                         f"type {mesh.device_type!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, dtype=None) -> torch.Tensor:
    """A (rows, d) float tensor of ``x`` where it lies (NumPy arrays on
    the host, tensors on their device): float32 and float64 stay, other
    types become float32, or ``dtype`` where given."""
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(_np_float(x))
    else:
        t = torch.as_tensor(x)
        if t.dtype not in (torch.float32, torch.float64):
            t = t.float()
    return t if dtype is None else t.to(dtype)


def pad_rows_nan(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with NaN rows appended up to ``rows`` rows (NaN sorts
    farthest and is never selected; ``api.py:101-108``)."""
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                    float("nan"))])


def shard_rows(x: torch.Tensor, mesh, axis: str, device):
    """This rank's block of the rows of ``x`` NaN-padded to a multiple of
    the axis size, on ``device``; only the block is copied there (a block
    past the last row is all padding).  Returns (block, base): ``base``
    is the block's first global row."""
    p = axis_size(mesh, axis)
    rows = -(-x.shape[0] // p)
    base = axis_rank(mesh, axis) * rows
    return pad_rows_nan(x[base:base + rows].to(device), rows), base


def all_gather_rows(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) along the axis,
    concatenated over the first dimension in axis order."""
    group = axis_group(mesh, axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``t`` along the axis (``psum``), in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    return t


def ring_shift(t: torch.Tensor, out: torch.Tensor, mesh, axis: str) -> list:
    """Post the send of ``t`` (contiguous) to the next rank along the axis
    and the receive of the previous rank's into ``out`` (``ppermute`` with
    ``j -> j + 1``), for an axis of two ranks or more.  Returns the
    requests: wait on each before reading ``out`` or writing ``t``."""
    group = axis_group(mesh, axis)
    p, j = dist.get_world_size(group), dist.get_rank(group)
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t,
                   dist.get_global_rank(group, (j + 1) % p), group),
        dist.P2POp(dist.irecv, out,
                   dist.get_global_rank(group, (j - 1) % p), group)])
