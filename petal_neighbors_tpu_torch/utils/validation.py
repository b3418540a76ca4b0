"""Input validation shared by every index constructor.

Replicates the construction-time contract of the reference
(ball_tree.rs:44-49, vantage_point_tree.rs:56-62):

* empty input          -> ``EmptyArrayError``
* non-row-contiguous   -> ``NotContiguousError`` (Fortran-order NumPy input)

plus the dtype policy: float32 / float64 compute, integers promoted to
float32.  Unlike the JAX package, which downcasts f64 on a TPU, f64 stays
f64 here on both the CPU and the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import EmptyArrayError, NotContiguousError

__all__ = ["check_points", "check_points_host", "check_query",
           "check_query_batch", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    A CUDA device that is not present raises — the port never carries on
    quietly on the CPU; callers that want the CPU pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def _as_float_dtype(dtype) -> torch.dtype:
    if dtype in (torch.float32, torch.float64):
        return dtype
    return torch.float32


def _validate_np(points: np.ndarray) -> None:
    if points.ndim != 2:
        raise ValueError(f"points must be 2-D, got shape {points.shape}")
    if points.shape[0] == 0 or points.shape[1] == 0:
        raise EmptyArrayError()
    # Row-contiguity: each row must be contiguous in memory. A C-order
    # matrix always is; a Fortran-order matrix with >1 row is not
    # (mirrors ndarray's `is_standard_layout` on row 0).
    if points.shape[0] > 1 and points.shape[1] > 1:
        if points.strides[1] != points.itemsize:
            raise NotContiguousError()


def _np_float(points: np.ndarray) -> np.ndarray:
    dtype = points.dtype if points.dtype in (np.float32, np.float64) \
        else np.float32
    return np.ascontiguousarray(points.astype(dtype, copy=False))


def check_points(points, device) -> torch.Tensor:
    """Validate and convert a (n, d) points matrix to a tensor on
    ``device``.

    Raises ``EmptyArrayError`` for zero rows/cols and ``NotContiguousError``
    for NumPy inputs whose rows are not contiguous (the reference's
    standard-layout check, ball_tree.rs:47-49).
    """
    if isinstance(points, np.ndarray):
        _validate_np(points)
        return torch.from_numpy(_np_float(points)).to(device)
    arr = torch.as_tensor(points)
    if arr.ndim != 2:
        raise ValueError(f"points must be 2-D, got shape {tuple(arr.shape)}")
    if arr.shape[0] == 0 or arr.shape[1] == 0:
        raise EmptyArrayError()
    return arr.to(device=device, dtype=_as_float_dtype(arr.dtype)).contiguous()


def check_points_host(points):
    """``check_points`` that keeps NumPy input on the HOST (no device
    upload): indexes whose device-resident representation is derived
    (centered / padded copies) hold no second device copy of the
    original.  Tensors are validated and returned where they are."""
    if isinstance(points, np.ndarray):
        _validate_np(points)
        return _np_float(points)
    arr = torch.as_tensor(points)
    return check_points(arr, arr.device)


def check_query(point, dim: int, dtype, device) -> torch.Tensor:
    """Validate a single (d,) query vector against the index dimension."""
    q = torch.as_tensor(np.asarray(point) if not torch.is_tensor(point)
                        else point)
    if q.ndim != 1:
        raise ValueError(f"query point must be 1-D, got shape {tuple(q.shape)}")
    if q.shape[0] != dim:
        raise ValueError(f"query dim {q.shape[0]} != index dim {dim}")
    return q.to(device=device, dtype=dtype)


def check_query_batch(queries, dim: int, dtype, device) -> torch.Tensor:
    """Validate a (q, d) batch of query vectors."""
    q = torch.as_tensor(np.asarray(queries) if not torch.is_tensor(queries)
                        else queries)
    if q.ndim != 2:
        raise ValueError(
            f"query batch must be 2-D, got shape {tuple(q.shape)}")
    if q.shape[1] != dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {dim}")
    return q.to(device=device, dtype=dtype).contiguous()
