"""Row sort of (f32 key, int32 payload) pairs on the card, in the place of
the bitonic network.

Counterpart of ``petal_neighbors_tpu/ops/pallas/sort_kernel.py``: the
re-rank of ``ops.bruteforce._rescore_large`` and ``_bcap_rescore_large`` at
widths up to 2048.  ``bitonic_sort_pairs`` launches the block sort of
``csrc/row_sort.cu`` for CUDA tensors: each warp sorts 256 (key, position)
words in registers by a bitonic network of register compare-exchanges and
shuffles, and a row wider than 256 merges its warps' runs by merge path in
shared memory.  CPU tensors run ``bitonic_sort_pairs_reference``; a CUDA
tensor launches the kernel or raises.

Contract: keys NaN-free (callers map NaN to +inf; -0.0 ties with +0.0);
each row sorts ascending; the payload follows its key; ties go by input
position, so on the card and on the CPU the output equals a stable sort and
a gather, bit for bit, payloads included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["bitonic_sort_pairs", "bitonic_sort_pairs_reference",
           "sort_pairs_reference"]


def sort_pairs_reference(keys, vals):
    """Plain PyTorch row sort: a stable ``torch.sort`` and a ``gather``."""
    out_k, pos = torch.sort(keys, dim=1, stable=True)
    return out_k, torch.gather(vals, 1, pos)


bitonic_sort_pairs_reference = sort_pairs_reference


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("row_sort")
    lib.row_sort_max_width.argtypes = []
    lib.row_sort_max_width.restype = ctypes.c_int
    for fn in (lib.bitonic_sort_launch, lib.rank_sort_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_pairs(keys, vals, name: str) -> None:
    if keys.ndim != 2 or vals.shape != keys.shape:
        raise ValueError(f"{name} wants keys and vals of one (R, W) shape, "
                         f"got {tuple(keys.shape)} and {tuple(vals.shape)}")
    if keys.dtype != torch.float32 or vals.dtype != torch.int32:
        raise TypeError(f"{name} wants float32 keys and int32 vals, got "
                        f"{keys.dtype} and {vals.dtype}")
    if keys.device != vals.device or keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} wants keys and vals on one CUDA or CPU "
                         "device")


def launch_sort(entry: str, keys, vals, name: str):
    """Run ``csrc/row_sort.cu``'s ``entry`` over the rows of (keys, vals)
    on the card; returns new (keys, vals) of the same shape."""
    rows, width = keys.shape
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    if rows == 0 or width == 0:
        return out_k, out_v
    lib = _lib()
    if width > lib.row_sort_max_width():
        raise ValueError(f"{name} takes rows of at most "
                         f"{lib.row_sort_max_width()}, got {width}")
    keys = keys.contiguous()
    vals = vals.contiguous()
    with torch.cuda.device(keys.device):
        err = getattr(lib, entry)(
            keys.data_ptr(), vals.data_ptr(), out_k.data_ptr(),
            out_v.data_ptr(), rows, width,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out_k, out_v


def bitonic_sort_pairs(keys, vals):
    """Sort each row of ``keys`` (R, W) float32 ascending, carrying
    ``vals`` (R, W) int32, ties by input position (a stable sort); returns
    arrays of the original shape.  W <= 8192.  CUDA tensors launch the
    block sort of ``csrc/row_sort.cu`` (counted in
    ``bitonic_sort_pairs.launches``); CPU tensors run
    ``bitonic_sort_pairs_reference``."""
    check_pairs(keys, vals, "bitonic_sort_pairs")
    if keys.device.type == "cpu":
        return bitonic_sort_pairs_reference(keys, vals)
    out = launch_sort("bitonic_sort_launch", keys, vals, "bitonic_sort_pairs")
    bitonic_sort_pairs.launches += 1
    return out


#: kernel launches (plain-version calls do not count)
bitonic_sort_pairs.launches = 0
