"""The tensor-core tier's operand planes: ``split_planes`` and its plain
version.

The capped, bcap, merge and minima kernels (``csrc/knn_tc.cuh``) multiply
each float32 operand element as three bf16 pieces (``split_bf16x3``: hi,
mid and lo, each rounded to nearest).  The core reads those pieces from
shared memory in ``wgmma``'s K-major, 64-byte-swizzled layout, and brings
them there by bulk copies from planes in device memory that are split
once: an index splits its rows at build and holds the planes, a call
splits its queries.  ``split_planes`` makes them (``csrc/split_planes.cu``
on the card; ``split_planes_reference`` on the CPU, bit for bit the same
bytes).

Layout of the planes of an (rows, d) float32 array: a bfloat16 tensor of
``planes_shape(rows, d)`` = (tiles, chunks, 3, 128, 32), tiles =
⌈rows / 128⌉ and chunks = ⌈d / 32⌉.  ``[t, c, p]`` is piece p (hi, mid,
lo) of rows 128 t .. 128 t + 127 and features 32 c .. 32 c + 31, one row
of 32 bf16 a row, whose four 8-feature segments are swizzled: feature
8 j + e of row r sits at column 8 (j ^ ((r >> 1) & 3)) + e (the core's
byte offset (r >> 3)·512 + (r & 7)·64 + ((j ^ ((r >> 1) & 3)) << 4)).
Rows past ``rows`` and features past d are zero.  Each (tile, chunk) is
24,576 contiguous bytes, 1.5 times the float32 bytes it holds at d a
multiple of 32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import count

__all__ = ["split_planes", "split_planes_reference", "index_planes",
           "planes_shape", "check_planes", "PLANE_ROWS", "PLANE_COLS",
           "PIECES"]

#: rows of a plane tile (the core's 128-row product tile)
PLANE_ROWS = 128

#: features of a plane chunk (the core's 32-feature chunk, two k-steps)
PLANE_COLS = 32

#: bf16 pieces of an element (hi, mid, lo)
PIECES = 3

#: features of a swizzled 16-byte segment
_SEG = 8


def planes_shape(rows: int, d: int) -> tuple[int, int, int, int, int]:
    """Shape of the planes of an (rows, d) array (module docstring)."""
    return (-(-rows // PLANE_ROWS), -(-d // PLANE_COLS), PIECES, PLANE_ROWS,
            PLANE_COLS)


def check_planes(planes, x, name: str) -> None:
    """Raise ValueError unless ``planes`` are planes of ``x`` (rows, d):
    bfloat16, ``planes_shape``, contiguous, on x's device."""
    want = planes_shape(*x.shape)
    if (not torch.is_tensor(planes) or planes.dtype != torch.bfloat16
            or tuple(planes.shape) != want or planes.device != x.device
            or not planes.is_contiguous()):
        got = (None if not torch.is_tensor(planes) else
               (tuple(planes.shape), planes.dtype, str(planes.device)))
        raise ValueError(f"{name} wants the points' planes (split_planes): "
                         f"contiguous bfloat16 {want} on {x.device}, got "
                         f"{got}")


def split_planes_reference(x):
    """Plain PyTorch version of ``split_planes``: ``split_bf16x3``'s pieces
    of the float32 (rows, d) ``x``, zero-padded to whole tiles and chunks
    and swizzled (module docstring)."""
    from .knn_kernel import split_bf16x3

    rows, d = x.shape
    tiles, chunks = planes_shape(rows, d)[:2]
    padded = torch.nn.functional.pad(
        x, (0, chunks * PLANE_COLS - d, 0, tiles * PLANE_ROWS - rows))
    pieces = torch.stack(split_bf16x3(padded)).to(torch.bfloat16)
    # (piece, tile, row, chunk, segment, element)
    p = pieces.reshape(PIECES, tiles, PLANE_ROWS, chunks, PLANE_COLS // _SEG,
                       _SEG)
    r = torch.arange(PLANE_ROWS, device=x.device)
    j = torch.arange(PLANE_COLS // _SEG, device=x.device)
    # column segment s of row r holds feature segment s ^ ((r >> 1) & 3)
    src = (j[None, :] ^ ((r[:, None] >> 1) & 3))            # (row, seg)
    idx = src[None, None, :, None, :, None].expand_as(p)
    p = torch.gather(p, 4, idx)
    return p.permute(1, 3, 0, 2, 4, 5).reshape(
        planes_shape(rows, d)).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    from ._build import load

    lib = load("split_planes")
    p = ctypes.POINTER(ctypes.c_int)
    lib.split_planes_constants.argtypes = [p] * 4
    lib.split_planes_constants.restype = None
    lib.split_planes_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.split_planes_launch.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(4)]
    lib.split_planes_constants(*(ctypes.byref(v) for v in vals))
    want = (PLANE_ROWS, PLANE_COLS, PIECES, PIECES * PLANE_ROWS * PLANE_COLS
            * 2)
    if tuple(v.value for v in vals) != want:
        raise RuntimeError("csrc/split_planes.cu disagrees with this module: "
                           f"{[v.value for v in vals]}")
    return lib


def split_planes(x):
    """The tensor-core core's piece planes of the float32 (rows, d) ``x``
    (module docstring), made once per index or per call.

    CUDA tensors launch ``csrc/split_planes.cu`` (counted in
    ``split_planes.launches``); CPU tensors run
    ``split_planes_reference``.  Either way the rows split are counted in
    the profiling counter ``knn.planes_split``."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"split_planes wants float32 (rows, d), got "
                         f"{x.dtype} {tuple(x.shape)}")
    rows, d = x.shape
    if rows == 0 or d == 0:
        return torch.zeros(planes_shape(rows, d), dtype=torch.bfloat16,
                           device=x.device)
    count("knn.planes_split", rows)
    if x.device.type == "cpu":
        return split_planes_reference(x)
    x = x.contiguous()
    out = torch.empty(planes_shape(rows, d), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().split_planes_launch(
            x.data_ptr(), rows, d, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_planes kernel launch failed: cudaError "
                           f"{err}")
    split_planes.launches += 1
    return out


#: kernel launches (plain-version calls do not count)
split_planes.launches = 0


def index_planes(x):
    """The planes an index holds for its padded rows ``x``:
    ``split_planes(x)`` on the card, None on the CPU, where the kernels'
    plain versions read the rows themselves."""
    return split_planes(x) if x.is_cuda else None
