"""Typed input-validation errors.

Mirrors the reference crate's error surface (``ArrayError`` in
petal-neighbors ``src/lib.rs:10-16``): ``Empty`` ("array is empty") and
``NotContiguous`` ("array is not contiguous in memory"), raised by the
index constructors before any compute is traced.
"""

from __future__ import annotations

__all__ = ["ArrayError", "EmptyArrayError", "NotContiguousError"]


class ArrayError(ValueError):
    """Base class for input-array validation errors (lib.rs:10-16)."""


class EmptyArrayError(ArrayError):
    """The input array has no rows (lib.rs:12 ``ArrayError::Empty``)."""

    def __init__(self, msg: str = "array is empty") -> None:
        super().__init__(msg)


class NotContiguousError(ArrayError):
    """The input rows are not contiguous in memory
    (lib.rs:15 ``ArrayError::NotContiguous``).

    In the reference this rejects Fortran-ordered matrices
    (ball_tree.rs:47-49). NumPy inputs that are not C-contiguous by rows
    trigger the same error here for contract parity; JAX arrays are always
    accepted (XLA owns the layout).
    """

    def __init__(self, msg: str = "array is not contiguous in memory") -> None:
        super().__init__(msg)
