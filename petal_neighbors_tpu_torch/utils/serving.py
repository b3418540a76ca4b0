"""Single-query serving by micro-batching (the JAX package's
``utils/serving.py``).

The reference's primary API is the synchronous single query
(``BallTree::query``, ball_tree.rs:80-142).  On the card one query costs
a whole batch's launches and host work, so ``QueryStream`` keeps the
single-query call shape (``submit`` returns a handle at once, ``result()``
gives the answer) and coalesces every pending submit into one
``index.query_batch`` call at the first ``result()`` or ``flush()``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AsyncResult", "QueryStream"]


class AsyncResult:
    """Handle to a pending single-query k-NN result."""

    __slots__ = ("_stream", "_ticket", "_out")

    def __init__(self, stream, ticket: int):
        self._stream = stream
        self._ticket = ticket
        self._out = None

    def result(self):
        """(indices (k,) int64, distances (k,)) as NumPy: flushes the
        stream's pending batch on the first call, then reads this query's
        row."""
        if self._out is None:
            self._out = self._stream._materialize(self._ticket)
        return self._out


class QueryStream:
    """Micro-batched single-query serving over any exact index.

    >>> stream = QueryStream(index, k=10)
    >>> handles = [stream.submit(q) for q in qs]     # buffered, no launch
    >>> answers = [h.result() for h in handles]      # one query_batch

    ``submit`` never launches; the first ``result()`` (or ``flush()``)
    answers everything pending with one ``index.query_batch`` call and one
    copy of its results to the host.  Interleaved submits and results
    work too: each flush covers the submits since the previous one.
    """

    def __init__(self, index, k: int):
        self._index = index
        self._k = int(k)
        self._pending: list = []
        self._pending_base = 0
        self._done: dict[int, tuple] = {}

    def submit(self, point) -> AsyncResult:
        """Queue one (d,) query (NumPy or a tensor); returns its handle."""
        ticket = self._pending_base + len(self._pending)
        self._pending.append(torch.as_tensor(point))
        return AsyncResult(self, ticket)

    def flush(self) -> None:
        """Answer all pending submits with one ``query_batch`` call."""
        if not self._pending:
            return
        batch = torch.stack(self._pending)
        d, i = self._index.query_batch(batch, self._k)
        d = d.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64)
        for row in range(len(batch)):
            self._done[self._pending_base + row] = (i[row], d[row])
        self._pending_base += len(batch)
        self._pending = []

    def _materialize(self, ticket: int):
        if ticket not in self._done:
            self.flush()
        return self._done.pop(ticket)

    def query_many(self, points):
        """Answer a sequence of single queries through one flush; returns
        their (indices, distances) pairs in order."""
        handles = [self.submit(p) for p in points]
        return [h.result() for h in handles]
