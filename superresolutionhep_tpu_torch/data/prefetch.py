"""Background batch prefetching (a copy of the JAX package's
``data/prefetch.py``).

Host-side batch preparation (per-event preprocessing and collation) is pure
numpy/python, so a thread pool suffices: the GIL is released inside numpy
and while the device step runs.  Batches are delivered strictly in order,
so training stays reproducible whatever the completion order.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class BatchPrefetcher(Iterator[R]):
    """Iterate ``prepare(item)`` over ``items`` with a bounded look-ahead.

    - ``num_workers <= 0``: fully synchronous (no threads), for debugging.
    - Otherwise up to ``2 * num_workers`` prepared batches are in flight,
      keeping the host pipeline ahead of the device without unbounded RAM.
    - In-order delivery: results come back in submission order even when
      later items finish first.
    - Errors raised inside ``prepare`` propagate to the consumer at the
      position of the failing item; remaining work is cancelled and the same
      error is re-raised on every subsequent ``next()`` (never a silent
      StopIteration after a failure).
    """

    def __init__(
        self,
        items: Iterable[T],
        prepare: Callable[[T], R],
        num_workers: int = 2,
        lookahead: int | None = None,
    ):
        self._items = iter(items)
        self._prepare = prepare
        self._num_workers = int(num_workers)
        self._lookahead = lookahead if lookahead is not None else max(2 * self._num_workers, 1)
        self._pool: ThreadPoolExecutor | None = None
        self._inflight: deque = deque()
        self._closed = False
        self._error: BaseException | None = None

    def __iter__(self) -> "BatchPrefetcher[R]":
        return self

    def _fill(self) -> None:
        while len(self._inflight) < self._lookahead:
            try:
                item = next(self._items)
            except StopIteration:
                return
            assert self._pool is not None
            self._inflight.append(self._pool.submit(self._prepare, item))

    def __next__(self) -> R:
        if self._num_workers <= 0:
            return self._prepare(next(self._items))
        if self._error is not None:
            raise self._error
        if self._closed:
            raise StopIteration
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers, thread_name_prefix="prefetch"
            )
            self._fill()
        if not self._inflight:
            self._shutdown()
            raise StopIteration
        fut = self._inflight.popleft()
        try:
            result = fut.result()
        except BaseException as e:
            self._error = e
            self._shutdown(cancel=True)
            raise
        self._fill()
        return result

    def _shutdown(self, cancel: bool = False) -> None:
        self._closed = True
        if cancel:
            for f in self._inflight:
                f.cancel()
            self._inflight.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=cancel)
            self._pool = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self._shutdown(cancel=True)
        except Exception:
            pass
