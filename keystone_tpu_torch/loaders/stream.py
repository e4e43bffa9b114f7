"""Row batches fed from a background thread.

Counterpart of ``keystone_tpu/loaders/stream.py``: ``PrefetchIterator``
(``:61-354``), ``prefetch_batches`` (``:357``), ``prefetched`` (``:372``)
and ``BatchIterator`` (``:385-464``, ``from_csv`` included). A producer thread pulls the upstream
iterator into a queue ``depth`` items deep while the consumer works on
what it already has, so host work (reading, decoding, preparing a block)
overlaps the device's.

The depth is an argument, ``PREFETCH_DEPTH`` (the reference's
``config.prefetch_depth``) unless given; there is no environment variable
and no resource plan. The reference's retries, quarantine of corrupt
records, producer restart, tracer spans and gauges are not ported.
"""

from __future__ import annotations

import queue
import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

PREFETCH_DEPTH = 2

Batch = Tuple[np.ndarray, Optional[np.ndarray]]


class _Channel:
    """What the producer thread shares with its iterator. The thread holds
    this and the upstream iterator, not the ``PrefetchIterator``, so that an
    abandoned iterator is collected and its ``__del__`` stops the thread."""

    ITEM, DONE, ERROR = 0, 1, 2
    # How long a blocked put or get waits before it looks at the stop flag
    # and the producer's liveness again.
    POLL_S = 0.05

    def __init__(self, depth: int):
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.max_queued = 0

    def put(self, msg) -> bool:
        """A put that gives up once the iterator was closed; False then."""
        while not self.stop.is_set():
            try:
                self.queue.put(msg, timeout=self.POLL_S)
                return True
            except queue.Full:
                continue
        return False


def _produce(ch: _Channel, it: Iterator) -> None:
    try:
        for item in it:
            if not ch.put((ch.ITEM, item)):
                return
            ch.max_queued = max(ch.max_queued, ch.queue.qsize())
    except BaseException as exc:  # any producer error is raised again at the consumer
        ch.put((ch.ERROR, exc))
    else:
        ch.put((ch.DONE, None))


class PrefetchIterator:
    """Runs ``iter(source)`` on a daemon thread into a queue of at most
    ``depth`` items.

    - The consumer sees exactly the producer's items, in order.
    - A producer exception is raised again at the consumer's ``next()``.
    - ``close()`` (also on ``with``-exit and garbage collection) stops the
      producer, even one blocked on a full queue.
    - ``max_queued`` is the most items that were ever queued at once.

    Single use, like any iterator.
    """

    _JOIN_TIMEOUT_S = 5.0

    def __init__(self, source: Iterable, depth: int = PREFETCH_DEPTH):
        if depth < 1:
            raise ValueError(
                f"prefetch depth must be >= 1, got {depth} "
                "(prefetch_batches passes depth 0 through)"
            )
        self._ch = _Channel(depth)
        self._finished = False
        self._it: Iterator = iter(source)
        self._thread = threading.Thread(
            target=_produce, args=(self._ch, self._it), name="keystone-prefetch", daemon=True
        )
        self._thread.start()

    @property
    def max_queued(self) -> int:
        return self._ch.max_queued

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        ch = self._ch
        while True:
            try:
                kind, val = ch.queue.get(timeout=ch.POLL_S)
                break
            except queue.Empty:
                if ch.stop.is_set() or self._thread.is_alive() or not ch.queue.empty():
                    continue
                self._finished = True
                raise RuntimeError("the prefetch producer ended without a result") from None
        if ch.stop.is_set():
            # close() ran while this call waited: what it was handed is not data.
            self._finished = True
            raise StopIteration
        if kind == ch.ITEM:
            return val
        self._finished = True
        self._thread.join(timeout=self._JOIN_TIMEOUT_S)
        if kind == ch.ERROR:
            raise val
        raise StopIteration

    def close(self) -> None:
        """Stops the producer and empties the queue. Idempotent."""
        self._finished = True
        ch = self._ch
        ch.stop.set()
        try:
            while True:
                ch.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=self._JOIN_TIMEOUT_S)
        if not self._thread.is_alive():
            # Closing a generator that another thread runs raises, so the
            # upstream is closed only once its producer is gone.
            close_upstream = getattr(self._it, "close", None)
            if close_upstream is not None:
                close_upstream()
        try:
            # Wakes a consumer still waiting in another thread.
            ch.queue.put_nowait((ch.DONE, None))
        except queue.Full:
            pass

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # the interpreter may be half torn down
            pass


def prefetch_batches(batches: Iterable, depth: int = PREFETCH_DEPTH):
    """``batches`` behind a ``PrefetchIterator`` of ``depth``; depth 0
    returns ``batches`` itself."""
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth}")
    if depth == 0:
        return batches
    return PrefetchIterator(batches, depth)


@contextmanager
def prefetched(batches: Iterable, depth: int = PREFETCH_DEPTH):
    """``prefetch_batches`` as a context manager that closes the prefetcher
    (stopping its thread) on exit."""
    src = prefetch_batches(batches, depth)
    try:
        yield src
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()


class BatchIterator:
    """Re-iterable source of (features, labels or None) row batches."""

    def __init__(self, factory: Callable[[], Iterable[Batch]]):
        self._factory = factory

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._factory())

    @staticmethod
    def from_arrays(X, y=None, batch_rows: int = 4096) -> "BatchIterator":
        X = np.asarray(X)
        y_arr = None if y is None else np.asarray(y)

        def gen():
            for s in range(0, X.shape[0], batch_rows):
                e = min(s + batch_rows, X.shape[0])
                yield X[s:e], None if y_arr is None else y_arr[s:e]

        return BatchIterator(gen)

    @staticmethod
    def from_csv(path: str, label_col: Optional[int] = 0, batch_rows: int = 4096,
                 label_dtype=np.int32) -> "BatchIterator":
        """A CSV in batches of ``batch_rows`` rows, read as it streams (the
        reference's ``:407-446``): float32 features, and the ``label_col``
        column as ``label_dtype`` labels (None: no labels). Pass a float
        dtype for regression targets, which int32 would truncate."""

        def emit(rows, labels):
            X = np.asarray(rows, dtype=np.float32)
            return X, None if label_col is None else np.asarray(labels, dtype=label_dtype)

        def gen():
            rows, labels = [], []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    vals = [float(v) for v in line.split(",")]
                    if label_col is not None:
                        labels.append(vals.pop(label_col))
                    rows.append(vals)
                    if len(rows) == batch_rows:
                        yield emit(rows, labels)
                        rows, labels = [], []
            if rows:
                yield emit(rows, labels)

        return BatchIterator(gen)

    def map_batches(self, fn: Callable[[Any], Any]) -> "BatchIterator":
        """``fn`` applied to every feature batch, where the batches are made
        (so on the prefetch thread of a ``prefetch`` view)."""

        def gen():
            for X, y in self:
                yield fn(X), y

        return BatchIterator(gen)

    def prefetch(self, depth: int = PREFETCH_DEPTH) -> "BatchIterator":
        """A re-iterable view whose every iteration runs the producer chain
        (``map_batches`` included) on its own thread, ``depth`` ahead."""
        return BatchIterator(lambda: prefetch_batches(iter(self), depth))
