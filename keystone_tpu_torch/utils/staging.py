"""Host data to the device through recycled pinned buffers on a copy stream.

The streamed paths (``Transformer.apply_batches``,
``linalg/bcd.py::block_coordinate_descent_streamed``) prepare host data on
a prefetch thread and use it on the device, double-buffered: the copy of
item j+1 runs while the device works on item j. On a CUDA device:

- ``fill(shape, dtype, write)`` (the producer, on any thread) takes a free
  pinned buffer, waiting for one, and lets ``write`` fill a view of it;
- ``upload(staged)`` (the consumer) allocates the device tensor on the
  current stream, makes the copy stream wait for the current stream (the
  caching allocator may hand the new tensor memory that work queued there
  still reads), copies with ``non_blocking=True`` on the copy stream and
  records an event after the copy;
- ``ready(uploaded)`` makes the current stream wait for that event, just
  before the tensor is used, so that work queued earlier is not held up;
- ``reclaim()`` waits for every copy in flight and returns its buffer to
  the pool: a pinned buffer is refilled only after its copy completed. The
  consumer calls it before it asks the producer for the next item, so the
  producer, holding one buffer and the queue at most ``depth``, always
  finds a free one among ``depth + 2``.

On the CPU the same calls run without pinning or streams: ``fill`` writes
a fresh tensor and ``upload`` and ``ready`` hand it on. Pinning or a stream
that fails raises; nothing falls back to pageable or synchronous copies.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import NamedTuple, Optional

import torch

_POLL_S = 0.05


class Staged(NamedTuple):
    host: torch.Tensor  # the filled view
    buffer: Optional[torch.Tensor]  # the pinned bytes it lies in (None on the CPU)
    seconds: float  # host time of the write


class Uploaded(NamedTuple):
    tensor: torch.Tensor
    copied: Optional[torch.cuda.Event]  # recorded after the copy (None on the CPU)
    started: Optional[torch.cuda.Event]  # recorded before it, when timed
    prep_s: float  # the host time of the fill

    def copy_ms(self) -> float:
        """Device milliseconds of the copy, once it completed (0 on the CPU)."""
        return 0.0 if self.started is None else self.started.elapsed_time(self.copied)


class HostStager:
    def __init__(self, device, buffers: int, timed: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.timed = timed and self.cuda
        self._free: "queue.Queue" = queue.Queue()
        self._in_flight = []
        self._closed = threading.Event()
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            for _ in range(buffers):
                self._free.put(None)  # allocated at first use, at the size asked for

    def _take(self) -> Optional[torch.Tensor]:
        while not self._closed.is_set():
            try:
                return self._free.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        raise RuntimeError("the host stager was closed")

    def fill(self, shape, dtype, write) -> Staged:
        """A host tensor of ``shape`` and ``dtype`` that ``write(out)`` fills
        (in a pinned buffer on a CUDA device)."""
        if not self.cuda:
            t0 = time.perf_counter()
            out = torch.empty(shape, dtype=dtype)
            write(out)
            return Staged(out, None, time.perf_counter() - t0)
        buf = self._take()
        nbytes = math.prod(shape) * dtype.itemsize
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("a staging buffer could not be pinned")
        t0 = time.perf_counter()
        out = buf[:nbytes].view(dtype).view(shape)
        write(out)
        return Staged(out, buf, time.perf_counter() - t0)

    def upload(self, staged: Staged) -> Uploaded:
        if not self.cuda:
            return Uploaded(staged.host, None, None, staged.seconds)
        if staged.buffer is None:
            raise ValueError("only a pinned staging buffer goes to the card asynchronously")
        dev = torch.empty(staged.host.shape, dtype=staged.host.dtype, device=self.device)
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        started = torch.cuda.Event(enable_timing=True) if self.timed else None
        copied = torch.cuda.Event(enable_timing=self.timed)
        with torch.cuda.stream(self._copy_stream):
            if started is not None:
                started.record()
            dev.copy_(staged.host, non_blocking=True)
            copied.record()
        self._in_flight.append((staged.buffer, copied))
        return Uploaded(dev, copied, started, staged.seconds)

    def ready(self, up: Uploaded) -> torch.Tensor:
        if up.copied is not None:
            torch.cuda.current_stream(self.device).wait_event(up.copied)
        return up.tensor

    def reclaim(self) -> None:
        for buf, copied in self._in_flight:
            copied.synchronize()
            self._free.put(buf)
        self._in_flight.clear()

    def close(self) -> None:
        """Waits for the copies in flight and wakes a producer waiting for a
        buffer, which then raises."""
        self.reclaim()
        self._closed.set()
