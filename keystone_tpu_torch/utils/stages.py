"""Stage times of a run, marked where the work happens.

A ``StageTimer`` entered with ``with`` becomes the active timer of the
current context. Code on the path calls ``mark(name)`` when a stage ends:
the time since the previous mark is credited to ``name``, and repeated
names (one per batch, say) add up. ``note(name, fn)`` keeps ``fn()``'s
value beside the times, and calls ``fn`` only when a timer is active, so
the instrumentation costs nothing otherwise.

On a CUDA device each mark records an event on the current stream, so a
stage's time is the stream's time between two events, read once at the
end (one synchronise); on the CPU it is the host clock.
"""

from __future__ import annotations

import time
from contextvars import ContextVar
from typing import Callable, Dict, List, Optional, Tuple

import torch

_ACTIVE: ContextVar[Optional["StageTimer"]] = ContextVar("stage_timer", default=None)


class StageTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self._marks: List[Tuple[Optional[str], object]] = []
        self.notes: Dict[str, object] = {}
        self._token = None

    def __enter__(self) -> "StageTimer":
        self._token = _ACTIVE.set(self)
        self._marks.append((None, stamp(self.device)))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._token)

    def mark(self, name: str) -> None:
        self._marks.append((name, stamp(self.device)))

    def seconds(self) -> Dict[str, float]:
        """Seconds per stage name, in the order the names first ended."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: Dict[str, float] = {}
        for (_, t0), (name, t1) in zip(self._marks, self._marks[1:]):
            out[name] = out.get(name, 0.0) + elapsed_s(t0, t1)
        return out


def stamp(device: torch.device):
    """A point in time: an event recorded on the current stream of a CUDA
    device, the host clock otherwise."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def elapsed_s(t0, t1) -> float:
    """Seconds between two ``stamp``s (events must have completed)."""
    return t0.elapsed_time(t1) / 1e3 if isinstance(t0, torch.cuda.Event) else t1 - t0


def synced_clock(device) -> float:
    """The host clock once ``device``'s queued work has finished."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def active() -> Optional[StageTimer]:
    """The active timer of the current context, if any."""
    return _ACTIVE.get()


def mark(name: str) -> None:
    timer = _ACTIVE.get()
    if timer is not None:
        timer.mark(name)


def note(name: str, fn: Callable[[], object]) -> None:
    timer = _ACTIVE.get()
    if timer is not None:
        timer.notes[name] = fn()
