"""Fault injection, retry with backoff, and the serving failure taxonomy.

A copy of ``keystone_tpu/utils/reliability.py`` (the exceptions at
``:72-135``, ``FaultPlan`` at ``:164``, ``active_plan``,
``reset_fault_plan`` and ``RetryPolicy``), reading the port's ``config``
for the fault plan; ``RetryPolicy``'s defaults are the reference's (4
attempts, a 5 ms base and a 1 s cap).

``FaultPlan`` is a seeded, deterministic schedule parsed from
``KEYSTONE_FAULTS`` (``site:value,...``): an integer value fires on the
first N checks of its site, a fraction is a per-check probability drawn
from a per-site ``random.Random`` seeded from ``KEYSTONE_FAULTS_SEED`` and
the site's name. The serving sites the port checks:

- ``worker_death`` — ``PipelineService``'s dispatcher thread dies; the
  next ``submit`` fails the futures it held and restarts it;
- ``replica_death`` — a replica's completion thread dies; its in-flight
  groups re-queue at the front and go to the surviving replicas, and a
  fully dead pool is revived.

Unset, ``active_plan()`` is None and the serving loops hold no plan, so the
harness costs nothing. ``RetryPolicy`` is copied for the paths that will
retry (the streamed solver's copies, the loaders); nothing in the port
wires it yet.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from keystone_tpu_torch.config import config

logger = logging.getLogger("keystone_tpu_torch")


class DeadlineExceeded(TimeoutError):
    """A serving request's deadline passed before a device call ran it."""


class QueueFullError(RuntimeError):
    """Fast-fail backpressure: the serving pending queue is at capacity."""


class ServiceClosed(RuntimeError):
    """The request hit a PipelineService that is (or has been) closed."""


class WorkerDiedError(RuntimeError):
    """The serving worker died while this request was in flight; the
    request may or may not have executed. Safe to retry idempotent work."""


class RecordCorruptError(ValueError):
    """A record is irrecoverably corrupt: no retry can fix it."""


class InjectedIOError(IOError):
    """Harness-injected transient I/O failure (site ``io``)."""


class InjectedOOM(RuntimeError):
    """Harness-injected device allocation failure (site ``oom``). The
    message carries RESOURCE_EXHAUSTED so one classifier covers injected
    and real failures alike."""


def is_oom(exc: BaseException) -> bool:
    """Device out-of-memory, real or injected. PyTorch raises
    ``torch.OutOfMemoryError`` (a ``RuntimeError`` saying "out of memory")."""
    if isinstance(exc, (InjectedOOM, MemoryError)):
        return True
    text = str(exc)
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text


def is_transient(exc: BaseException) -> bool:
    """Worth retrying: the same operation may succeed on a fresh attempt.
    Corrupt records are not: retrying a bad byte stream reproduces it."""
    if isinstance(exc, RecordCorruptError):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, (FileNotFoundError, IsADirectoryError, NotADirectoryError))
    return is_oom(exc)


class FaultPlan:
    """Seeded, deterministic fault schedule parsed from a ``site:value,...``
    spec. Integer values are counts (fire on the first N checks of the
    site); fractional values are per-check probabilities. Thread-safe."""

    _RAISES: Dict[str, Callable[[], BaseException]] = {
        "io": lambda: InjectedIOError("injected transient I/O fault (KEYSTONE_FAULTS io)"),
        "corrupt": lambda: RecordCorruptError("injected corrupt record (KEYSTONE_FAULTS corrupt)"),
        "oom": lambda: InjectedOOM("RESOURCE_EXHAUSTED: injected device OOM (KEYSTONE_FAULTS oom)"),
    }

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._prob: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._rng: Dict[str, random.Random] = {}
        self.fired: Dict[str, int] = {}
        self.checked: Dict[str, int] = {}
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            try:
                site, _, raw = token.partition(":")
                site = site.strip()
                raw = raw.strip()
                if not site or not raw:
                    raise ValueError
                if "." in raw or "e" in raw.lower():
                    p = float(raw)
                    if not 0.0 <= p <= 1.0:
                        raise ValueError
                    self._prob[site] = p
                else:
                    n = int(raw)
                    if n < 0:
                        raise ValueError
                    self._count[site] = n
            except ValueError:
                raise ValueError(
                    f"KEYSTONE_FAULTS token {token!r}: expected "
                    "'site:count' (int) or 'site:probability' (0..1 float)"
                ) from None
        for site in self._prob:
            # The fire pattern at one site is a function of (seed, site,
            # check index) alone.
            self._rng[site] = random.Random(f"{self.seed}:{site}")

    @property
    def sites(self) -> tuple:
        return tuple(sorted(set(self._prob) | set(self._count)))

    def check(self, site: str) -> bool:
        """True when the plan injects a fault at this check."""
        with self._lock:
            self.checked[site] = self.checked.get(site, 0) + 1
            fire = False
            if site in self._count:
                if self._count[site] > 0:
                    self._count[site] -= 1
                    fire = True
            elif site in self._prob:
                fire = self._rng[site].random() < self._prob[site]
            if fire:
                self.fired[site] = self.fired.get(site, 0) + 1
                from keystone_tpu_torch.utils.metrics import reliability_counters

                reliability_counters.bump(f"faults_injected_{site}")
            return fire

    def maybe_raise(self, site: str) -> None:
        """Raise the site's synthetic exception when the plan fires."""
        if self.check(site):
            raise self._RAISES[site]()


_plan_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_plan_key: Optional[tuple] = None


def active_plan() -> Optional[FaultPlan]:
    """The process-wide FaultPlan, or None when injection is disabled.
    Rebuilt whenever ``config.faults`` or ``config.faults_seed`` change;
    callers take it once per stream, solve or service."""
    global _plan, _plan_key
    spec = config.faults or ""
    key = (spec, config.faults_seed)
    with _plan_lock:
        if key != _plan_key:
            _plan = FaultPlan(spec, config.faults_seed) if spec.strip() else None
            _plan_key = key
        return _plan


def reset_fault_plan() -> None:
    """Drop the cached plan (fresh counts and generators on the next
    ``active_plan``)."""
    global _plan, _plan_key
    with _plan_lock:
        _plan = None
        _plan_key = None


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter and an attempt cap: retry i
    (0-based) pauses uniformly over ``[0, min(max_delay, base * 2**i)]``,
    from a generator seeded by ``seed``."""

    max_attempts: int = 4
    base_delay: float = 0.005
    max_delay: float = 1.0
    classify: Callable[[BaseException], bool] = is_transient
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        cap = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable, *, site: str = "op", counter: Optional[str] = None):
        """``fn()`` with up to ``max_attempts`` tries. Transient failures
        (per ``classify``) back off and retry, bumping
        ``reliability_counters[counter or f"{site}_retries"]``; the last
        attempt's error, or any other error, propagates."""
        from keystone_tpu_torch.utils.metrics import reliability_counters

        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as exc:
                if not self.classify(exc) or attempt == self.max_attempts - 1:
                    raise
                reliability_counters.bump(counter or f"{site}_retries")
                pause = self.delay(attempt)
                logger.debug(
                    "retrying %s after %s (attempt %d/%d, backoff %.1f ms)",
                    site, type(exc).__name__, attempt + 1, self.max_attempts, pause * 1e3,
                )
                if pause > 0:
                    self.sleep(pause)
        raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
