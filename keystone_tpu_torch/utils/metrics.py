"""The metrics that serving reads: histograms, gauges, counter sets and
the registry that holds them.

A subset of ``keystone_tpu/utils/metrics.py``: ``LatencyHistogram``
(``:431``), ``Gauge`` (``:558``), ``CounterSet`` (``:587``),
``MetricsRegistry`` with ``snapshot()`` (``:614``), ``ServingCounters``
(``:1678``), ``ReliabilityCounters`` (``:1735``), ``ServePlanCounters``
(``:1807``) and ``device_hbm_bytes`` (``:1077``), which on the card is
the device's ``total_memory``. Tracer spans, Prometheus text and the other
counter sets are not ported.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict

import torch

from keystone_tpu_torch.config import HBM_BUDGET_BYTES


class LatencyHistogram:
    """Fixed log-bucket latency histogram, HdrHistogram-style: buckets grow
    by ``2**(1/sub)`` from ``min_s`` to ``max_s`` (about 4.4% apart at
    sub=16); min, max and sum are exact. Thread-safe."""

    def __init__(self, min_s: float = 1e-6, max_s: float = 1e3, sub: int = 16):
        if not (min_s > 0 and max_s > min_s and sub >= 1):
            raise ValueError(f"bad histogram range {min_s}..{max_s} at sub={sub}")
        self._lo = float(min_s)
        self._sub = int(sub)
        self._nbuckets = int(math.ceil(math.log2(max_s / min_s) * sub)) + 2
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * self._nbuckets
            self._n = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = 0.0
            self._nonpositive = 0

    def _index(self, seconds: float) -> int:
        if seconds <= self._lo:
            return 0
        i = int(math.log2(seconds / self._lo) * self._sub) + 1
        return min(i, self._nbuckets - 1)

    def _value(self, index: int) -> float:
        """Representative (geometric-midpoint) value of a bucket."""
        if index <= 0:
            return self._lo
        return self._lo * 2.0 ** ((index - 0.5) / self._sub)

    def record(self, seconds: float) -> None:
        # Non-positive samples are clamped to the lowest bucket and counted
        # apart, so log-bucket math never sees them.
        nonpos = seconds <= 0.0
        if nonpos:
            seconds = self._lo
        i = self._index(seconds)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += seconds
            if nonpos:
                self._nonpositive += 1
            self._min = min(self._min, seconds)
            self._max = max(self._max, seconds)

    def _percentile_locked(self, p: float) -> float:
        """Nearest-rank percentile (caller holds the lock, _n > 0)."""
        target = max(1, math.ceil(self._n * p / 100.0))
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= target:
                return min(max(self._value(i), self._min), self._max)
        return self._max

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            if self._n == 0:
                return {"count": 0}
            to_ms = lambda s: round(s * 1e3, 4)  # noqa: E731
            snap = {
                "count": self._n,
                "mean_ms": to_ms(self._sum / self._n),
                "min_ms": to_ms(self._min),
                "p50_ms": to_ms(self._percentile_locked(50)),
                "p95_ms": to_ms(self._percentile_locked(95)),
                "p99_ms": to_ms(self._percentile_locked(99)),
                "max_ms": to_ms(self._max),
            }
            if self._nonpositive:
                snap["dropped_nonpositive"] = self._nonpositive
            return snap


class Gauge:
    """A point-in-time value with a high-water mark. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._max = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._max = max(self._max, value)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value, "max": self._max}


class CounterSet:
    """Thread-safe string-keyed monotonic counters, created on first
    ``bump``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counts.items()))


class MetricsRegistry:
    """The process-wide metrics surface: every part registers here, and one
    ``snapshot()`` covers them all. Per-instance serving metrics are named
    ``base[instance]``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parts: Dict[str, Any] = {}

    def register(self, name: str, part: Any) -> Any:
        with self._lock:
            existing = self._parts.get(name)
            if existing is not None and existing is not part:
                raise ValueError(f"metric {name!r} already registered")
            self._parts[name] = part
        return part

    def _get_or_create(self, name: str, factory: Callable[[], Any], cls: type) -> Any:
        with self._lock:
            part = self._parts.get(name)
            if part is None:
                part = self._parts[name] = factory()
        if not isinstance(part, cls):
            raise TypeError(f"metric {name!r} is a {type(part).__name__}")
        return part

    def histogram(self, name: str, **kwargs) -> LatencyHistogram:
        return self._get_or_create(name, lambda: LatencyHistogram(**kwargs), LatencyHistogram)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def counters(self, name: str) -> CounterSet:
        return self._get_or_create(name, CounterSet, CounterSet)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            parts = dict(self._parts)
        return {name: part.snapshot() for name, part in sorted(parts.items())}


metrics_registry = MetricsRegistry()


class ServingCounters:
    """Process-wide serving counts: bucket executables built (CUDA graph
    captures on the card), calls and rows per bucket, padding rows.
    Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.compiles = 0
            self.calls = 0
            self.rows_in = 0
            self.rows_padded = 0
            self.bucket_hits: Dict[int, int] = {}
            self.compiles_by_bucket: Dict[int, int] = {}

    def record_compile(self, bucket: int) -> None:
        with self._lock:
            self.compiles += 1
            self.compiles_by_bucket[bucket] = self.compiles_by_bucket.get(bucket, 0) + 1

    def record_call(self, bucket: int, rows: int) -> None:
        with self._lock:
            self.calls += 1
            self.rows_in += rows
            self.rows_padded += bucket - rows
            self.bucket_hits[bucket] = self.bucket_hits.get(bucket, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "compiles": self.compiles,
                "calls": self.calls,
                "rows_in": self.rows_in,
                "rows_padded": self.rows_padded,
                "pad_overhead": self.rows_padded / self.rows_in if self.rows_in else 0.0,
                "bucket_hits": dict(sorted(self.bucket_hits.items())),
                "compiles_by_bucket": dict(sorted(self.compiles_by_bucket.items())),
            }


serving_counters = metrics_registry.register("serving", ServingCounters())


class ReliabilityCounters(CounterSet):
    """Process-wide failure and recovery events. Keys the port bumps:
    ``faults_injected_<site>``, ``requests_rejected``, ``deadline_expired``,
    ``worker_restarts``, ``futures_failed_on_close``,
    ``futures_failed_on_worker_death``, ``replica_deaths``,
    ``replica_revivals``, ``serve_groups_redispatched``."""


reliability_counters = metrics_registry.register("reliability", ReliabilityCounters())


class ServePlanCounters(CounterSet):
    """Process-wide serve-planner decisions: ``ladders_planned``,
    ``ladders_pinned``, ``buckets_trimmed``, ``top_bucket_capped``,
    ``plans_unpriced``, ``plans_over_budget``."""


serve_plan_counters = metrics_registry.register("serve_plan", ServePlanCounters())


class IngestCounters(CounterSet):
    """Process-wide JPEG decode batches by route (``loaders/imagenet.py``):
    ``native_batches``, ``pil_batches``, and ``pil_fallback_batches``, the
    batches ``auto`` handed to PIL after the native pool failed on one of
    their images."""


ingest_counters = metrics_registry.register("ingest", IngestCounters())


def device_hbm_bytes(device=None) -> int:
    """Memory of a CUDA device (``total_memory``; device 0 when ``device``
    is None and a card is present), else ``HBM_BUDGET_BYTES`` (the CPU
    reports none)."""
    if device is not None:
        device = torch.device(device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    if device is not None and device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(HBM_BUDGET_BYTES)
