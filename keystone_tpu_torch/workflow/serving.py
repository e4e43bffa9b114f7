"""Shape-stable serving: a bucketed engine over a replica pool, one CUDA
graph per bucket on the card, and a micro-batcher in front of it.

Counterpart of ``keystone_tpu/workflow/serving.py``. Three layers, from
the outside in:

- ``PipelineService`` (reference ``:1299-2553``) — a micro-batcher:
  concurrent ``submit()`` calls coalesce into one bucketed call of up to
  ``max_rows`` rows, or what arrived within ``max_delay_ms``, dispatched
  to the least-outstanding replica (round-robin on ties) without waiting
  for the card; one completion thread per replica slices the results back
  and resolves the futures, and an in-flight window bounds how far the
  dispatcher runs ahead. It rejects at ``max_pending`` queued requests
  (``QueueFullError``), fails requests past their deadline before they
  cost a device call (``DeadlineExceeded``), restarts a dead dispatcher
  (``WorkerDiedError`` for the requests it held), re-dispatches a dead
  replica's in-flight groups to the survivors (reviving a fully dead
  pool), and ``close()`` fails every unresolved future with
  ``ServiceClosed``. With one replica and window 1 it runs the serial
  flush loop.
- ``CompiledPipeline`` (reference ``:118-1297``) — the engine: batches are
  rounded up a bucket ladder and padded with copies of their last real
  row, run, and sliced back; a batch over the top bucket is cut into
  top-bucket chunks that shard across the replica pool. ``warmup()`` plans
  the ladder against device memory (``rules.plan_serve_ladder``), then
  builds every bucket on every replica before traffic. ``call_async()``
  returns a handle whose ``wait()`` gives the numpy result; ``qualify()``
  is the precision ladder's quality gate.
- The bucket executable. On a CUDA replica it is one CUDA graph per
  (replica, bucket), the counterpart of the reference's AOT-compiled
  executable (``jit(...).lower(spec).compile()``): the chain is first run
  eagerly on the replica's own stream (building the kernels, choosing
  cuDNN's algorithms, setting the Fisher-vector kernel's shared-memory
  attribute), then captured under ``torch.inference_mode()`` on that
  stream, with a static input and output on the card and a ring of
  ``inflight`` pinned host slots for each. A launch writes the rows of
  its requests straight into a pinned slot at their offsets and pads it,
  copies it into the static input, replays the graph and copies the
  static output into the slot's pinned output, all on the replica's
  stream, and records the slot's event; completion waits on that event
  and slices. A batch already on the card (the streamed scorer's
  features) skips the host: it is copied device to device into the
  static input once the caller's stream has made it. The output copy is
  queued before any later replay can overwrite the static output, and a
  slot is refilled only after its event: if its result was not collected
  yet, it is copied out first. A capture that fails raises: the engine
  never serves eagerly on the card. On a CPU replica the bucket runs the
  eager chain, the rule the kernel wrappers follow.

Precisions (``SERVE_PRECISIONS``, ``config.serve_precision``):

- ``f32`` runs the chain itself: the same operators as an eager call, so
  a graphed bucket gives the eager chain's bits on the same padded input;
- ``f32h`` runs it with TF32 for cuBLAS's float32 products (the head's
  gemms, PCA) while capturing — the counterpart of the reference's matmul
  precision ``high``, and on the CPU the same bits as ``f32``. SIFT's
  convolutions stay float32 in every mode (``ops/sift.py`` turns cuDNN's
  TF32 off around them, as the reference asks ``HIGHEST`` there), and the
  Fisher-vector kernel stays 3xTF32;
- ``bf16`` casts the request batch to bfloat16 at the chain's entry and
  casts a bfloat16 output back. Each stage then computes in the dtype its
  inputs promote to, as jnp's promotion decides in the reference:
  grayscale and LCS in bfloat16, SIFT from its float32 cast of the gray
  image, PCA (bfloat16 minus a float32 mean) and everything after it in
  float32.

Padding is sound only for stages whose output row i depends on input row
i alone (``row_independent``); the engine refuses others with
``RowDependenceError``. Not ported: the flight recorder, tracer spans, the
stall watchdog, the deadline-storm trigger, the capacity model,
``retire_replica``/``unretire_replicas`` and the in-graph
``bucketed_call``.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

import keystone_tpu_torch.ops.fisher_vector as fvo
from keystone_tpu_torch.config import (
    SERVE_PRECISIONS,
    config,
    pow2_ladder,
    resolve_device,
    resolved_serve_buckets,
)
from keystone_tpu_torch.evaluation.binary import BinaryClassifierEvaluator
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.linalg.row_matrix import tf32_matmuls
from keystone_tpu_torch.loaders.stream import PREFETCH_DEPTH, prefetched
from keystone_tpu_torch.utils.metrics import (
    LatencyHistogram,
    device_hbm_bytes,
    metrics_registry,
    reliability_counters,
    serve_plan_counters,
    serving_counters,
)
from keystone_tpu_torch.utils.reliability import (
    DeadlineExceeded,
    QueueFullError,
    ServiceClosed,
    WorkerDiedError,
    active_plan,
)
from keystone_tpu_torch.workflow.pipeline import FusedTransformer, GatherTransformer, Pipeline
from keystone_tpu_torch.workflow.rules import (
    SERVE_LADDER_BUDGET_FRAC,
    plan_serve_ladder,
    record_decision,
)

__all__ = [
    "SERVE_PRECISIONS", "PRECISION_QUALITY_TOLERANCES", "CompiledPipeline", "PipelineService",
    "PrecisionQualityError", "RowDependenceError", "bucket_for", "check_precision_quality",
    "check_row_independent", "ladder_is_pinned", "pow2_ladder", "precision_quality_delta",
    "resolve_ladder", "resolve_serve_devices",
]

logger = logging.getLogger("keystone_tpu_torch")

# Process-wide latency of every engine-served batch and of every service
# request, from the call (or submit) to its result.
request_latency = metrics_registry.histogram("serve.request_latency")
e2e_latency = metrics_registry.histogram("serve.e2e_latency")

_engine_seq = itertools.count()
_service_seq = itertools.count()


class RowDependenceError(TypeError):
    """Bucketed (padded) serving was asked of a chain whose output rows
    depend on other rows: padding would change the real outputs."""


class PrecisionQualityError(ValueError):
    """A reduced serving precision failed its quality gate: the evaluation
    metric fell further below the f32 oracle's than the tolerance allows.
    The message names the metric and the delta."""


#: How far below the f32 oracle a reduced precision may score before the
#: gate refuses; ``qualify(tolerance=)`` overrides.
PRECISION_QUALITY_TOLERANCES = {
    "multiclass": 0.01,  # top-1 accuracy (or agreement with the oracle) drop
    "binary": 0.01,  # accuracy drop
    "map": 0.01,  # mean-average-precision drop
}


def precision_quality_delta(oracle_out, out, y=None, metric="multiclass"):
    """``(metric_name, delta, oracle_score, score)`` of reduced-precision
    outputs against the f32 oracle's; a positive delta scores worse.

    - ``multiclass``: top-1 accuracy against ``y``, or without labels the
      argmax agreement with the oracle;
    - ``binary``: accuracy of ``scores > 0`` (column 0 when 2-D) against
      ``y``, or the oracle's own thresholded predictions;
    - ``map``: VOC mean average precision over multilabel ``y`` (required).
    """
    o = np.asarray(oracle_out)
    p = np.asarray(out)
    if o.shape != p.shape:
        raise ValueError(f"oracle/serving output shapes differ: {o.shape} vs {p.shape}")
    if metric == "multiclass":
        op_, pp = o.argmax(axis=-1), p.argmax(axis=-1)
        ev = MulticlassClassifierEvaluator(int(o.shape[-1]))
        if y is not None:
            ref = ev.evaluate(op_, y).total_accuracy
            got = ev.evaluate(pp, y).total_accuracy
        else:
            ref = 1.0
            got = ev.evaluate(pp, op_).total_accuracy
        return "multiclass_accuracy", ref - got, ref, got
    if metric == "binary":
        os_ = o[:, 0] if o.ndim == 2 else o
        ps = p[:, 0] if p.ndim == 2 else p
        ref_pred, got_pred = os_ > 0, ps > 0
        if y is not None:
            ref = BinaryClassifierEvaluator.evaluate(ref_pred, y).accuracy
            got = BinaryClassifierEvaluator.evaluate(got_pred, y).accuracy
        else:
            ref = 1.0
            got = BinaryClassifierEvaluator.evaluate(got_pred, ref_pred).accuracy
        return "binary_accuracy", ref - got, ref, got
    if metric == "map":
        if y is None:
            raise ValueError("metric='map' needs multilabel ground truth y")
        ev = MeanAveragePrecisionEvaluator(int(o.shape[-1]))
        ref = ev.evaluate(o, y)["map"]
        got = ev.evaluate(p, y)["map"]
        return "map", ref - got, ref, got
    raise ValueError(
        f"unknown quality metric {metric!r}; expected one of {tuple(PRECISION_QUALITY_TOLERANCES)}"
    )


def check_precision_quality(
    oracle_out, out, y=None, metric="multiclass",
    tolerance: Optional[float] = None, precision: str = "?",
) -> dict:
    """The precision ladder's gate: raises ``PrecisionQualityError``
    (naming the metric and the delta) when the drop against the f32 oracle
    exceeds ``tolerance`` (``PRECISION_QUALITY_TOLERANCES[metric]`` by
    default); returns the report on a pass."""
    if tolerance is None:
        if metric not in PRECISION_QUALITY_TOLERANCES:
            raise ValueError(
                f"unknown quality metric {metric!r}; expected one of "
                f"{tuple(PRECISION_QUALITY_TOLERANCES)}"
            )
        tolerance = PRECISION_QUALITY_TOLERANCES[metric]
    name, delta, ref, got = precision_quality_delta(oracle_out, out, y=y, metric=metric)
    report = {
        "metric": name,
        "precision": precision,
        "oracle_score": round(float(ref), 6),
        "score": round(float(got), 6),
        "quality_delta": round(float(delta), 6),
        "tolerance": float(tolerance),
        "within_tolerance": bool(delta <= tolerance),
    }
    if delta > tolerance:
        raise PrecisionQualityError(
            f"serve_precision={precision} refused: {name} dropped {delta:.6f} below the f32 "
            f"oracle ({ref:.6f} -> {got:.6f}), beyond the declared tolerance {tolerance:g}. "
            "Serve this pipeline at f32, or raise the tolerance explicitly if the trade is "
            "intended."
        )
    return report


# ---------------------------------------------------------------------------
# Ladder and pool helpers
# ---------------------------------------------------------------------------


def ladder_is_pinned(buckets: Optional[Sequence[int]] = None) -> bool:
    """Whether the ladder came from a source the memory planner leaves
    alone: a ``buckets=`` argument, an exported ``KEYSTONE_SERVE_BUCKETS``
    or ``config.serve_buckets``. Only the power-of-two default is planned."""
    return buckets is not None or resolved_serve_buckets() is not None or bool(config.serve_buckets)


def resolve_ladder(buckets: Optional[Sequence[int]] = None, max_batch: Optional[int] = None) -> Tuple[int, ...]:
    """The ladder to serve with: ``buckets`` > an exported
    ``KEYSTONE_SERVE_BUCKETS`` > ``config.serve_buckets`` > powers of two
    up to ``max_batch`` (``config.serve_max_batch`` when None). Sorted,
    deduplicated and positive; with ``max_batch`` an explicit ladder is cut
    at it and ends with it."""
    if buckets is None:
        env = resolved_serve_buckets()
        if env is not None:
            buckets = env
    if buckets is None and config.serve_buckets:
        buckets = config.serve_buckets
    if buckets is None:
        ladder = pow2_ladder(config.serve_max_batch if max_batch is None else max_batch)
    else:
        ladder = tuple(sorted({int(b) for b in buckets}))
        if max_batch is not None:
            ladder = tuple(b for b in ladder if b <= max_batch)
            if not ladder or ladder[-1] < max_batch:
                ladder = ladder + (int(max_batch),)
    if not ladder or ladder[0] <= 0:
        raise ValueError(f"bucket ladder must be positive ints, got {ladder}")
    return ladder


def bucket_for(n: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds the ladder (the caller
    chunks)."""
    for b in ladder:
        if n <= b:
            return b
    return None


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current device's when unnamed)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_serve_devices(devices=None) -> tuple:
    """The replica pool: an explicit sequence of devices (``torch.device``
    or names; the CPU may repeat, for a pool of several CPU replicas), an
    int count of CUDA devices (0 = every local one), or None for
    ``config.serve_devices``. Counting CUDA devices without CUDA raises,
    as ``resolve_device`` does."""
    if devices is None:
        devices = config.serve_devices
    if isinstance(devices, (str, torch.device)):
        raise TypeError(f"devices takes a sequence, an int or None, got {devices!r}; "
                        f"pass [{devices!r}] for a one-replica pool")
    if isinstance(devices, int):
        resolve_device("cuda")
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if devices == 0:
            return tuple(local)
        if devices < 1:
            raise ValueError(f"devices must be >= 1 (or 0 = all local), got {devices}")
        if devices > len(local):
            raise ValueError(f"devices={devices} exceeds the {len(local)} local devices")
        return tuple(local[:devices])
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError("devices sequence must not be empty")
    return devs


def _least_outstanding(n, cursor, outstanding, eligible=None):
    """The dispatch policy of the engine and the service: the index with
    the least ``outstanding(i)`` among ``eligible(i)`` replicas, scanned
    round-robin from ``cursor`` so that ties rotate. None when nothing is
    eligible."""
    best = None
    for k in range(n):
        i = (cursor + k) % n
        if eligible is not None and not eligible(i):
            continue
        if best is None or outstanding(i) < outstanding(best):
            best = i
    return best


def _row_coupled_stages(module: nn.Module) -> list:
    """Names of the stages, through fused chains and gathers, whose output
    rows depend on other rows."""
    if isinstance(module, FusedTransformer):
        return [bad for s in module.stages for bad in _row_coupled_stages(s)]
    if isinstance(module, GatherTransformer):
        return [bad for s in module.branches for bad in _row_coupled_stages(s)]
    return [] if getattr(module, "row_independent", True) else [type(module).__name__]


def check_row_independent(transformer) -> None:
    """Raises RowDependenceError naming every row-coupled stage."""
    bad = _row_coupled_stages(transformer)
    if bad:
        raise RowDependenceError(
            f"cannot pad batches through {', '.join(bad)}: the stage's batch output depends "
            "on other rows (row_independent=False), so bucketed serving would change real "
            "outputs. Keep the row-coupled stage off the bucketed path."
        )


def _host(X, dtype=None) -> np.ndarray:
    """A request batch as a host array: a tensor comes back from its device."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return np.asarray(X, dtype=dtype)


def _chunked(parts: list, size: int) -> list:
    """Splits a list of row blocks into chunks of at most ``size`` rows,
    each a list of views of the blocks, in order."""
    chunks, cur, room = [], [], size
    for p in parts:
        lo, n = 0, p.shape[0]
        while lo < n:
            take = min(room, n - lo)
            cur.append(p[lo : lo + take])
            lo += take
            room -= take
            if room == 0:
                chunks.append(cur)
                cur, room = [], size
    if cur:
        chunks.append(cur)
    return chunks


def _serve_fn(transformer: nn.Module, precision: str):
    """The function every bucket runs, at ``precision`` (module docstring)."""
    if precision == "f32":
        return transformer

    if precision == "f32h":
        def serve_f32h(X):
            with tf32_matmuls():
                return transformer(X)
        return serve_f32h

    def serve_bf16(X):
        out = transformer(X.to(torch.bfloat16))
        return out.to(X.dtype) if out.dtype == torch.bfloat16 else out
    return serve_bf16


# ---------------------------------------------------------------------------
# Bucket executables
# ---------------------------------------------------------------------------


class _Launched:
    """A chunk in flight: its replica and bucket executable, its real
    rows, and where its result is — ``host`` once collected, else the
    pinned slot (and its event) it will be copied from."""

    __slots__ = ("replica", "bucket", "m", "slot", "event", "host")

    def __init__(self, bucket, m, slot=None, event=None, host=None):
        self.replica = None
        self.bucket = bucket
        self.m = m
        self.slot = slot
        self.event = event
        self.host = host


class _EagerBucket:
    """A bucket on a CPU replica: the padded batch through the eager chain."""

    graph_pool_bytes = 0

    def __init__(self, fn, b: int):
        self.fn = fn
        self.b = b

    def launch(self, parts: list, m: int) -> _Launched:
        rows = [p.cpu() if isinstance(p, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(p))
                for p in parts]
        if m < self.b:
            rows.append(rows[-1][-1:].expand(self.b - m, *rows[-1].shape[1:]))
        with torch.inference_mode():
            out = self.fn(rows[0] if len(rows) == 1 else torch.cat(rows))
        return _Launched(self, m, host=out[:m].numpy())

    def complete(self, lc: _Launched) -> np.ndarray:
        return lc.host

    def release(self, lc: _Launched) -> None:
        pass


class _GraphBucket:
    """A bucket on a CUDA replica: one captured CUDA graph with a static
    input and output on the card and ``slots`` pinned host slots for each
    (module docstring)."""

    def __init__(self, fn, b: int, feature_shape, dtype: torch.dtype, device: torch.device,
                 stream: torch.cuda.Stream, slots: int):
        self.b = b
        self.device = device
        self.stream = stream
        self.lock = threading.Lock()
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # Allocated on the replica's stream, which is the only one
                # that reads it.
                self.static_in = torch.zeros((b, *feature_shape), dtype=dtype, device=device)
                with torch.inference_mode():
                    fn(self.static_in)  # eager warm-up, before capture
            stream.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            captured = fvo.captured_launches()
            self.graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(
                self.graph, stream=stream, capture_error_mode="thread_local"
            ):
                self.static_out = fn(self.static_in)
            # Memory the capture reserved for the graph's private pool.
            self.graph_pool_bytes = torch.cuda.memory_reserved(device) - reserved
        if not isinstance(self.static_out, torch.Tensor):
            raise TypeError(f"a served chain returns one tensor, got {type(self.static_out).__name__}")
        # Fisher-vector launches recorded into the graph, counted per replay.
        self.fv_launches = fvo.captured_launches() - captured
        self.in_slots = [
            torch.empty((b, *feature_shape), dtype=dtype, pin_memory=True) for _ in range(slots)
        ]
        self.out_slots = [
            torch.empty(self.static_out.shape, dtype=self.static_out.dtype, pin_memory=True)
            for _ in range(slots)
        ]
        self.events = [torch.cuda.Event() for _ in range(slots)]
        self.owners = [None] * slots
        self.cursor = 0

    def _collect_locked(self, lc: _Launched) -> None:
        """Copies a finished chunk's rows out of its pinned slot and frees
        the slot (caller holds the lock, and the slot's event completed)."""
        lc.host = self.out_slots[lc.slot][: lc.m].numpy().copy()
        self.owners[lc.slot] = None

    def launch(self, parts: list, m: int) -> _Launched:
        """Launches ``m`` rows, given as row blocks: host arrays go into a
        pinned slot at their offsets and are padded there, then copied to
        the card; tensors on a card are copied device to device into the
        static input, after the work that made them on the caller's
        stream."""
        on_card = isinstance(parts[0], torch.Tensor)
        # The caller's stream, read before the replica's is made current.
        caller = torch.cuda.current_stream(parts[0].device) if on_card else None
        with self.lock:
            s = self.cursor
            self.cursor = (s + 1) % len(self.in_slots)
            # The slot's last copies must be done before it is refilled; a
            # result not collected yet is copied out first.
            self.events[s].synchronize()
            if self.owners[s] is not None:
                self._collect_locked(self.owners[s])
            if not on_card:
                inp = self.in_slots[s]
                off = 0
                for p in parts:
                    inp[off : off + p.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(p)))
                    off += p.shape[0]
                if m < self.b:
                    inp[m:].copy_(inp[m - 1 : m].expand_as(inp[m:]))
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                if on_card:
                    self.stream.wait_stream(caller)
                    off = 0
                    for p in parts:
                        self.static_in[off : off + p.shape[0]].copy_(p, non_blocking=True)
                        p.record_stream(self.stream)
                        off += p.shape[0]
                    if m < self.b:
                        self.static_in[m:].copy_(self.static_in[m - 1 : m].expand_as(self.static_in[m:]))
                else:
                    self.static_in.copy_(self.in_slots[s], non_blocking=True)
                self.graph.replay()
                # Queued before any later replay can overwrite static_out.
                self.out_slots[s].copy_(self.static_out, non_blocking=True)
                self.events[s].record(self.stream)
            fvo.count_replay(self.fv_launches)
            lc = _Launched(self, m, slot=s, event=self.events[s])
            self.owners[s] = lc
        return lc

    def complete(self, lc: _Launched) -> np.ndarray:
        with self.lock:
            done = lc.host is not None
        if not done:
            # Outside the lock, so that other launches proceed; a launch
            # that reuses the slot meanwhile collects the result first.
            lc.event.synchronize()
            with self.lock:
                if lc.host is None:
                    self._collect_locked(lc)
        return lc.host

    def release(self, lc: _Launched) -> None:
        """Drops a chunk's claim on its slot without collecting it; the
        slot's event still guards its next refill."""
        with self.lock:
            if lc.slot is not None and self.owners[lc.slot] is lc:
                self.owners[lc.slot] = None


class _Replica:
    """One device of the pool: its bucket executables, its stream on a
    card, and launch accounting (outstanding = launched chunks not yet
    collected; dispatches = the balance evidence)."""

    __slots__ = ("index", "device", "executables", "outstanding", "dispatches", "stream")

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.executables: dict = {}
        self.outstanding = 0
        self.dispatches = 0
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @property
    def key(self) -> str:
        return f"r{self.index}:{self.device}"


class _AsyncResult:
    """A batch being served: chunks launch up to ``window`` ahead and
    ``wait()`` collects them in source order. With one replica and window
    1 this is the serial launch-then-collect loop."""

    __slots__ = ("_cp", "_chunks", "_pin", "_window", "_next", "_launched", "_outs",
                 "_result", "_done", "_exc", "_t0")

    def __init__(self, cp: "CompiledPipeline", parts: list, pin: Optional[int], window: int,
                 t0: float):
        self._cp = cp
        self._pin = pin
        self._t0 = t0
        self._window = max(1, int(window))
        self._chunks = _chunked(parts, cp.max_batch)
        self._next = 0
        self._launched: deque = deque()
        self._outs: list = []
        self._result = None
        self._done = False
        self._exc: Optional[BaseException] = None
        self._fill()

    def _fill(self) -> None:
        while self._next < len(self._chunks) and len(self._launched) < self._window:
            self._launched.append(self._cp._launch_chunk(self._chunks[self._next], self._pin))
            self._chunks[self._next] = None
            self._next += 1

    def wait(self) -> np.ndarray:
        """The numpy result, sliced to the real rows. Repeat calls return
        the same result, or raise the same failure."""
        if self._done:
            if self._exc is not None:
                raise self._exc
            return self._result
        try:
            while self._launched:
                self._outs.append(self._cp._complete_chunk(self._launched.popleft()))
                self._fill()
        except BaseException as e:
            # The other launched chunks must give back their replica slots.
            self.abandon()
            self._exc = e
            raise
        self._result = self._outs[0] if len(self._outs) == 1 else np.concatenate(self._outs, axis=0)
        self._outs = []
        self._chunks = None
        self._done = True
        request_latency.record(time.perf_counter() - self._t0)
        return self._result

    def abandon(self) -> None:
        """Discards the result without collecting it, releasing the replica
        slots of launched chunks (the device work is pure and is dropped).
        Only the handle's owner may call it."""
        if self._done:
            return
        while self._launched:
            self._cp._release_slot(self._launched.popleft())
        self._outs = []
        self._chunks = None
        self._result = None
        self._done = True

    def __del__(self):
        try:
            self.abandon()
        except Exception:  # a finalizer at interpreter teardown: anything may be gone
            pass


class CompiledPipeline:
    """A pipeline (a ``Pipeline``, fitted and lowered through
    ``serving_chain``, or any row-independent ``nn.Module``) served
    shape-stably on a pool of replicas; see the module docstring.

    ``devices`` is a sequence, an int or None (``resolve_serve_devices``);
    ``buckets``/``max_batch`` give the ladder (``resolve_ladder``);
    ``inflight`` is the per-replica window (``config.serve_inflight``) and
    the number of pinned slots per bucket on a card; ``precision`` one of
    ``SERVE_PRECISIONS`` (``config.serve_precision``). ``serve_fn`` is the
    function every bucket runs at that precision, callable eagerly on a
    padded batch to check a bucket against."""

    def __init__(
        self,
        target,
        buckets: Optional[Sequence[int]] = None,
        max_batch: Optional[int] = None,
        devices=None,
        inflight: Optional[int] = None,
        name: Optional[str] = None,
        precision: Optional[str] = None,
    ):
        if isinstance(target, Pipeline):
            # Fitted, optimized and lowered to the one module every bucket
            # runs (the reference's _serving_transformer).
            target = target.serving_chain()
        if not isinstance(target, nn.Module):
            raise TypeError(f"cannot serve a {type(target).__name__}")
        self.transformer = target.eval()
        check_row_independent(self.transformer)
        self.ladder = resolve_ladder(buckets, max_batch)
        self.max_batch = self.ladder[-1]
        self._ladder_pinned = ladder_is_pinned(buckets)
        self._base_ladder = self.ladder
        self._planned: Optional[dict] = None
        self.precision = config.serve_precision if precision is None else str(precision)
        if self.precision not in SERVE_PRECISIONS:
            raise ValueError(f"serve precision must be one of {SERVE_PRECISIONS}, got {self.precision!r}")
        self.serve_fn = _serve_fn(self.transformer, self.precision)
        self.devices = resolve_serve_devices(devices)
        self.replicas = [_Replica(i, d) for i, d in enumerate(self.devices)]
        self.inflight = int(config.serve_inflight if inflight is None else inflight)
        if self.inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {self.inflight}")
        self.name = name or f"cp{next(_engine_seq)}"
        self.feature_shape: Optional[Tuple[int, ...]] = None
        self._dtype: Optional[np.dtype] = None
        self.compile_count = 0  # bucket executables built: captures on a card
        self.compiles_by_bucket: dict = {}
        self.calls_by_bucket: Counter = Counter()  # bucket runs, warm-up's included
        self.warmup_seconds: Optional[float] = None
        self._lock = threading.Lock()
        self._rr = 0
        self._dispatch_counters = metrics_registry.counters(f"serve.dispatch[{self.name}]")
        self._out_gauges = [
            metrics_registry.gauge(f"serve.outstanding[{self.name}:{r.key}]") for r in self.replicas
        ]

    @property
    def dtype(self) -> Optional[np.dtype]:
        return self._dtype

    @property
    def base_ladder(self) -> Tuple[int, ...]:
        """The candidate rungs before planning; every re-plan picks from them."""
        return tuple(self._base_ladder)

    # -- warmup ------------------------------------------------------------

    def warmup(self, example: Union[Tuple[int, ...], np.ndarray], dtype=None,
               replica: Optional[int] = None) -> "CompiledPipeline":
        """Plans the ladder, then builds (and runs once) every bucket on
        every replica — or on replica ``replica`` only — before traffic.
        ``example`` is the per-row feature shape or a sample batch. Again
        at the same signature, it builds only what is missing."""
        if isinstance(example, tuple) and all(isinstance(d, int) for d in example):
            feature_shape = example
            dt = np.dtype(dtype or "float32")
        else:
            arr = _host(example)
            if arr.ndim < 1:
                raise ValueError("warmup example must be a feature-shape tuple or a sample batch "
                                 "with a leading row axis")
            feature_shape = arr.shape[1:]
            dt = np.dtype(dtype) if dtype is not None else arr.dtype
        if dt == np.float64:
            dt = np.dtype(np.float32)  # the chain computes in float32
        with self._lock:
            if self.feature_shape is not None and (self.feature_shape, self._dtype) != (feature_shape, dt):
                # A new signature: the built buckets and the plan are stale.
                for r in self.replicas:
                    r.executables.clear()
                self._planned = None
                self.ladder = self._base_ladder
                self.max_batch = self.ladder[-1]
            self.feature_shape, self._dtype = tuple(feature_shape), dt
            self._plan_ladder_locked()
            t0 = time.perf_counter()
            for r in self.replicas if replica is None else [self.replicas[replica]]:
                for b in self.ladder:
                    if b not in r.executables:
                        self._compile_bucket_locked(r, b)
            elapsed = time.perf_counter() - t0
            self.warmup_seconds = elapsed if replica is None else (self.warmup_seconds or 0.0) + elapsed
        return self

    def _torch_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.empty(0, self._dtype)).dtype

    def _compile_bucket_locked(self, replica: _Replica, b: int):
        """Builds one bucket's executable on one replica and runs it once
        on a padded batch of zeros (caller holds the lock)."""
        t0 = time.perf_counter()
        if replica.device.type == "cuda":
            ex = _GraphBucket(self.serve_fn, b, self.feature_shape, self._torch_dtype(), replica.device,
                              replica.stream, self.inflight)
        else:
            ex = _EagerBucket(self.serve_fn, b)
        ex.complete(ex.launch([np.zeros((1, *self.feature_shape), self._dtype)], 1))
        ex.build_seconds = time.perf_counter() - t0
        replica.executables[b] = ex
        self.calls_by_bucket[b] += 1
        self.compile_count += 1
        self.compiles_by_bucket[b] = self.compiles_by_bucket.get(b, 0) + 1
        serving_counters.record_compile(b)
        return ex

    # -- memory planning ---------------------------------------------------

    def _plan_ladder_locked(self) -> None:
        """Sizes an unpinned ladder against the first replica's memory
        (``rules.plan_serve_ladder``), once per signature; a pinned ladder
        and a disabled planner are recorded and left as they are."""
        if self._planned is not None:
            return
        if self._ladder_pinned:
            serve_plan_counters.bump("ladders_pinned")
            self._planned = {"enabled": False, "reason": "ladder pinned"}
            return
        if not config.plan_resources:
            self._planned = {"enabled": False, "reason": "config.plan_resources off"}
            return
        bpr, provenance = self._bytes_per_row_locked()
        if not bpr:
            serve_plan_counters.bump("plans_unpriced")
            record_decision(rule="PlanServeLadder", node=self.name, action="serve_buckets=unplanned",
                            provenance=provenance, reason="no bytes per row could be priced")
            self._planned = {"enabled": False, "reason": "unpriced"}
            return
        kept, _trimmed, info = plan_serve_ladder(
            self._base_ladder, bpr, len(self.replicas),
            budget_bytes=device_hbm_bytes(self.devices[0]) // SERVE_LADDER_BUDGET_FRAC,
            provenance=provenance, node=self.name,
        )
        self.ladder = kept
        self.max_batch = kept[-1]
        self._planned = dict(info, enabled=True)

    def _bytes_per_row_locked(self):
        """``(bytes per row, provenance)`` of one bucket call, from one
        eager run of the smallest candidate rung on the first replica: on a
        card its peak allocation above what was allocated before
        (``measured``); on the CPU the input's and output's bytes per row
        (``model``)."""
        b0 = self._base_ladder[0]
        dev = self.devices[0]
        X = torch.zeros((b0, *self.feature_shape), dtype=self._torch_dtype(), device=dev)
        with torch.inference_mode():
            if dev.type != "cuda":
                out = self.serve_fn(X)
                per_row = out[0].numel() * out.element_size() + X[0].numel() * X.element_size()
                return float(per_row), "model"
            stream = self.replicas[0].stream
            with torch.cuda.device(dev):
                stream.wait_stream(torch.cuda.current_stream(dev))
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                with torch.cuda.stream(stream):
                    self.serve_fn(X)
                stream.synchronize()
                peak = torch.cuda.max_memory_allocated(dev) - base
        return (peak + X.numel() * X.element_size()) / b0, "measured"

    def reprice_ladder(self, ladder) -> bool:
        """Re-plans the active ladder from a new candidate rung set, then
        builds any missing bucket on every replica before it returns; built
        buckets are kept. Refuses (False) on a pinned ladder, an unwarmed
        engine or an unchanged set; never touches ``base_ladder``."""
        wanted = tuple(sorted({int(b) for b in ladder}))
        if not wanted or wanted[0] <= 0:
            raise ValueError(f"bucket ladder must be positive ints, got {ladder!r}")
        with self._lock:
            if self._ladder_pinned or self.feature_shape is None or wanted == tuple(self.ladder):
                return False
            kept = wanted
            if config.plan_resources:
                bpr, provenance = self._bytes_per_row_locked()
                if bpr:
                    kept, _trimmed, info = plan_serve_ladder(
                        wanted, bpr, len(self.replicas),
                        budget_bytes=device_hbm_bytes(self.devices[0]) // SERVE_LADDER_BUDGET_FRAC,
                        provenance=provenance, node=self.name,
                    )
                    self._planned = dict(info, enabled=True)
            self.ladder = tuple(kept)
            self.max_batch = self.ladder[-1]
            for r in self.replicas:
                for b in self.ladder:
                    if b not in r.executables:
                        self._compile_bucket_locked(r, b)
        return True

    # -- precision quality gate --------------------------------------------

    def qualify(self, X, y=None, metric: str = "multiclass", tolerance: Optional[float] = None) -> dict:
        """Serves ``X`` through this engine and through an f32 oracle engine
        on the same chain (one bucket, on this engine's first device), and
        holds the two to ``check_precision_quality``. For an f32 engine the
        gate is the identity and passes."""
        X = _host(X)
        if self.precision == "f32":
            out = self(X)
            return check_precision_quality(out, out, y=y, metric=metric, tolerance=tolerance,
                                           precision=self.precision)
        mine = self(X)
        probe_bucket = bucket_for(X.shape[0], self.ladder) or self.max_batch
        oracle = CompiledPipeline(
            self.transformer, buckets=[probe_bucket], devices=self.devices[:1], precision="f32",
            name=f"{self.name}-f32-oracle",
        ).warmup(self.feature_shape, dtype=self._dtype)
        return check_precision_quality(oracle(X), mine, y=y, metric=metric, tolerance=tolerance,
                                       precision=self.precision)

    # -- hot path ----------------------------------------------------------

    def _pick_replica_locked(self) -> _Replica:
        n = len(self.replicas)
        idx = _least_outstanding(n, self._rr, lambda i: self.replicas[i].outstanding)
        self._rr = (idx + 1) % n
        return self.replicas[idx]

    def _launch_chunk(self, parts: list, pin: Optional[int] = None) -> _Launched:
        """Launches one chunk of at most ``max_batch`` rows, given as row
        blocks, on a replica (``pin``, or the least-outstanding one) without
        waiting for it."""
        m = sum(p.shape[0] for p in parts)
        b = bucket_for(m, self.ladder)
        with self._lock:
            r = self.replicas[pin] if pin is not None else self._pick_replica_locked()
            ex = r.executables.get(b)
            if ex is None:  # a bucket warmup did not build: built now, counted
                ex = self._compile_bucket_locked(r, b)
            r.outstanding += 1
            r.dispatches += 1
            self.calls_by_bucket[b] += 1
            self._out_gauges[r.index].set(r.outstanding)
        self._dispatch_counters.bump(r.key)
        try:
            lc = ex.launch(parts, m)
        except BaseException:
            self._release_replica(r)
            raise
        lc.replica = r
        serving_counters.record_call(b, m)
        return lc

    def _release_replica(self, r: _Replica) -> None:
        with self._lock:
            r.outstanding -= 1
            self._out_gauges[r.index].set(r.outstanding)

    def _release_slot(self, lc: _Launched) -> None:
        """Releases a launched chunk's replica slot without its result."""
        lc.bucket.release(lc)
        self._release_replica(lc.replica)

    def _complete_chunk(self, lc: _Launched) -> np.ndarray:
        """Waits for a launched chunk, returns its real rows on the host
        and releases its replica slot."""
        try:
            out = lc.bucket.complete(lc)
        except BaseException:
            self._release_slot(lc)
            raise
        self._release_replica(lc.replica)
        return out

    def call_async(self, X, replica: Optional[int] = None, window: Optional[int] = None) -> _AsyncResult:
        """Launches a batch and returns a handle whose ``wait()`` gives the
        numpy output. Chunks over the top bucket shard across the pool, or
        all go to ``replica``; ``window`` bounds the chunks in flight
        (default: ``inflight`` × the replicas in play). A tensor on a card
        stays there: a graphed bucket copies it device to device."""
        on_card = isinstance(X, torch.Tensor) and X.device.type == "cuda"
        if self.feature_shape is None:
            self.warmup(_host(X[:1]) if on_card else _host(X))
        X = X.detach().to(self._torch_dtype()) if on_card else _host(X, self._dtype)
        return self._call_parts([X], replica, window)

    def _call_parts(self, parts: list, replica: Optional[int] = None,
                    window: Optional[int] = None) -> _AsyncResult:
        """``call_async`` of the rows of ``parts`` (row blocks of the warmed
        shape and dtype) in order, without joining them first: a graphed
        bucket copies each block into its pinned slot at its offset."""
        t0 = time.perf_counter()
        for p in parts:
            if tuple(p.shape[1:]) != self.feature_shape:
                raise ValueError(
                    f"request feature shape {tuple(p.shape[1:])} != warmed shape {self.feature_shape}; "
                    "re-warm the pipeline for new traffic"
                )
        if sum(p.shape[0] for p in parts) == 0:
            raise ValueError("cannot serve an empty batch")
        if replica is not None and not 0 <= replica < len(self.replicas):
            raise ValueError(f"replica {replica} out of range for a {len(self.replicas)}-replica pool")
        if window is None:
            window = self.inflight * (1 if replica is not None else len(self.replicas))
        return _AsyncResult(self, parts, replica, window, t0)

    def __call__(self, X) -> np.ndarray:
        """Serves one batch and returns its numpy result."""
        return self.call_async(X).wait()

    def apply_batches(self, batches, prefetch_depth: Optional[int] = None, window: Optional[int] = None):
        """Yields ``(output, labels)`` for each ``(X, labels)`` pair (or
        bare ``X``) of ``batches``, in source order, with up to ``window``
        batches (default ``inflight`` × replicas) in flight across the
        pool; the source runs ``prefetch_depth`` batches ahead on a thread
        (``PREFETCH_DEPTH`` when None; 0 runs it on the caller's)."""
        window = max(1, int(self.inflight * len(self.replicas) if window is None else window))
        pending: deque = deque()
        depth = PREFETCH_DEPTH if prefetch_depth is None else prefetch_depth
        with prefetched(iter(batches), depth) as src:
            for item in src:
                X, y = item if isinstance(item, tuple) and len(item) == 2 else (item, None)
                pending.append((self.call_async(X), y))
                if len(pending) >= window:
                    handle, y0 = pending.popleft()
                    yield handle.wait(), y0
            while pending:
                handle, y0 = pending.popleft()
                yield handle.wait(), y0

    def stats(self) -> dict:
        return {
            "name": self.name,
            "ladder": list(self.ladder),
            "precision": self.precision,
            "plan": dict(self._planned) if self._planned else None,
            "devices": [str(d) for d in self.devices],
            "inflight": self.inflight,
            "compile_count": self.compile_count,
            "compiles_by_bucket": dict(sorted(self.compiles_by_bucket.items())),
            "calls_by_bucket": dict(sorted(self.calls_by_bucket.items())),
            "warmup_seconds": self.warmup_seconds,
            # Seconds to build (warm, capture) and first run each bucket.
            "build_seconds": {
                r.key: {b: ex.build_seconds for b, ex in sorted(r.executables.items())}
                for r in self.replicas
            },
            # Memory each bucket's captured graph reserved, per replica.
            "graph_pool_bytes": {
                r.key: {b: ex.graph_pool_bytes for b, ex in sorted(r.executables.items())}
                for r in self.replicas
            },
            "replica_dispatches": {r.key: r.dispatches for r in self.replicas},
            "replica_outstanding": {r.key: r.outstanding for r in self.replicas},
            "process_request_latency": request_latency.snapshot(),
        }


# ---------------------------------------------------------------------------
# PipelineService — the micro-batcher over the replica pool
# ---------------------------------------------------------------------------


class _Request:
    """One accepted request: payload, whether it was a single datum, its
    future, its deadline (monotonic seconds or None) and its submit time."""

    __slots__ = ("x", "datum", "fut", "deadline", "t_sub")

    def __init__(self, x, datum, fut, deadline, t_sub):
        self.x = x
        self.datum = datum
        self.fut = fut
        self.deadline = deadline
        self.t_sub = t_sub


class _FlightRec:
    """A flush group launched on a replica, awaiting completion."""

    __slots__ = ("live", "handle", "rows")

    def __init__(self, live, handle, rows):
        self.live = live
        self.handle = handle
        self.rows = rows


class PipelineService:
    """Coalesces concurrent requests into bucketed calls of a warmed
    ``CompiledPipeline``, pipelined across its replicas (module docstring).

    ``submit(x)`` returns a ``concurrent.futures.Future`` that resolves to
    the output of one example (feature-shaped ``x``) or of a small batch,
    or fails with ``DeadlineExceeded``, ``WorkerDiedError`` or
    ``ServiceClosed``; ``QueueFullError`` is raised by ``submit`` itself.
    No future is left unresolved."""

    #: Longest wait for each worker thread at close().
    _CLOSE_JOIN_S = 30.0

    def __init__(
        self,
        compiled: CompiledPipeline,
        max_delay_ms: float = 2.0,
        max_rows: Optional[int] = None,
        max_pending: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        inflight: Optional[int] = None,
        name: Optional[str] = None,
    ):
        if compiled.feature_shape is None:
            raise RuntimeError("PipelineService requires a warmed CompiledPipeline — call warmup() "
                               "with the traffic's feature shape first")
        self.compiled = compiled
        self.max_rows = int(compiled.max_batch if max_rows is None else max_rows)
        if self.max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {self.max_rows}")
        self.max_delay = max_delay_ms / 1e3
        self.max_pending = int(config.serve_max_pending if max_pending is None else max_pending)
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        self.default_deadline_s = (config.serve_deadline_ms if deadline_ms is None else deadline_ms) / 1e3
        self.inflight_limit = int(config.serve_inflight if inflight is None else inflight)
        if self.inflight_limit < 1:
            raise ValueError(f"inflight must be >= 1, got {self.inflight_limit}")
        self.name = name or f"svc{next(_service_seq)}"
        self._plan = active_plan()
        self._e2e = LatencyHistogram()
        self._depth_max = 0
        self._queue_gauge = metrics_registry.gauge(f"serve.queue_depth[{self.name}]")
        self._inflight_gauge = metrics_registry.gauge(f"serve.inflight[{self.name}]")
        # Outcomes: ok / expired / rejected / error / closed.
        self._outcomes = metrics_registry.counters(f"serve.requests[{self.name}]")
        self._pending: deque = deque()
        self._inflight: list = []  # requests popped but not yet launched
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self.requests = 0
        self.batches_run = 0
        self.rows_served = 0
        self.rejected = 0
        self.expired = 0
        self.worker_restarts = 0
        self.replica_deaths = 0
        self.replica_revivals = 0
        self._n_replicas = len(compiled.replicas)
        self._pipelined = self._n_replicas > 1 or self.inflight_limit > 1
        self._rr = 0
        self._outstanding = [0] * self._n_replicas
        self._dead = [False] * self._n_replicas
        # One lock, two wait-sets: the dispatcher waits on _cv, each
        # completion thread on its own condition, so that a submit's
        # notify is never consumed by a completer.
        self._ccvs = [threading.Condition(self._lock) for _ in range(self._n_replicas)]
        self._cqueues: list = [deque() for _ in range(self._n_replicas)]
        self._cq_active: list = [None] * self._n_replicas
        self._completers: list = []
        # The dispatcher first: completion threads watch its liveness.
        self._worker = self._spawn_worker()
        if self._pipelined:
            self._completers = [self._spawn_completer(r) for r in range(self._n_replicas)]

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._loop, name="keystone-serve", daemon=True)
        t.start()
        return t

    def _spawn_completer(self, r: int) -> threading.Thread:
        t = threading.Thread(target=self._complete_loop, args=(r,),
                             name=f"keystone-serve-complete-{r}", daemon=True)
        t.start()
        return t

    # -- client side -------------------------------------------------------

    def queue_depth(self) -> int:
        """Queued requests not yet taken into a flush group."""
        return len(self._pending)

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Queues one example (feature-shaped) or a small batch (leading row
        axis); ``deadline_ms`` overrides the service's default (0 or None
        with a 0 default: no deadline)."""
        x = _host(x, self.compiled.dtype)
        datum = x.shape == self.compiled.feature_shape
        if datum:
            x = x[None, ...]
        if x.shape[1:] != self.compiled.feature_shape:
            raise ValueError(f"request shape {x.shape} does not match served feature shape "
                             f"{self.compiled.feature_shape}")
        deadline_s = deadline_ms / 1e3 if deadline_ms is not None else self.default_deadline_s
        deadline = time.monotonic() + deadline_s if deadline_s > 0 else None
        fut: Future = Future()
        t_sub = time.perf_counter_ns()
        with self._cv:
            if self._closed:
                raise ServiceClosed("PipelineService is closed")
            self._ensure_worker_locked()
            self._revive_dead_locked()
            if len(self._pending) >= self.max_pending:
                self.rejected += 1
                reliability_counters.bump("requests_rejected")
                self._outcomes.bump("rejected")
                raise QueueFullError(
                    f"serving queue at capacity ({self.max_pending} pending); request rejected fast"
                )
            self._pending.append(_Request(x, datum, fut, deadline, t_sub))
            self.requests += 1
            depth = len(self._pending)
            self._queue_gauge.set(depth)
            self._depth_max = max(self._depth_max, depth)
            self._cv.notify()
        return fut

    def _ensure_worker_locked(self) -> None:
        """Restarts a dead dispatcher (caller holds the lock), failing the
        requests it had taken but not launched; launched groups belong to
        the completion threads and survive."""
        if self._worker.is_alive():
            return
        dead = [rq for rq in self._inflight if not rq.fut.done()]
        for rq in dead:
            self._resolve(rq.fut, exc=WorkerDiedError("serving worker died while this request was in flight"))
        if dead:
            reliability_counters.bump("futures_failed_on_worker_death", len(dead))
        self._inflight = []
        self.worker_restarts += 1
        reliability_counters.bump("worker_restarts")
        logger.warning("PipelineService worker died; restarting (restart #%d, %d in-flight futures failed)",
                       self.worker_restarts, len(dead))
        self._worker = self._spawn_worker()

    # -- dispatcher --------------------------------------------------------

    @staticmethod
    def _expired(rq: _Request) -> bool:
        return rq.deadline is not None and time.monotonic() > rq.deadline

    def _fail_expired(self, rq: _Request) -> None:
        if not self._resolve(rq.fut, exc=DeadlineExceeded("request deadline passed before the device ran it")):
            return  # another path resolved it first: counted there
        self.expired += 1
        reliability_counters.bump("deadline_expired")
        self._outcomes.bump("expired")

    def _filter_expired(self, group) -> list:
        """Deadlines checked again at flush time."""
        live = []
        for rq in group:
            if self._expired(rq):
                self._fail_expired(rq)
            else:
                live.append(rq)
        return live

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                if self._plan is not None and self._plan.check("worker_death"):
                    # Die as a crashed thread would: queued requests stay
                    # for the restarted worker.
                    raise WorkerDiedError("injected worker death (KEYSTONE_FAULTS worker_death)")
                group: list = []
                rows = 0
                flush_at: Optional[float] = None
                while True:
                    if self._pending:
                        rq = self._pending[0]
                        if self._expired(rq):
                            self._pending.popleft()
                            self._fail_expired(rq)
                            continue
                        nxt_rows = rq.x.shape[0]
                        if group and rows + nxt_rows > self.max_rows:
                            break
                        group.append(self._pending.popleft())
                        rows += nxt_rows
                        if flush_at is None:
                            flush_at = time.monotonic() + self.max_delay
                        if rows >= self.max_rows:
                            break
                        continue
                    if not group:
                        break  # everything pending had expired
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(remaining)
                self._queue_gauge.set(len(self._pending))
                if group:
                    self._inflight = list(group)
                    if not self._pipelined:
                        self._inflight_gauge.set(len(group))
            if not group:
                continue
            if self._pipelined:
                self._dispatch(group)
            else:
                self._flush(group)
                with self._cv:
                    self._inflight = []
                    self._inflight_gauge.set(0)

    @staticmethod
    def _resolve(fut: Future, value=None, exc=None) -> bool:
        """Resolves a future unless it is already resolved or cancelled;
        returns whether this call resolved it."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
            return True
        except InvalidStateError:
            return False

    def _deliver(self, live, out) -> None:
        """Slices one flush's output back per request and resolves them."""
        off = 0
        for rq in live:
            m = rq.x.shape[0]
            piece = out[off : off + m]
            if rq.datum:
                piece = piece[0]
            off += m
            now_ns = time.perf_counter_ns()
            if not self._resolve(rq.fut, value=piece):
                continue
            sec = (now_ns - rq.t_sub) / 1e9
            self._e2e.record(sec)
            e2e_latency.record(sec)
            self._outcomes.bump("ok")

    def _fail_group(self, live, e) -> None:
        """Fails every unresolved future of a flush group; serving goes on."""
        for rq in live:
            if not rq.fut.done() and self._resolve(rq.fut, exc=e):
                self._outcomes.bump("error")

    def _flush(self, group):
        """The serial flush (one replica, window 1): launch and collect."""
        live = self._filter_expired(group)
        if not live:
            return
        try:
            out = self.compiled._call_parts([rq.x for rq in live]).wait()
            with self._lock:
                self.batches_run += 1
                self.rows_served += out.shape[0]
            self._deliver(live, out)
        except Exception as e:  # the group's futures carry it; the worker goes on
            self._fail_group(live, e)

    # -- pipelined dispatch ------------------------------------------------

    def _pick_slot_locked(self) -> Optional[int]:
        """A live replica with room in its window, least-outstanding first
        and round-robin on ties, or None (caller holds the lock)."""
        idx = _least_outstanding(
            self._n_replicas, self._rr, self._outstanding.__getitem__,
            lambda i: not self._dead[i] and self._outstanding[i] < self.inflight_limit,
        )
        if idx is not None:
            self._rr = (idx + 1) % self._n_replicas
        return idx

    def _dispatch(self, group):
        """Launches one flush group on a replica without waiting for it;
        that replica's completion thread resolves the futures."""
        live = self._filter_expired(group)
        if not live:
            with self._cv:
                self._inflight = []
                self._cv.notify_all()
            return
        with self._cv:
            while True:
                r = self._pick_slot_locked()
                if r is not None:
                    break
                self._revive_if_all_dead_locked()
                r = self._pick_slot_locked()
                if r is not None:
                    break
                # Timed: a completion notifies, and the revive check stays live.
                self._cv.wait(0.1)
            self._outstanding[r] += 1
            self._inflight_gauge.set(sum(self._outstanding))
        handle = None
        rows = 0
        try:
            # Deadlines again after the wait for a slot.
            live = self._filter_expired(live)
            if live:
                rows = sum(rq.x.shape[0] for rq in live)
                handle = self.compiled._call_parts([rq.x for rq in live], replica=r,
                                                   window=self.inflight_limit)
        except Exception as e:  # the group's futures carry it; the dispatcher goes on
            self._fail_group(live, e)
            handle = None
        if handle is None:
            with self._cv:
                self._outstanding[r] = max(0, self._outstanding[r] - 1)
                self._inflight_gauge.set(sum(self._outstanding))
                self._inflight = []
                self._cv.notify_all()
            return
        rec = _FlightRec(live, handle, rows)
        with self._cv:
            if self._dead[r]:
                # The replica died after the pick: its completer is gone, so
                # the group goes back to the front of the queue.
                handle.abandon()
                for rq in reversed(live):
                    self._pending.appendleft(rq)
                reliability_counters.bump("serve_groups_redispatched")
                self._queue_gauge.set(len(self._pending))
                self._inflight = []
            else:
                self._cqueues[r].append(rec)
                self._inflight = []
                self._ccvs[r].notify()

    def _complete_loop(self, r: int):
        """Replica r's completion thread: collects launched groups in
        order, delivers them and frees their window slots. Checks the
        ``replica_death`` fault site per group."""
        while True:
            with self._ccvs[r]:
                while not self._cqueues[r]:
                    if self._dead[r]:
                        return
                    if self._closed and not self._worker.is_alive():
                        return
                    self._ccvs[r].wait(0.1)
                if self._dead[r]:
                    return
                if self._plan is not None and self._plan.check("replica_death"):
                    self._kill_replica_locked(r)
                    return
                rec = self._cqueues[r].popleft()
                self._cq_active[r] = rec
            try:
                out = rec.handle.wait()
            except Exception as e:  # the group's futures carry a device failure
                out = None
                self._fail_group(rec.live, e)
            if out is not None:
                try:
                    with self._lock:
                        self.batches_run += 1
                        self.rows_served += rec.rows
                    self._deliver(rec.live, out)
                except Exception as e:  # never die with futures in hand
                    self._fail_group(rec.live, e)
            with self._cv:
                self._cq_active[r] = None
                self._outstanding[r] = max(0, self._outstanding[r] - 1)
                self._inflight_gauge.set(sum(self._outstanding))
                self._cv.notify_all()

    def _kill_replica_locked(self, r: int) -> None:
        """Marks replica r dead and puts its in-flight groups back at the
        front of the queue, in order, for the survivors (caller holds the
        lock; the launched work is abandoned)."""
        self._dead[r] = True
        recs = list(self._cqueues[r])
        self._cqueues[r].clear()
        for rec in recs:
            rec.handle.abandon()
        for rq in reversed([rq for rec in recs for rq in rec.live]):
            self._pending.appendleft(rq)
        self._outstanding[r] = 0
        self.replica_deaths += 1
        reliability_counters.bump("replica_deaths")
        logger.warning("PipelineService %s: replica %d died; %d in-flight group(s) re-dispatched",
                       self.name, r, len(recs))
        if recs:
            reliability_counters.bump("serve_groups_redispatched", len(recs))
        self._queue_gauge.set(len(self._pending))
        self._inflight_gauge.set(sum(self._outstanding))
        self._cv.notify_all()

    def _revive_dead_locked(self) -> None:
        """Restarts every dead replica's completion thread (caller holds
        the lock): its buckets are intact, death being a thread's."""
        for i in range(self._n_replicas):
            if not self._dead[i]:
                continue
            self._dead[i] = False
            self._completers[i] = self._spawn_completer(i)
            self.replica_revivals += 1
            reliability_counters.bump("replica_revivals")
            logger.warning("PipelineService %s: replica %d revived", self.name, i)

    def _revive_if_all_dead_locked(self) -> None:
        """With every replica dead and no submit to heal the pool, the
        dispatcher revives it so that queued work drains."""
        if self._dead and all(self._dead):
            self._revive_dead_locked()

    # -- lifecycle ---------------------------------------------------------

    def close(self, drain: bool = True, join_s: Optional[float] = None):
        """Stops the service without leaving a future unresolved.
        ``drain=True`` serves what is queued and in flight first;
        ``drain=False`` fails the queued requests at once. Either way, every
        future still unresolved once the threads are joined fails with
        ``ServiceClosed``. ``join_s`` bounds the whole wait (default: up to
        ``_CLOSE_JOIN_S`` per thread). Idempotent."""
        per_thread = join_s is None
        join_s = self._CLOSE_JOIN_S if join_s is None else float(join_s)
        rejected: list = []
        with self._cv:
            self._closed = True
            if not drain:
                rejected = list(self._pending)
                self._pending.clear()
            self._cv.notify_all()
            for c in self._ccvs:
                c.notify_all()
        deadline = time.monotonic() + join_s
        for t in [self._worker, *self._completers]:
            t.join(timeout=join_s if per_thread else max(0.0, deadline - time.monotonic()))
        with self._cv:
            leftovers = list(self._pending) + list(self._inflight)
            for q in self._cqueues:
                for rec in q:
                    leftovers.extend(rec.live)
                    rec.handle.abandon()
                q.clear()
            for i, rec in enumerate(self._cq_active):
                if rec is not None:
                    leftovers.extend(rec.live)
                self._cq_active[i] = None
            self._pending.clear()
            self._inflight = []
            self._queue_gauge.set(0)
            self._inflight_gauge.set(0)
        failed = 0
        for rq in rejected + leftovers:
            if not rq.fut.done() and self._resolve(
                rq.fut, exc=ServiceClosed("PipelineService closed before this request ran")
            ):
                self._outcomes.bump("closed")
                failed += 1
        if failed:
            reliability_counters.bump("futures_failed_on_close", failed)

    def __enter__(self) -> "PipelineService":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        """Request accounting, end-to-end latency, queue and window state,
        the replica pool, and the engine's stats."""
        with self._lock:
            pending = len(self._pending)
            inflight = sum(self._outstanding) if self._pipelined else len(self._inflight)
            alive = self._worker.is_alive()
            outstanding = list(self._outstanding)
            dead = list(self._dead)
        return {
            "name": self.name,
            "requests": self.requests,
            "batches_run": self.batches_run,
            "rows_served": self.rows_served,
            "rejected": self.rejected,
            "expired": self.expired,
            "worker_restarts": self.worker_restarts,
            "coalesce_ratio": self.requests / self.batches_run if self.batches_run else None,
            "pending": pending,
            "inflight": inflight,
            "inflight_limit": self.inflight_limit,
            "pipelined": self._pipelined,
            "worker_alive": alive,
            "closed": self._closed,
            "replicas": {
                "count": self._n_replicas,
                "outstanding": outstanding,
                "dead": dead,
                "deaths": self.replica_deaths,
                "revivals": self.replica_revivals,
            },
            "outcomes": self._outcomes.snapshot(),
            "latency": self._e2e.snapshot(),
            "queue_depth": {"value": pending, "max": self._depth_max},
            "compiled": self.compiled.stats(),
        }
