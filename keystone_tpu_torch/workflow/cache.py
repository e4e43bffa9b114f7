"""Caching operator + sample-run profiler.

Counterpart of ``keystone_tpu/workflow/cache.py``: ``CacheOperator`` (the
Cacher analog, an identity whose value the executor keeps in the session
cache), ``NodeProfile`` and the ``Profiler`` that runs a graph on
row-sampled data, timing each node and sizing its output, for the
auto-cache and node-level rules.

Where the port departs: the reference corrects linear time extrapolation
by XLA's compiled FLOP counts at the sample and the full shape. Here a
device transformer's FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` while it runs on the sample
and on half of it, and a count a·n + b·n² through those two points is
extrapolated to the full row count. The Fisher-vector op, which the
counter cannot see on the card and would count as its plain version's
products on the CPU, counts its own formula on both devices
(``ops/fisher_vector.py::counting_flops``), so the ratio, and the
auto-cache rule's choice, is the same on the CPU and the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from keystone_tpu_torch.workflow.graph import Graph, GraphId, NodeId, SourceId
from keystone_tpu_torch.workflow.operators import (
    DatasetOperator,
    DelegatingOperator,
    EstimatorOperator,
    Operator,
)

# (transformer signature, sample shape, dtype, scale) -> FLOPs ratio;
# bounded, the oldest entry evicted first.
_FLOPS_MEMO_CAP = 256
_flops_ratio_memo: Dict[Any, float | None] = {}


class CacheOperator(Operator):
    """Identity node whose value the executor persists in the session cache
    (the Cacher analog). Inserted by AutoCacheRule or pipeline.cache()."""

    persist = True

    def execute(self, deps):
        return deps[0]

    def signature(self):
        # Transparent for prefix hashing: caching must not change identity.
        return ("cache",)

    def prefix_hash(self, dep_hashes):
        return dep_hashes[0]

    def prefix_digest(self, dep_digests):
        return dep_digests[0]

    def label(self):
        return "Cache"


def _value_bytes(v: Any) -> int:
    if isinstance(v, torch.Tensor):
        return int(v.numel()) * v.element_size()
    if isinstance(v, np.ndarray):
        return int(v.nbytes)
    if hasattr(v, "nbytes"):  # e.g. SparseBatch
        return int(v.nbytes)
    if isinstance(v, (list, tuple)):
        return sum(_value_bytes(x) for x in v)
    if isinstance(v, str):
        return len(v)
    return 64  # opaque host object: nominal


def _sample(data: Any, max_rows: int) -> Any:
    try:
        return data[:max_rows]
    except TypeError:
        return data


def _sync(value) -> None:
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


def count_flops(transformer, X) -> int:
    """FLOPs of one eager call of ``transformer`` on ``X``, by
    ``FlopCounterMode`` plus the Fisher-vector op's own formula."""
    from torch.utils.flop_counter import FlopCounterMode

    from keystone_tpu_torch.ops.fisher_vector import counting_flops

    with FlopCounterMode(display=False) as counter, counting_flops() as fv, torch.no_grad():
        transformer(X)
    return int(counter.get_total_flops()) + int(fv[0])


@dataclass
class NodeProfile:
    seconds: float
    bytes: int
    scale: float  # full-size / sample-size row ratio estimate
    # Counted FLOPs ratio full/sample for device nodes: the non-linear
    # correction (a stage quadratic in rows has ratio ≈ scale²).
    flops_ratio: float | None = None

    @property
    def time_scale(self) -> float:
        """Multiplier from sampled seconds to full-size seconds: counted
        FLOPs when there are some, row ratio otherwise (host nodes)."""
        return self.flops_ratio if self.flops_ratio is not None else self.scale


class Profiler:
    """Executes the graph on row-sampled dataset nodes, timing each operator
    and sizing each output (the AutoCacheRule sampling profiler)."""

    def __init__(self, sample_rows: int = 64):
        self.sample_rows = sample_rows

    @staticmethod
    def _flops_ratio(transformer, sample_input, scale: float) -> float | None:
        """full/sample FLOPs, from counts at the sample's rows n₁ and at
        n₂ = n₁/2 fitted as a·n + b·n²; None when not countable (host
        nodes, non-tensors, fewer than two rows, a failed count)."""
        if scale <= 1.0 or getattr(transformer, "host_stage", False):
            return None
        if not isinstance(sample_input, (torch.Tensor, np.ndarray)) or sample_input.ndim < 1:
            return None
        x = torch.as_tensor(sample_input)
        if x.device.type == "cpu":
            from keystone_tpu_torch.workflow.executor import PipelineEnv

            x = x.to(PipelineEnv.get().device)
        n1 = int(x.shape[0])
        n2 = n1 // 2
        if n2 < 1:
            return None
        key = None
        try:
            key = (transformer.signature(), tuple(x.shape), str(x.dtype), scale)
            if key in _flops_ratio_memo:
                return _flops_ratio_memo[key]
        except (TypeError, AttributeError):
            key = None
        try:
            f1 = count_flops(transformer, x)
            f2 = count_flops(transformer, x[:n2])
        except Exception:  # a count that fails means no FLOPs correction
            return None
        ratio = None
        if f1 > 0 and f2 > 0:
            b = max((f1 / n1 - f2 / n2) / (n1 - n2), 0.0)
            a = f1 / n1 - b * n1
            full = n1 * scale
            ratio = (a * full + b * full * full) / f1
        if key is not None:
            while len(_flops_ratio_memo) >= _FLOPS_MEMO_CAP:
                _flops_ratio_memo.pop(next(iter(_flops_ratio_memo)))
            _flops_ratio_memo[key] = ratio
        return ratio

    @staticmethod
    def _execute_node(op: Operator, dep_vals: List[Any]) -> Any:
        """Execute one non-dataset node on sampled inputs. Estimator fits
        run on a COPY of the user's estimator, so a probe's side effects
        never reach the object the real execution fits."""
        if isinstance(op, EstimatorOperator):
            import copy

            try:
                probe = copy.deepcopy(op.estimator)
            except Exception:  # deepcopy of arbitrary estimator state: shallow instead
                probe = copy.copy(op.estimator)
            return EstimatorOperator(probe).execute(dep_vals)
        return op.execute(dep_vals)

    def _sampled_walk(self, graph: Graph, ids: Sequence[GraphId], on_node=None):
        """Row-sample dataset nodes and execute everything reachable from
        ``ids`` in topological order. Returns ({node: value}, {node:
        row-scale}, {node: rows-reliable}); a row-changing node poisons
        reliability downstream. ``on_node(nid, op, dep_vals, value, scale,
        dt)`` observes each executed node."""
        values: Dict[GraphId, Any] = {}
        scales: Dict[GraphId, float] = {}
        rows_ok: Dict[GraphId, bool] = {}
        if not ids:
            return values, scales, rows_ok
        for nid in graph.reachable(ids):
            op = graph.operators[nid]
            deps = graph.dependencies[nid]
            if any(isinstance(d, SourceId) for d in deps):
                continue  # unbound inference path: no sample data
            if any(d not in values and isinstance(d, NodeId) for d in deps):
                continue  # upstream skipped
            dep_vals = [values[d] for d in deps]
            if isinstance(op, DatasetOperator):
                full = op.data
                value = _sample(full, self.sample_rows)
                try:
                    scale = max(len(full), 1) / max(len(value), 1)
                except TypeError:
                    scale = 1.0
                dt = 0.0
                ok = True
            else:
                t0 = time.perf_counter()
                value = self._execute_node(op, dep_vals)
                _sync(value)
                dt = time.perf_counter() - t0
                scale = max([scales.get(d, 1.0) for d in deps], default=1.0)
                ok = all(rows_ok.get(d, True) for d in deps)
                if ok:
                    in_rows = next((len(v) for v in dep_vals if hasattr(v, "__len__")), None)
                    try:
                        out_rows = len(value)
                    except TypeError:
                        out_rows = None
                    if in_rows is not None and out_rows is not None and out_rows != in_rows:
                        ok = False  # row-changing node: scale no longer = n
            values[nid], scales[nid], rows_ok[nid] = value, scale, ok
            if on_node is not None:
                on_node(nid, op, dep_vals, value, scale, dt)
        return values, scales, rows_ok

    def sample_values(self, graph: Graph, needed: Sequence[GraphId]):
        """Row-sampled prefix execution without timing: ({node: value},
        {node: row-scale}, {node: rows-reliable}) for everything reachable
        from ``needed`` (how NodeOptimizationRule gets (n, d) of a deep
        prefix)."""
        return self._sampled_walk(graph, needed)

    def profile(self, graph: Graph, targets: Sequence[GraphId]) -> Dict[NodeId, NodeProfile]:
        profiles: Dict[NodeId, NodeProfile] = {}

        def on_node(nid, op, dep_vals, value, scale, dt):
            if isinstance(op, DatasetOperator):
                profiles[nid] = NodeProfile(seconds=dt, bytes=_value_bytes(value), scale=scale)
                return
            transformer = getattr(op, "transformer", None)
            batch_val = dep_vals[0] if dep_vals else None
            if transformer is None and isinstance(op, DelegatingOperator) and len(dep_vals) == 2:
                transformer, batch_val = dep_vals[0], dep_vals[1]
            if transformer is not None and not getattr(transformer, "host_stage", False):
                # Re-time on the warmed path, so the seconds exclude first-use
                # costs (kernel builds, cuDNN's algorithm search).
                t0 = time.perf_counter()
                out = op.execute(dep_vals)
                _sync(out)
                dt = time.perf_counter() - t0
            flops_ratio = None
            if transformer is not None:
                flops_ratio = self._flops_ratio(transformer, batch_val, scale)
            profiles[nid] = NodeProfile(seconds=dt, bytes=_value_bytes(value), scale=scale,
                                        flops_ratio=flops_ratio)

        self._sampled_walk(graph, targets, on_node)
        return profiles
