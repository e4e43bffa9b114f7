"""Whole-pipeline optimization rules, the serving ladder's memory plan,
and the ring of decisions they record.

Counterpart of ``keystone_tpu/workflow/rules.py``: the decision log
(``OptimizerDecision``, ``record_decision``, a ring of the newest 256,
``:50-100``), ``NodeOptimizationRule`` (``:125``), ``AutoCacheRule``
(``:371``) and the serve-ladder planning (``SERVE_LADDER_BUDGET_FRAC``,
``plan_serve_ladder``, ``:586-680``).

Both graph rules read sampled costs: the 64-row ``cache.Profiler`` run
(with its counted-FLOPs correction), or shapes read off the datasets an
estimator takes directly. The reference's preferred provenance, a
measured profile from ``Pipeline.fit(profile=True)`` in the profile store,
and its ``PlanResourcesRule`` wait for ``profile_store.py``.
"""

from __future__ import annotations

import logging
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.config import config
from keystone_tpu_torch.utils.metrics import device_hbm_bytes, serve_plan_counters
from keystone_tpu_torch.workflow.cache import CacheOperator, Profiler
from keystone_tpu_torch.workflow.graph import Graph, GraphId, NodeId, fresh_node_id
from keystone_tpu_torch.workflow.operators import DatasetOperator, EstimatorOperator
from keystone_tpu_torch.workflow.optimizer import Rule

logger = logging.getLogger("keystone_tpu_torch")


@dataclass(frozen=True)
class OptimizerDecision:
    """One recorded choice: which rule, on which node, what it did, from
    which cost provenance, and why."""

    rule: str
    node: str
    action: str
    provenance: str  # "sampled" | "model"
    reason: str
    cost: Dict[str, Any] = field(default_factory=dict)


_DECISIONS_CAP = 256
_decisions_lock = threading.Lock()
_decisions: List[OptimizerDecision] = []


def record_decision(
    rule: str, node: str, action: str, provenance: str, reason: str,
    cost: Optional[Dict[str, Any]] = None,
) -> None:
    d = OptimizerDecision(rule, node, action, provenance, reason, cost or {})
    with _decisions_lock:
        _decisions.append(d)
        if len(_decisions) > _DECISIONS_CAP:
            del _decisions[: len(_decisions) - _DECISIONS_CAP]


def optimizer_decisions() -> List[OptimizerDecision]:
    """The recorded decisions, oldest first."""
    with _decisions_lock:
        return list(_decisions)


def clear_decisions() -> None:
    with _decisions_lock:
        _decisions.clear()


def _scaled_shape(value, scale: float):
    """Full-size shape estimate from a row-sampled value: axis 0 scales by
    the sample's row ratio, trailing dims are exact."""
    shape = getattr(value, "shape", None)
    if shape is None or len(shape) == 0:
        return None
    if scale == 1.0:
        return tuple(shape)
    return (int(round(shape[0] * scale)),) + tuple(shape[1:])


class NodeOptimizationRule(Rule):
    """Swap optimizable estimators for concrete implementations chosen from
    data statistics at optimization time.

    An estimator opts in by defining ``optimize_node(self, data_shape, ...)
    -> estimator``. Shapes are read from directly-attached dataset nodes;
    estimators fed by deeper transformer subgraphs get their (n, d) from
    ONE sampled prefix run per pass (memoized by the prefixes' content
    digests), so dispatch happens at optimization time, not fit time.

    The concrete replacement is memoized per (estimator, shapes): every
    pass over any copy of the graph swaps in the SAME concrete instance, so
    the replaced node's structural hash, and its fit-cache entry, are
    stable across executions.
    """

    def __init__(self, sample_rows: int = 64):
        self._memo: Dict[tuple, tuple] = {}
        self._shape_memo: Dict[tuple, List] = {}
        self.sample_rows = sample_rows

    def clear_cache(self) -> None:
        self._memo.clear()
        self._shape_memo.clear()

    @staticmethod
    def _dep_prefix_key(graph: Graph, deps: Sequence[GraphId]):
        """(memo key, sampleable): the key is a tuple of content-stable
        prefix digests (None when any prefix lacks content identity);
        sampleable=False when a prefix reaches an unbound source."""
        from keystone_tpu_torch.workflow.graph import structural_digest

        digests = []
        for d in deps:
            if not isinstance(d, NodeId):
                return None, False
            if graph.sources_of([d]):
                return None, False
            digests.append(structural_digest(graph, d))
        if any(x is None for x in digests):
            return None, True
        return tuple(digests), True

    def _sample_prefixes(self, graph: Graph, targets: Sequence[GraphId]):
        """One row-sampled execution of the input prefixes of every
        optimizable estimator that still needs sampling; they share the
        run."""
        needed = []
        for nid in graph.reachable(targets):
            op = graph.operators[nid]
            if not isinstance(op, EstimatorOperator) or getattr(op.estimator, "optimize_node", None) is None:
                continue
            deps = graph.dependencies[nid]
            if all(isinstance(d, NodeId) and isinstance(graph.operators.get(d), DatasetOperator) for d in deps):
                continue
            pkey, sampleable = self._dep_prefix_key(graph, deps)
            if not sampleable or (pkey is not None and pkey in self._shape_memo):
                continue
            needed.extend(d for d in deps if isinstance(d, NodeId))
        return Profiler(self.sample_rows).sample_values(graph, needed)

    def apply(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        out = graph
        sampled = None  # lazy: only deep-graph estimators pay for the run
        for nid in graph.reachable(targets):
            op = graph.operators[nid]
            if not isinstance(op, EstimatorOperator):
                continue
            optimize = getattr(op.estimator, "optimize_node", None)
            if optimize is None:
                continue
            deps = graph.dependencies[nid]
            shapes = []
            for dep in deps:
                shape = None
                if isinstance(dep, NodeId):
                    dep_op = graph.operators.get(dep)
                    if isinstance(dep_op, DatasetOperator):
                        shape = getattr(dep_op.data, "shape", None)
                shapes.append(None if shape is None else tuple(shape))
            provenance = "model"
            if shapes and any(s is None for s in shapes):
                pkey, sampleable = self._dep_prefix_key(graph, deps)
                if not sampleable:
                    continue  # unbound prefix: nothing to sample or dispatch
                provenance = "sampled"
                memo_shapes = self._shape_memo.get(pkey) if pkey is not None else None
                if memo_shapes is not None:
                    shapes = memo_shapes
                else:
                    sample_ok = True
                    if sampled is None:
                        try:
                            sampled = self._sample_prefixes(graph, targets)
                        except Exception:  # a prefix that cannot run on a sample
                            logger.warning("sampled prefix run failed; deep-graph estimators keep "
                                           "fit-time dispatch", exc_info=True)
                            sampled = ({}, {}, {})
                            sample_ok = False
                    values, scales, rows_ok = sampled
                    shapes = [
                        s if s is not None else (
                            _scaled_shape(values.get(dep), scales.get(dep, 1.0))
                            # A row-changing prefix makes scaled-n a lie.
                            if rows_ok.get(dep, False) else None
                        )
                        for s, dep in zip(shapes, deps)
                    ]
                    if pkey is not None and sample_ok and len(self._shape_memo) < 1024:
                        self._shape_memo[pkey] = shapes
            if not shapes or shapes[0] is None:
                continue
            key = (id(op.estimator), tuple(shapes))
            memoized = self._memo.get(key)
            if memoized is not None and memoized[0]() is op.estimator:
                concrete = memoized[1]
            else:
                concrete = optimize(*shapes)
                # The original is held weakly with eviction: a dead or
                # recycled id can never serve a stale concrete estimator.
                try:
                    ref = weakref.ref(op.estimator, lambda _r, key=key: self._memo.pop(key, None))
                except TypeError:
                    ref = None
                if ref is not None:
                    self._memo[key] = (ref, concrete)
            if concrete is not None and concrete is not op.estimator:
                choice = getattr(op.estimator, "last_choice", None)
                record_decision(
                    rule="NodeOptimizationRule", node=op.label(),
                    action=f"solver={type(concrete).__name__}", provenance=provenance,
                    reason=getattr(choice, "reason", None) or "optimize_node replacement from data shapes",
                    cost={"shapes": [list(map(int, s)) for s in shapes if s is not None]},
                )
                out = out.replace_node(nid, EstimatorOperator(concrete), graph.dependencies[nid])
        return out


class AutoCacheRule(Rule):
    """Insert cache nodes where a subchain's recompute cost exceeds its
    materialization cost, best time-saved-per-byte first, under a memory
    budget (a quarter of the device's memory unless given).

    Costs come from one 64-row sample run (``cache.Profiler``): bytes
    scale with rows, seconds with the counted-FLOPs ratio. The session
    cache keeps the values across executions (a fit, then later applies
    of the same prefix); within one execution the structural-hash memo
    already dedups.
    """

    def __init__(self, budget_bytes: int | None = None, sample_rows: int = 64,
                 min_consumers: int = 1, only_if_enabled: bool = False):
        self.budget_bytes = budget_bytes
        self.sample_rows = sample_rows
        self.min_consumers = min_consumers
        # The default optimizer installs the rule unconditionally and gates
        # each apply on config.auto_cache.
        self.only_if_enabled = only_if_enabled
        # (node label, NodeProfile) of the last sample run, for callers to read.
        self.last_profiles: List[tuple] = []

    def _skippable(self, graph: Graph, nid: NodeId, targets_set, cons) -> bool:
        op = graph.operators[nid]
        if isinstance(op, (DatasetOperator, CacheOperator)):
            return True
        if isinstance(op, EstimatorOperator):
            # Fits persist in the fit cache already, and a cache node
            # between an estimator and its delegating consumer would hide
            # the fitted transformer from Pipeline.fit's rewrite.
            return True
        return nid in targets_set or len(cons.get(nid, ())) < self.min_consumers

    def _sampled_candidates(self, graph: Graph, targets, targets_set, cons) -> List[tuple]:
        profiles = Profiler(self.sample_rows).profile(graph, targets)
        self.last_profiles = [(graph.operators[nid].label(), prof) for nid, prof in profiles.items()]
        return self._candidates(graph, profiles, targets_set, cons)

    def _candidates(self, graph: Graph, profiles, targets_set, cons) -> List[tuple]:
        """(ratio, bytes, nid, (provenance, cost)) from sample profiles."""
        out: List[tuple] = []
        for nid, prof in profiles.items():
            if self._skippable(graph, nid, targets_set, cons):
                continue
            est_bytes = int(prof.bytes * prof.scale)
            est_seconds = prof.seconds * prof.time_scale
            if est_bytes <= 0 or est_seconds <= 0:
                continue
            out.append((est_seconds / est_bytes, est_bytes, nid,
                        ("sampled", {"recompute_s": round(est_seconds, 6), "bytes": est_bytes})))
        return out

    def apply(self, graph: Graph, targets: Sequence[GraphId], profiles=None) -> Graph:
        """``profiles`` ({node: NodeProfile}) stands in for the sample run."""
        if self.only_if_enabled and not config.auto_cache:
            return graph
        budget = self.budget_bytes if self.budget_bytes is not None else device_hbm_bytes() // 4
        cons = graph.consumers(targets)
        targets_set = set(targets)
        if profiles is None:
            candidates = self._sampled_candidates(graph, targets, targets_set, cons)
        else:
            candidates = self._candidates(graph, profiles, targets_set, cons)
        if not candidates:
            return graph
        candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
        ops = dict(graph.operators)
        dps = dict(graph.dependencies)
        spent = 0
        changed = False
        for _ratio, nbytes, nid, (provenance, cost) in candidates:
            label = graph.operators[nid].label()
            if spent + nbytes > budget:
                record_decision(
                    rule="AutoCacheRule", node=label, action="cache-skip", provenance=provenance,
                    reason=f"budget exhausted ({spent + nbytes} of {budget} bytes would be pinned)",
                    cost=cost,
                )
                continue
            spent += nbytes
            changed = True
            cache_id = fresh_node_id()
            ops[cache_id] = CacheOperator()
            dps[cache_id] = (nid,)
            for consumer in cons.get(nid, ()):
                dps[consumer] = tuple(cache_id if d == nid else d for d in dps[consumer])
            record_decision(
                rule="AutoCacheRule", node=label, action="cache-insert", provenance=provenance,
                reason="best sampled time-saved-per-byte under budget",
                cost=dict(cost, budget_spent=spent, budget=budget),
            )
        return Graph(ops, dps) if changed else graph


#: The serving ladder may hold 1/SERVE_LADDER_BUDGET_FRAC of the device's
#: memory: request buffers, the in-flight window and scratch live beside it.
SERVE_LADDER_BUDGET_FRAC = 2


def plan_serve_ladder(
    ladder: Sequence[int],
    bytes_per_row: float,
    replicas: int,
    budget_bytes: Optional[int] = None,
    provenance: str = "model",
    node: str = "-",
) -> tuple:
    """Trims a candidate bucket ladder against a memory budget before any
    rung is built.

    Every rung is built on every replica and all of them stay resident, so
    a rung is priced ``bytes_per_row × rung × replicas``. Rungs are kept
    smallest first while the running total fits ``budget_bytes`` (default
    ``device_hbm_bytes() // SERVE_LADDER_BUDGET_FRAC``); the rest are
    trimmed from the top, so an oversize batch chunks through a smaller top
    rung. The smallest rung is always kept. Every plan and trim is counted
    (``serve_plan_counters``) and recorded (``record_decision``).

    Returns ``(kept_ladder, trimmed_buckets, plan_info)``.
    """
    if budget_bytes is None:
        budget_bytes = device_hbm_bytes() // SERVE_LADDER_BUDGET_FRAC
    replicas = max(1, int(replicas))
    per_bucket = {int(b): int(bytes_per_row * int(b)) * replicas for b in ladder}
    kept: List[int] = []
    trimmed: List[int] = []
    spent = 0
    for b in sorted(per_bucket):
        cost = per_bucket[b]
        if kept and spent + cost > budget_bytes:
            trimmed.append(b)
            continue
        kept.append(b)
        spent += cost
    serve_plan_counters.bump("ladders_planned")
    over_budget = spent > budget_bytes
    if over_budget:
        serve_plan_counters.bump("plans_over_budget")
    for b in trimmed:
        serve_plan_counters.bump("buckets_trimmed")
        record_decision(
            rule="PlanServeLadder", node=node, action=f"trim-bucket={b}", provenance=provenance,
            reason=(
                f"bucket {b}'s executables cannot coexist with the smaller rungs under "
                f"the memory headroom ({spent + per_bucket[b]} of {budget_bytes} bytes "
                "would be resident)"
            ),
            cost={"bucket_bytes": per_bucket[b], "ladder_bytes_kept": spent,
                  "budget_bytes": budget_bytes, "replicas": replicas},
        )
    if trimmed:
        # Per-rung cost grows with the rung, so trims are a top segment.
        serve_plan_counters.bump("top_bucket_capped")
    record_decision(
        rule="PlanServeLadder", node=node,
        action=f"serve_buckets={','.join(str(b) for b in kept)}",
        provenance=provenance,
        reason=(
            f"{len(kept)} rung(s) priced at {round(bytes_per_row, 1)} B/row x {replicas} "
            f"replica(s) fit the {budget_bytes}-byte ladder budget"
            + (f"; {len(trimmed)} rung(s) trimmed" if trimmed else "")
            + ("; STILL over budget at one rung" if over_budget else "")
        ),
        cost={"bytes_per_row": round(float(bytes_per_row), 1), "ladder_bytes": spent,
              "budget_bytes": budget_bytes, "replicas": replicas, "trimmed": list(trimmed)},
    )
    plan_info = {
        "bytes_per_row": round(float(bytes_per_row), 1),
        "provenance": provenance,
        "replicas": replicas,
        "budget_bytes": int(budget_bytes),
        "planned_bytes": int(spent),
        "headroom_bytes": int(budget_bytes - spent),
        "per_bucket_bytes": {b: per_bucket[b] for b in kept},
        "trimmed": list(trimmed),
        "over_budget": over_budget,
    }
    return tuple(kept), list(trimmed), plan_info
