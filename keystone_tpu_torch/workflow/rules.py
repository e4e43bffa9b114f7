"""The serving ladder's memory plan, and the ring of decisions it records.

Counterpart of ``keystone_tpu/workflow/rules.py``'s serve-ladder planning
(``SERVE_LADDER_BUDGET_FRAC`` at ``:586``, ``plan_serve_ladder`` at
``:589-680``) and of its decision log (``OptimizerDecision``,
``record_decision``, a ring of the newest 256). The optimizer's other
rules are not ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.utils.metrics import device_hbm_bytes, serve_plan_counters


@dataclass(frozen=True)
class OptimizerDecision:
    """One recorded choice: which rule, on which node, what it did, from
    which cost provenance, and why."""

    rule: str
    node: str
    action: str
    provenance: str  # "measured" | "model"
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
