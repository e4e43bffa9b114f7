"""Rule-based graph optimizer.

Counterpart of ``keystone_tpu/workflow/optimizer.py``: batches of rewrite
rules, each run to a fixed point (bounded). The default batches:

1. ``dedup`` — ``EquivalentNodeMergeRule`` merges structurally identical
   nodes (restores sharing lost to copy-on-instantiate composition);
2. ``node-level`` — ``rules.NodeOptimizationRule`` swaps an optimizable
   estimator for the concrete one its data's shapes call for;
3. ``auto-cache`` — ``rules.AutoCacheRule``, gated on ``config.auto_cache``;
4. ``fusion`` — ``ChainFusionRule``: maximal chains of device transformers
   become one ``FusedTransformer``, run as one module in row batches.

The reference's ``plan`` batch (``PlanResourcesRule``) and the measured
profile key it reads wait for the profile store.

Where the port departs: ``ChainFusionRule`` also lowers a gather whose
branches are single-consumer device transformer nodes over one input into
one ``GatherTransformer`` node, then fuses again, so a gathered featurizer
and what follows it run as one module, batch by batch. That keeps a fit's
branch outputs (1 GiB each at ImageNet's full width) from ever existing
apart from the gathered features. ``config.fuse_chains`` (off with
``KEYSTONE_NO_FUSE``) turns both off.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from keystone_tpu_torch.config import config
from keystone_tpu_torch.workflow.graph import Graph, GraphId, NodeId
from keystone_tpu_torch.workflow.operators import GatherOperator, TransformerOperator
from keystone_tpu_torch.workflow.pipeline import FusedTransformer, GatherTransformer


class Rule:
    def apply(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        raise NotImplementedError


class EquivalentNodeMergeRule(Rule):
    """Merge nodes with identical (operator signature, dependencies)."""

    def apply(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        order = graph.reachable(targets)
        canon: Dict[Tuple, NodeId] = {}
        remap: Dict[GraphId, GraphId] = {}
        ops = {}
        dps = {}
        targets_set = set(targets)
        for nid in order:
            op = graph.operators[nid]
            deps = tuple(remap.get(d, d) for d in graph.dependencies[nid])
            key = (op.signature(), deps)
            if key in canon and nid not in targets_set:
                remap[nid] = canon[key]
            else:
                canon.setdefault(key, nid)
                ops[nid] = op
                dps[nid] = deps
        # Always rebuild: this also prunes nodes unreachable from the targets
        # (orphans left by composition's copy-on-instantiate).
        return Graph(ops, dps)


class ChainFusionRule(Rule):
    """Fuse maximal single-consumer chains of device transformers, and lower
    gathers of such chains over one input (module docstring).

    Fused and gathered modules are memoized on the operator of the graph
    being optimized whose node they replace (a chain's last operator, a
    gather's operator): composition shares operators between the copies
    it makes, so re-optimizing a copy of the same logical chain (every
    ``apply`` makes one) reuses the same module object, and the module
    lives as long as the pipelines that hold the operator. The reference
    memoizes in the rule, for the session, which keeps every fitted module
    it ever fused alive.
    """

    @staticmethod
    def _memo(owner, kind: str, parts: List, make):
        """The module of ``make(parts)``, kept on ``owner``. The module holds
        its parts, so the id key cannot alias a recycled object."""
        cache = owner.__dict__.setdefault("_fused", {})
        key = (kind,) + tuple(id(p) for p in parts)
        mod = cache.get(key)
        if mod is None:
            mod = cache[key] = make(parts)
        return mod

    @staticmethod
    def _lowered(owner, mod) -> TransformerOperator:
        """A node of ``mod``, remembering the operator its memo lives on, so
        that a later fusion through this node memoizes there too."""
        op = TransformerOperator(mod)
        op._owner = getattr(owner, "_owner", owner)
        return op

    @staticmethod
    def _fusable(graph: Graph, gid: GraphId) -> bool:
        if not isinstance(gid, NodeId):
            return False
        op = graph.operators.get(gid)
        return isinstance(op, TransformerOperator) and not getattr(op.transformer, "host_stage", False)

    def _fuse_chains(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        targets_set = set(targets)
        cons = graph.consumers(targets)
        chain_of: Dict[NodeId, List[NodeId]] = {}
        for nid in graph.reachable(targets):
            if not self._fusable(graph, nid):
                continue
            dep = graph.dependencies[nid][0]
            if (
                self._fusable(graph, dep)
                and len(cons.get(dep, ())) == 1
                and dep not in targets_set
                and dep in chain_of
            ):
                chain_of[nid] = chain_of.pop(dep) + [nid]
            else:
                chain_of[nid] = [nid]
        changed = False
        ops = dict(graph.operators)
        dps = dict(graph.dependencies)
        for tail, chain in chain_of.items():
            if len(chain) < 2:
                continue
            changed = True
            stages = [graph.operators[c].transformer for c in chain]
            owner = graph.operators[tail]
            ops[tail] = self._lowered(owner, self._memo(getattr(owner, "_owner", owner), "fused", stages,
                                                        FusedTransformer))
            dps[tail] = graph.dependencies[chain[0]]
            for c in chain[:-1]:
                ops.pop(c, None)
                dps.pop(c, None)
        return Graph(ops, dps) if changed else graph

    def _lower_gathers(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        targets_set = set(targets)
        cons = graph.consumers(targets)
        ops = dict(graph.operators)
        dps = dict(graph.dependencies)
        changed = False
        for nid in graph.reachable(targets):
            if not isinstance(graph.operators[nid], GatherOperator):
                continue
            deps = graph.dependencies[nid]
            if not deps or not all(
                self._fusable(graph, d) and len(cons.get(d, ())) == 1 and d not in targets_set
                for d in deps
            ):
                continue
            inputs = {graph.dependencies[d][0] for d in deps}
            if len(inputs) != 1:
                continue
            branches = [graph.operators[d].transformer for d in deps]
            owner = graph.operators[nid]
            ops[nid] = self._lowered(owner, self._memo(owner, "gather", branches, GatherTransformer))
            dps[nid] = (inputs.pop(),)
            for d in deps:
                ops.pop(d, None)
                dps.pop(d, None)
            changed = True
        return Graph(ops, dps) if changed else graph

    def apply(self, graph: Graph, targets: Sequence[GraphId]) -> Graph:
        if not config.fuse_chains:
            return graph
        while True:
            fused = self._fuse_chains(graph, targets)
            lowered = self._lower_gathers(fused, targets)
            if lowered is fused:
                return fused
            graph = lowered


class Optimizer:
    """Batches of rules, each run to fixed point (bounded)."""

    def __init__(self, batches: Sequence[Tuple[str, Sequence[Rule], int]]):
        self.batches = list(batches)

    def execute(self, graph: Graph, targets: Sequence[GraphId], trace=None) -> Graph:
        """The optimized graph. ``trace``, a list, receives one
        ``(batch name, operators before, operators after)`` per batch."""
        for name, rules, max_iters in self.batches:
            n0 = len(graph.reachable(targets)) if trace is not None else 0
            for _ in range(max_iters):
                before = (graph.operators, graph.dependencies)
                for rule in rules:
                    graph = rule.apply(graph, targets)
                if (graph.operators, graph.dependencies) == before:
                    break
            if trace is not None:
                trace.append((name, n0, len(graph.reachable(targets))))
        return graph


def default_optimizer() -> Optimizer:
    from keystone_tpu_torch.workflow.rules import AutoCacheRule, NodeOptimizationRule

    batches: List[Tuple[str, List[Rule], int]] = [
        ("dedup", [EquivalentNodeMergeRule()], 3),
        ("node-level", [NodeOptimizationRule()], 1),
        # Gated per-apply on config.auto_cache, so the flag works whenever
        # it's flipped, not only before the env was created.
        ("auto-cache", [AutoCacheRule(only_if_enabled=True)], 1),
        ("fusion", [ChainFusionRule()], 1),
    ]
    return Optimizer(batches)
