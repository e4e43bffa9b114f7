"""Immutable dataflow-graph IR for pipelines.

The port's copy of ``keystone_tpu/workflow/graph.py``; nothing differs
but the package the digest helper comes from.

The reference models a pipeline as an immutable DAG of operator nodes with
typed source/sink endpoints (Ref: src/main/scala/workflow/Graph.scala,
workflow/GraphId.scala [unverified]). We keep that shape: ``NodeId`` ->
``Operator`` with dependency edges on ``GraphId`` (node or source).

Unlike the reference (which remaps ids when merging graphs), every id here is
globally unique (a process-wide counter), so merging two graphs is a plain
dict union and structural sharing of common prefixes is free. Composition
operations that would re-wire an existing node instead *instantiate* a fresh
copy of the right-hand subgraph (`instantiate`), preserving immutability.

Cross-graph deduplication (so a re-used prefix is only computed/fitted once)
is done by *structural hashing* rather than id identity — see
``structural_hash`` and the executor's memo tables; this plays the role of the
reference's `workflow/Prefix.scala` prefix hashing [unverified].
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Mapping, Sequence, Tuple, Union

_counter = itertools.count()


@dataclass(frozen=True)
class NodeId:
    id: int

    def __repr__(self):
        return f"n{self.id}"


@dataclass(frozen=True)
class SourceId:
    id: int

    def __repr__(self):
        return f"src{self.id}"


GraphId = Union[NodeId, SourceId]


def fresh_node_id() -> NodeId:
    return NodeId(next(_counter))


def fresh_source_id() -> SourceId:
    return SourceId(next(_counter))


class Graph:
    """Immutable DAG: ``operators[node]`` with ``dependencies[node]`` edges.

    Sources are implicit: any ``SourceId`` appearing in a dependency list is a
    free input of the graph. Pipelines track their own source/sink endpoints.
    """

    __slots__ = ("operators", "dependencies")

    def __init__(
        self,
        operators: Mapping[NodeId, Any] | None = None,
        dependencies: Mapping[NodeId, Tuple[GraphId, ...]] | None = None,
    ):
        self.operators: Dict[NodeId, Any] = dict(operators or {})
        self.dependencies: Dict[NodeId, Tuple[GraphId, ...]] = dict(dependencies or {})

    # -- construction ------------------------------------------------------

    def add(self, op: Any, deps: Sequence[GraphId]) -> Tuple["Graph", NodeId]:
        nid = fresh_node_id()
        ops = dict(self.operators)
        dps = dict(self.dependencies)
        ops[nid] = op
        dps[nid] = tuple(deps)
        return Graph(ops, dps), nid

    def union(self, other: "Graph") -> "Graph":
        """Merge two graphs. Shared node ids must agree (they do by
        construction: ids are globally unique and nodes immutable)."""
        ops = dict(self.operators)
        ops.update(other.operators)
        dps = dict(self.dependencies)
        dps.update(other.dependencies)
        return Graph(ops, dps)

    # -- traversal ---------------------------------------------------------

    def reachable(self, targets: Iterable[GraphId]) -> List[NodeId]:
        """Nodes reachable (upward through dependencies) from targets, in
        topological order (dependencies first)."""
        order: List[NodeId] = []
        seen: Dict[GraphId, bool] = {}
        stack: List[Tuple[GraphId, bool]] = [(t, False) for t in targets]
        while stack:
            gid, processed = stack.pop()
            if processed:
                order.append(gid)  # type: ignore[arg-type]
                continue
            if gid in seen or isinstance(gid, SourceId):
                continue
            seen[gid] = True
            stack.append((gid, True))
            for dep in self.dependencies[gid]:
                if dep not in seen and isinstance(dep, NodeId):
                    stack.append((dep, False))
        return order

    def sources_of(self, targets: Iterable[GraphId]) -> List[SourceId]:
        srcs: List[SourceId] = []
        seen = set()
        for t in targets:
            if isinstance(t, SourceId) and t not in seen:
                seen.add(t)
                srcs.append(t)
        for nid in self.reachable(targets):
            for dep in self.dependencies[nid]:
                if isinstance(dep, SourceId) and dep not in seen:
                    seen.add(dep)
                    srcs.append(dep)
        return srcs

    # -- instantiation (fresh-copy of a subgraph) --------------------------

    def instantiate(
        self,
        targets: Sequence[GraphId],
        replace: Mapping[GraphId, GraphId] | None = None,
    ) -> Tuple["Graph", List[GraphId]]:
        """Copy the subgraph reachable from ``targets`` with fresh node ids,
        rewriting ids per ``replace`` (typically mapping a SourceId to a data
        node or to another graph's sink). Returns (graph-with-copies-merged,
        new targets). Nodes are copied; operators are shared by reference.
        """
        replace = dict(replace or {})
        mapping: Dict[GraphId, GraphId] = dict(replace)
        ops = dict(self.operators)
        dps = dict(self.dependencies)
        for nid in self.reachable(targets):
            new_id = fresh_node_id()
            mapping[nid] = new_id
            ops[new_id] = self.operators[nid]
            dps[new_id] = tuple(mapping.get(d, d) for d in self.dependencies[nid])
        new_targets = [mapping.get(t, t) for t in targets]
        return Graph(ops, dps), new_targets

    def pruned(self, targets: Sequence[GraphId]) -> "Graph":
        """Keep only nodes reachable from targets (drops composition orphans,
        keeping graph size linear in the live pipeline)."""
        keep = self.reachable(targets)
        return Graph(
            {n: self.operators[n] for n in keep},
            {n: self.dependencies[n] for n in keep},
        )

    def replace_node(self, nid: NodeId, op: Any, deps: Sequence[GraphId]) -> "Graph":
        ops = dict(self.operators)
        dps = dict(self.dependencies)
        ops[nid] = op
        dps[nid] = tuple(deps)
        return Graph(ops, dps)

    def consumers(self, targets: Iterable[GraphId]) -> Dict[GraphId, List[NodeId]]:
        """Map each graph id to the list of nodes that depend on it (within
        the subgraph reachable from targets)."""
        out: Dict[GraphId, List[NodeId]] = {}
        for nid in self.reachable(targets):
            for dep in self.dependencies[nid]:
                out.setdefault(dep, []).append(nid)
        return out


def structural_hash(
    graph: Graph,
    target: GraphId,
    source_key: Callable[[SourceId], Any],
    _memo: Dict[GraphId, int] | None = None,
) -> int:
    """Structural (prefix) hash of the computation producing ``target``.

    Two nodes with the same operator signature and structurally identical
    dependency prefixes hash equal, even across graph copies. This is the
    TPU-rebuild analog of the reference's fitted-prefix memoization key
    (Ref: workflow/Prefix.scala [unverified]).
    """
    memo: Dict[GraphId, int] = {} if _memo is None else _memo

    def rec(gid: GraphId) -> int:
        if gid in memo:
            return memo[gid]
        if isinstance(gid, SourceId):
            h = hash(("source", source_key(gid)))
        else:
            op = graph.operators[gid]
            dep_h = tuple(rec(d) for d in graph.dependencies[gid])
            h = op.prefix_hash(dep_h)
        memo[gid] = h
        return h

    return rec(target)


def structural_digest(
    graph: Graph,
    target: GraphId,
    _memo: Dict[GraphId, Any] | None = None,
    source_token: str | None = None,
) -> str | None:
    """Content-stable prefix digest of ``target`` — the cross-process cache
    key. None when any operator in the prefix lacks content identity, or the
    prefix reaches a free source (an unbound input has no content) — unless
    ``source_token`` names the free input, for digesting pipeline TEMPLATES
    (e.g. an unfitted featurizer front) rather than bound executions."""
    memo: Dict[GraphId, Any] = {} if _memo is None else _memo

    def rec(gid: GraphId):
        if gid in memo:
            return memo[gid]
        if isinstance(gid, SourceId):
            if source_token is not None:
                from keystone_tpu_torch.workflow.fingerprint import digest_tree

                d = digest_tree(("source", source_token))
            else:
                d = None
        else:
            op = graph.operators[gid]
            dep_d = tuple(rec(x) for x in graph.dependencies[gid])
            d = op.prefix_digest(dep_d)
        memo[gid] = d
        return d

    return rec(target)
