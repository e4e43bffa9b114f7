"""Graph executor + session environment.

Counterpart of ``keystone_tpu/workflow/executor.py``. The executor walks
the DAG in topological order, memoizing values by *structural prefix
hash* so that:

- duplicated subgraphs (created by composition's copy-on-instantiate) are
  computed once per execution;
- estimator fits are memoized across executions in ``PipelineEnv.fit_cache``
  and, with ``KEYSTONE_CACHE_DIR``/``config.cache_dir``, across processes
  in the ``DiskFitCache``;
- values marked by a cache node (``Pipeline.cache()``, ``Cacher``, the
  auto-cache rule) persist in ``node_cache``;
- the walk cuts at cache hits: a cached node's prefix is never visited.

Where the port departs:

- The serial walk drops each value after its last consumer in the walk has
  run (targets and cached values stay): a fit's branch outputs do not
  outlive the node that reads them.
- Where a node feeds an estimator's data, the walk marks the stage
  ``apply the prefix to the fit data`` (``apply the host prefix to the fit
  data`` for host values) for ``utils/stages.py``'s timers.
- ``PipelineEnv.device`` is where device stages run on host data
  (``resolve_device()``: the card unless a caller names another, with
  ``on_device``); a tensor on a card keeps its device.
- ``_ParallelWalk`` sets each worker's current CUDA device to the env's
  and leaves the work on that device's default stream, so its launches are
  ordered as the serial walk's would be on one stream.
- ``serving_chain`` lowers a gather of linear chains over one input into
  one ``GatherTransformer``; the reference refuses gathers there.
- No tracer spans, resource profile or profile store (not ported).
"""

from __future__ import annotations

import contextvars
import logging
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow.graph import (
    Graph,
    GraphId,
    NodeId,
    SourceId,
    structural_digest,
    structural_hash,
)
from keystone_tpu_torch.workflow.operators import (
    DatasetOperator,
    DelegatingOperator,
    EstimatorOperator,
    GatherOperator,
    TransformerOperator,
)

logger = logging.getLogger("keystone_tpu_torch")


class UnboundSourceError(RuntimeError):
    pass


def _no_sources(sid: SourceId):
    raise UnboundSourceError(f"graph has unbound source {sid!r}; apply the pipeline to data first")


def _fit_data_stage(value) -> str:
    """The stage name of applying a prefix to an estimator's data."""
    if isinstance(value, torch.Tensor):
        return "apply the prefix to the fit data"
    return "apply the host prefix to the fit data"


#: Thread-local flag marking "this thread is a parallel-walk worker": a
#: nested walk from a pool thread (an estimator fitting sub-pipelines) takes
#: the serial path instead of spawning a second pool under the first.
_walk_tls = threading.local()

_pool_lock = threading.Lock()
_shared_pool = None
_shared_pool_workers = 0


def _exec_pool(workers: int):
    """The process-wide executor worker pool, built lazily and reused
    across walks; rebuilt when the requested width changes."""
    global _shared_pool, _shared_pool_workers
    from concurrent.futures import ThreadPoolExecutor

    with _pool_lock:
        if _shared_pool is None or _shared_pool_workers != workers:
            if _shared_pool is not None:
                _shared_pool.shutdown(wait=False)
            _shared_pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="keystone-exec")
            _shared_pool_workers = workers
        return _shared_pool


class _ParallelWalk:
    """Dependency-counting ready-set scheduler over one executor walk.

    Every node of the (already cache-cut) ``order`` becomes a task; a node
    dispatches onto the bounded pool the moment its inputs are resolved,
    so independent branches (ImageNet's SIFT and LCS fronts) run
    concurrently. Semantics are the serial walk's, bit for bit:

    - cache cuts were resolved by the discovery pass;
    - the FIRST node (in topological order) with a given prefix hash owns
      it and executes; same-hash duplicates wait for the owner and copy
      its value;
    - fit/persist cache writes happen under the walk lock;
    - a fault on a worker cancels the remaining schedule and re-raises on
      the calling thread.

    Each task runs with the env's CUDA device current and on its default
    stream: launches from two workers are ordered on that one stream, and a
    value published by one worker is safe for another to read.
    """

    def __init__(self, executor, graph, order, values, by_hash, hmemo, d_of, workers, fit_data):
        self.ex = executor
        self.graph = graph
        self.values = values
        self.by_hash = by_hash
        self.hashes = hmemo
        self.workers = workers
        self.fit_data = fit_data
        # The CUDA device index the workers make current (None off a card),
        # read on the calling thread.
        dev = executor.env._device
        dev = torch.device(dev) if dev is not None else (
            torch.device("cuda") if torch.cuda.is_available() else None)
        self.cuda_index = None
        if dev is not None and dev.type == "cuda":
            self.cuda_index = dev.index if dev.index is not None else torch.cuda.current_device()
        self._ctx = contextvars.copy_context()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pool = None
        self._error: Optional[BaseException] = None
        self._stop = False
        self._inflight = 0
        self._remaining = len(order)
        self.is_memo: set = set()
        self.dks: Dict[NodeId, Any] = {}
        self.pend: Dict[NodeId, int] = {}
        self.dependents: Dict[NodeId, List[NodeId]] = {}
        self.initial: List[NodeId] = []
        owner_of_hash: Dict[int, NodeId] = {}
        for nid in order:
            h = hmemo[nid]
            if h in by_hash:
                self.is_memo.add(nid)
                deps = set()
            elif h in owner_of_hash:
                self.is_memo.add(nid)
                deps = {owner_of_hash[h]}
            else:
                owner_of_hash[h] = nid
                deps = {d for d in graph.dependencies[nid] if isinstance(d, NodeId) and d not in values}
                op = graph.operators[nid]
                if isinstance(op, EstimatorOperator) and executor.env.disk_cache is not None:
                    self.dks[nid] = d_of(nid)
            self.pend[nid] = len(deps)
            for d in deps:
                self.dependents.setdefault(d, []).append(nid)
            if not deps:
                self.initial.append(nid)

    def run(self) -> None:
        pool = _exec_pool(self.workers)
        with self._lock:
            self._pool = pool
            for nid in self.initial:
                self._submit_locked(nid)
            while self._remaining and not (self._stop and self._inflight == 0):
                self._cv.wait()
            self._pool = None
        if self._error is not None:
            raise self._error

    def _submit_locked(self, nid: NodeId) -> None:
        if self._stop or self._pool is None:
            return
        self._pool.submit(self._ctx.copy().run, self._run_node_worker, nid)
        self._inflight += 1

    def _run_node_worker(self, nid: NodeId) -> None:
        with self._lock:
            if self._stop:
                self._finish_locked()
                return
        _walk_tls.active = True
        try:
            if self.cuda_index is not None:
                torch.cuda.set_device(self.cuda_index)
            out = self._execute(nid)
            with self._lock:
                self._publish_locked(nid, out)
                self._finish_locked()
        except BaseException as e:  # re-raised on the caller by run()
            with self._lock:
                if self._error is None:
                    self._error = e
                self._stop = True
                self._finish_locked()
        finally:
            _walk_tls.active = False

    def _finish_locked(self) -> None:
        self._inflight -= 1
        self._cv.notify_all()

    def _execute(self, nid: NodeId):
        graph = self.graph
        op = graph.operators[nid]
        if nid in self.is_memo:
            return self.by_hash[self.hashes[nid]]
        out = op.execute([self.values[d] for d in graph.dependencies[nid]])
        if nid in self.fit_data:
            mark(_fit_data_stage(out))
        if isinstance(op, EstimatorOperator):
            dk = self.dks.get(nid)
            if dk is not None:
                self.ex.env.disk_cache.put(dk, out)
        return out

    def _publish_locked(self, nid: NodeId, out) -> None:
        graph = self.graph
        op = graph.operators[nid]
        h = self.hashes[nid]
        self.values[nid] = out
        env = self.ex.env
        if nid not in self.is_memo:
            self.by_hash[h] = out
            if isinstance(op, EstimatorOperator):
                self.ex._cache_fit(graph, nid, h, op, out)
            if getattr(op, "persist", False):
                env.node_cache[h] = (out, self.ex._prefix_pins(graph, nid))
        elif getattr(op, "persist", False) and h not in env.node_cache:
            env.node_cache[h] = (out, self.ex._prefix_pins(graph, nid))
        self._remaining -= 1
        for dep in self.dependents.get(nid, ()):
            self.pend[dep] -= 1
            if self.pend[dep] == 0:
                self._submit_locked(dep)


class GraphExecutor:
    def __init__(self, env: "PipelineEnv"):
        self.env = env

    def _disk_key(self, graph: Graph, nid: GraphId, dmemo: Dict[GraphId, Any]):
        """The disk cache's key of an estimator node: its prefix digest
        salted with the numeric regime (float32 and the solver's modes)."""
        if self.env.disk_cache is None:
            return None
        dk = structural_digest(graph, nid, dmemo)
        if dk is None:
            return None
        from keystone_tpu_torch.config import solver_precision, solver_storage_dtype
        from keystone_tpu_torch.workflow.fingerprint import digest_tree

        return digest_tree(("v1", dk, "float32", solver_precision(), solver_storage_dtype()))

    def execute_many(self, graph: Graph, targets: Sequence[GraphId]) -> Dict[GraphId, Any]:
        """Evaluate all targets in one pass with shared memoization.

        The walk CUTS at persistent-cache hits: a node whose structural hash
        is already in the fit/node cache becomes a leaf and its upstream
        subgraph is never visited. Returns the targets' values (the serial
        walk drops every other value after its last use)."""
        for t in targets:
            if isinstance(t, SourceId):
                _no_sources(t)
        hmemo: Dict[GraphId, int] = {}
        dmemo: Dict[GraphId, Any] = {}

        def h_of(nid: GraphId) -> int:
            return structural_hash(graph, nid, _no_sources, hmemo)

        def d_of(nid: GraphId):
            return self._disk_key(graph, nid, dmemo)

        values: Dict[GraphId, Any] = {}
        by_hash: Dict[int, Any] = {}
        order: List[GraphId] = []
        seen = set()
        stack: List[tuple] = [(t, False) for t in targets]
        while stack:
            gid, processed = stack.pop()
            if processed:
                order.append(gid)
                continue
            if gid in seen or isinstance(gid, SourceId):
                continue
            seen.add(gid)
            op = graph.operators[gid]
            h = h_of(gid)
            hit = None
            if isinstance(op, EstimatorOperator) and h in self.env.fit_cache:
                hit = self.env.fit_cache[h][0]
            elif isinstance(op, EstimatorOperator):
                dk = d_of(gid)
                if dk is not None:
                    hit = self.env.disk_cache.get(dk)
                    if hit is not None:
                        hit = _to_device(hit, self.env)
                        self._cache_fit(graph, gid, h, op, hit)
            elif h in self.env.node_cache:
                hit = self.env.node_cache[h][0]
            if hit is not None:
                values[gid] = by_hash[h] = hit
                continue  # leaf: do not descend into its dependencies
            stack.append((gid, True))
            for dep in graph.dependencies[gid]:
                if dep not in seen and isinstance(dep, NodeId):
                    stack.append((dep, False))

        # Nodes whose value is an estimator's data (after a real prefix).
        fit_data = {
            graph.dependencies[n][0]
            for n in order
            if isinstance(graph.operators[n], EstimatorOperator)
            and isinstance(graph.dependencies[n][0], NodeId)
            and not isinstance(graph.operators.get(graph.dependencies[n][0]), DatasetOperator)
        }

        if len(order) > 1 and not getattr(_walk_tls, "active", False):
            from keystone_tpu_torch.config import resolved_exec_workers

            workers = resolved_exec_workers()
            if workers and workers > 0:
                for nid in order:
                    h_of(nid)
                _ParallelWalk(self, graph, order, values, by_hash, hmemo, d_of, workers, fit_data).run()
                return {t: values[t] for t in targets}

        # The last walk position that reads each hash's value (a consumer,
        # or a duplicate that copies it): after it, the value is dropped.
        keep = {h_of(t) for t in targets}
        last_use: Dict[int, int] = {}
        for i, nid in enumerate(order):
            last_use[h_of(nid)] = i
            for d in graph.dependencies[nid]:
                if isinstance(d, NodeId):
                    last_use[h_of(d)] = i
        release: Dict[int, List[int]] = {}
        for h, i in last_use.items():
            if h not in keep:
                release.setdefault(i, []).append(h)
        hash_nodes: Dict[int, List[GraphId]] = {}
        for nid in list(values) + order:
            hash_nodes.setdefault(h_of(nid), []).append(nid)

        for i, nid in enumerate(order):
            h = h_of(nid)
            op = graph.operators[nid]
            if h in by_hash:
                values[nid] = by_hash[h]
                # A cache node hashes identically to its dependency (it's an
                # identity), so it lands here: still persist its value.
                if getattr(op, "persist", False) and h not in self.env.node_cache:
                    self.env.node_cache[h] = (values[nid], self._prefix_pins(graph, nid))
            else:
                out = op.execute([values[d] for d in graph.dependencies[nid]])
                if nid in fit_data:
                    mark(_fit_data_stage(out))
                values[nid] = by_hash[h] = out
                if isinstance(op, EstimatorOperator):
                    self._cache_fit(graph, nid, h, op, out)
                    dk = d_of(nid)
                    if dk is not None:
                        self.env.disk_cache.put(dk, out)
                if getattr(op, "persist", False):
                    self.env.node_cache[h] = (out, self._prefix_pins(graph, nid))
            for dead in release.get(i, ()):
                by_hash.pop(dead, None)
                for n in hash_nodes.get(dead, ()):
                    values.pop(n, None)
        return {t: values[t] for t in targets}

    def _cache_fit(self, graph: Graph, nid: NodeId, h: int, op, out) -> None:
        """Cache a fitted transformer, scoped to the estimator's lifetime:
        the entry pins every prefix object except the estimator, which is
        held weakly with an eviction callback."""
        estimator = op.estimator
        pins = tuple(p for p in self._prefix_pins(graph, nid) if p is not estimator)
        fit_cache = self.env.fit_cache
        try:
            keeper: Any = weakref.ref(estimator, lambda _ref, h=h: fit_cache.pop(h, None))
        except TypeError:  # not weak-referenceable: pin strongly
            keeper = estimator
        fit_cache[h] = (out, pins, keeper)

    @staticmethod
    def _prefix_pins(graph: Graph, nid: NodeId) -> tuple:
        """Strong references to every object whose id() feeds the prefix
        hash of ``nid``."""
        pins = []
        for n in graph.reachable([nid]):
            pins.extend(graph.operators[n].pinned_objects())
        return tuple(pins)

    def execute(self, graph: Graph, target: GraphId) -> Any:
        return self.execute_many(graph, [target])[target]

    def fit_estimators(self, graph: Graph, sink: GraphId) -> Graph:
        """Force every estimator reachable from ``sink`` and rewrite the graph
        so each DelegatingOperator becomes a concrete TransformerOperator:
        the ``Pipeline.fit`` lowering."""
        graph = self.env.optimizer.execute(graph, [sink])
        order = graph.reachable([sink])
        est_nodes = [n for n in order if isinstance(graph.operators[n], EstimatorOperator)]
        fitted = self.execute_many(graph, est_nodes) if est_nodes else {}
        ops = dict(graph.operators)
        dps = dict(graph.dependencies)
        for nid in order:
            op = graph.operators[nid]
            if isinstance(op, DelegatingOperator):
                est_dep, input_dep = graph.dependencies[nid]
                # See through identity cache nodes between estimator and
                # delegating consumer.
                while est_dep in graph.operators and getattr(graph.operators[est_dep], "persist", False):
                    est_dep = graph.dependencies[est_dep][0]
                if est_dep in fitted:
                    ops[nid] = TransformerOperator(fitted[est_dep])
                    dps[nid] = (input_dep,)
        # Prune: drops the now-unreferenced estimator nodes and their
        # training data so a fitted pipeline doesn't pin the training set.
        return Graph(ops, dps).pruned([sink])

    def serving_chain(self, graph: Graph, source: SourceId, sink: GraphId):
        """Lower a FITTED pipeline graph to the one module its inference path
        runs: optimize (fusing chains), then walk sink → source through
        transformer nodes, seeing through cache nodes and lowering a gather
        of linear chains that all start at one node into one
        ``GatherTransformer``. Anything else (an unfitted estimator, a
        gather of chains from different inputs) is refused, naming it."""
        from keystone_tpu_torch.workflow.pipeline import FusedTransformer

        g = self.env.optimizer.execute(graph, [sink])
        chain = _lower_chain(g, sink, source)
        if not chain:
            raise ValueError("pipeline has no transformers on the serve path")
        return chain[0] if len(chain) == 1 else FusedTransformer(chain)


def _lower_chain(g: Graph, gid: GraphId, stop: GraphId) -> List[Any]:
    """The transformers from ``stop`` (exclusive) to ``gid``, in order."""
    from keystone_tpu_torch.workflow.pipeline import GatherTransformer

    chain: List[Any] = []
    while gid != stop:
        if isinstance(gid, SourceId):
            raise ValueError(f"serve path ends at foreign source {gid!r}, not the pipeline's own input")
        op = g.operators[gid]
        deps = g.dependencies[gid]
        if getattr(op, "persist", False):  # identity Cache node
            gid = deps[0]
            continue
        if isinstance(op, GatherOperator):
            start = _gather_start(g, deps, stop)
            branches = []
            for d in deps:
                sub = _lower_chain(g, d, start)
                branches.append(sub[0] if len(sub) == 1 else _fused(sub))
            chain.append(GatherTransformer(branches))
            gid = start
            continue
        if not isinstance(op, TransformerOperator):
            raise TypeError(
                f"cannot serve {op.label()}: the serve path must be a fitted chain of "
                "transformers (fit the pipeline first)"
            )
        if len(deps) != 1:
            raise TypeError(f"serve path node {op.label()} has {len(deps)} inputs")
        chain.append(op.transformer)
        gid = deps[0]
    chain.reverse()
    return chain


def _fused(stages):
    from keystone_tpu_torch.workflow.pipeline import FusedTransformer

    return FusedTransformer(stages)


def _linear_path(g: Graph, gid: GraphId, stop: GraphId) -> List[GraphId]:
    """The ids from ``gid`` up its first dependencies until ``stop`` or a
    node that is not a one-input transformer or cache node."""
    path = [gid]
    while gid != stop and isinstance(gid, NodeId):
        op = g.operators[gid]
        deps = g.dependencies[gid]
        if len(deps) != 1 or not (isinstance(op, TransformerOperator) or getattr(op, "persist", False)):
            break
        gid = deps[0]
        path.append(gid)
    return path


def _gather_start(g: Graph, deps, stop: GraphId) -> GraphId:
    """The one node every branch of a gather starts from: the nearest id on
    the first branch's linear path that every other branch's path reaches."""
    paths = [_linear_path(g, d, stop) for d in deps]
    for cand in paths[0]:
        if all(cand in p for p in paths[1:]):
            return cand
    raise TypeError("cannot serve a gather whose branches do not start from one input")


def _to_device(fitted, env: "PipelineEnv"):
    """A fitted transformer read from the disk cache, moved onto the env's
    device (an ``nn.Module``'s parameters and buffers)."""
    if isinstance(fitted, torch.nn.Module):
        return fitted.to(env.device)
    return fitted


class PipelineEnv:
    """Session state: optimizer, executor, persistent caches and the device
    that device stages run on."""

    _instance: Optional["PipelineEnv"] = None

    def __init__(self, device=None):
        from keystone_tpu_torch.config import resolved_cache_dir
        from keystone_tpu_torch.workflow.optimizer import default_optimizer

        self._device = device
        self.optimizer = default_optimizer()
        self.executor = GraphExecutor(self)
        # structural hash of estimator node -> fitted Transformer
        self.fit_cache: Dict[int, Any] = {}
        # structural hash -> persisted value (auto-cache rule / Cacher nodes)
        self.node_cache: Dict[int, Any] = {}
        cache_dir = resolved_cache_dir()
        self.disk_cache = None
        if cache_dir:
            from keystone_tpu_torch.workflow.disk_cache import DiskFitCache

            try:
                self.disk_cache = DiskFitCache(cache_dir)
            except OSError as e:  # uncreatable dir: degrade, never abort
                logger.warning("disk fit cache disabled: cannot create %s (%s)", cache_dir, e)

    @property
    def device(self) -> torch.device:
        """Where device stages run on host data: ``resolve_device`` of the
        device this env was given or ``on_device`` names (``cuda`` unless
        named; it raises without CUDA)."""
        return resolve_device(self._device)

    @contextmanager
    def on_device(self, device):
        """Runs the block's graph walks on ``device`` (None keeps the
        current one), restoring the previous device after."""
        prior = self._device
        if device is not None:
            self._device = device
        try:
            yield self
        finally:
            self._device = prior

    @classmethod
    def get(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    @classmethod
    def reset(cls, device=None) -> None:
        """Drops the session; the next one runs device stages on ``device``
        (``resolve_device`` of it: the card unless named)."""
        cls._instance = None if device is None else PipelineEnv(device)

    def clear_caches(self) -> None:
        """Drop all memoized fits, persisted values, and optimizer-held
        state (frees pinned data)."""
        self.fit_cache.clear()
        self.node_cache.clear()
        for _name, rules, _iters in getattr(self.optimizer, "batches", []):
            for rule in rules:
                clear = getattr(rule, "clear_cache", None)
                if clear is not None:
                    clear()

    def optimize_and_execute(self, graph: Graph, sink: GraphId) -> Any:
        g = self.optimizer.execute(graph, [sink])
        return self.executor.execute(g, sink)

    def execute(self, graph: Graph, sink: GraphId) -> Any:
        return self.executor.execute(graph, sink)


@contextmanager
def on_device(device):
    """``PipelineEnv.get().on_device(device)``: the entry points' way to run
    their graph walks on the device they were given."""
    with PipelineEnv.get().on_device(device) as env:
        yield env
