"""Pipeline API: Transformer / Estimator / LabelEstimator / Pipeline.

Counterpart of ``keystone_tpu/workflow/pipeline.py``. The algebra is the
reference's:

- ``Transformer`` — a batch-in/batch-out stage, itself composable like a
  one-node pipeline. Here it is an ``nn.Module``; calling one on a batch
  runs it eagerly, calling it on a ``PipelineDataset`` composes lazily.
- ``Estimator.fit(data) -> Transformer``; ``with_data`` splices a lazy fit
  into a graph (``fit_pipeline`` fits at once).
- ``pipeline.and_then(...)`` composes; ``and_then(estimator, data[,
  labels])`` fits the estimator on this pipeline applied to ``data``, when
  the graph runs; ``Pipeline.gather([...])`` merges branches by feature
  concatenation.
- Applying a pipeline is lazy: ``pipeline(X)`` gives a ``PipelineDataset``
  whose ``get()`` optimizes the graph and executes it
  (``workflow/executor.py``); ``fit()`` forces every estimator and gives a
  transformer-only pipeline.

Where the port departs:

- ``host_stage = True`` is the reference's ``jittable = False`` (host
  objects in and out: strings, token lists, term maps, numpy arrays, a
  ``utils/sparse.py::SparseBatch``). Such a stage overrides ``apply`` (one
  datum) or ``apply_batch``; the optimizer never fuses it.
- ``Transformer.batch_call``, what the executor runs for a node, applies a
  device stage in row batches of ``FIT_BATCH`` on the env's device
  (``PipelineEnv.device``): a row-independent stage's output over a large
  input is written batch by batch into one tensor, so a fused chain never
  holds its intermediates for more than one batch.
- ``GatherTransformer`` is a gather of branch chains over one input as
  one module: the optimizer lowers such a ``GatherOperator`` into it, and
  ``serving_chain`` serves it (the reference refuses gathers there).
- ``apply_batches`` lowers the fitted pipeline once to its serving chain
  and streams host batches through it with the pinned-memory double
  buffer of ``utils/staging.py`` (the reference runs a graph walk per
  batch).
- ``fit(profile=True)`` raises: the measured profile store is not ported
  yet.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.loaders.stream import PREFETCH_DEPTH, prefetched
from keystone_tpu_torch.utils.staging import HostStager
from keystone_tpu_torch.workflow.graph import Graph, GraphId, SourceId, fresh_source_id
from keystone_tpu_torch.workflow.operators import (
    DatasetOperator,
    DelegatingOperator,
    EstimatorOperator,
    GatherOperator,
    TransformerOperator,
)

# Rows of data a device stage takes at once when the executor applies it:
# a memory matter only, every such stage being row-independent.
FIT_BATCH = 64


def _env_device() -> torch.device:
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    return PipelineEnv.get().device


def _is_batch(x: Any) -> bool:
    """A numeric array or dense tensor: what a device stage is applied to in
    row batches."""
    if isinstance(x, torch.Tensor):
        return x.layout == torch.strided
    return isinstance(x, np.ndarray) and x.dtype.kind in "biufc"


def _signature_of(t) -> Any:
    sig = getattr(t, "signature", None)
    if sig is not None:
        return sig()
    from keystone_tpu_torch.workflow.fingerprint import UNSTABLE

    return ("t-id", id(t), UNSTABLE)


def _chain_hash_of(t, h_in: int) -> int:
    fn = getattr(t, "chain_hash", None)
    return fn(h_in) if fn is not None else hash((("transformer", _signature_of(t)), (h_in,)))


def _chain_digest_of(t, d_in):
    fn = getattr(t, "chain_digest", None)
    if fn is not None:
        return fn(d_in)
    if d_in is None:
        return None
    from keystone_tpu_torch.workflow.fingerprint import digest_tree

    return digest_tree((("transformer", _signature_of(t)), (d_in,)))


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """A batch-in/batch-out stage. ``row_independent`` says that row i of
    the output depends only on row i of the input and that rows in equal
    rows out: what lets the executor apply it in row batches and the
    serving layer pad a batch up to its bucket. ``host_stage`` marks a
    stage of host objects (module docstring)."""

    row_independent: bool = True
    host_stage: bool = False

    def apply_batch(self, X):
        if not self.host_stage or type(self).apply is nn.Module.apply:
            raise NotImplementedError(f"{type(self).__name__} must override apply_batch() or apply()")
        return [self.apply(x) for x in X]

    def forward(self, X):
        if isinstance(X, PipelineDataset):
            return self.to_pipeline().apply(X)
        return self.apply_batch(X)

    # -- execution ---------------------------------------------------------

    def batch_call(self, X):
        """This stage on one node's input, as the executor runs it: a host
        stage on host objects as they are; a device stage on a numeric
        array or tensor on the env's device (a tensor on a card stays on
        its card), in row batches of ``FIT_BATCH`` when it is row
        independent; anything else (a ``SparseBatch``) as it is."""
        if self.host_stage or not _is_batch(X):
            return self(X)
        if isinstance(X, torch.Tensor) and X.device.type != "cpu":
            device = X.device
        else:
            device = _env_device()
        if self.row_independent and len(X) > FIT_BATCH:
            return self.apply_in_batches(X, device=device)
        return self(torch.as_tensor(X).to(device))

    def apply_in_batches(self, data, batch_size: int = FIT_BATCH, device=None) -> torch.Tensor:
        """This stage applied to ``data`` (a host array or a tensor) in
        batches of ``batch_size`` rows on ``device`` (the env's unless
        named); the outputs are written into one tensor there."""
        device = _env_device() if device is None else resolve_device(device)
        if not self.row_independent:
            raise ValueError("a row-coupled stage cannot be applied in batches")
        n = len(data)
        out = None
        for i in range(0, n, batch_size):
            y = self(torch.as_tensor(data[i : i + batch_size]).to(device))
            if out is None:
                out = torch.empty((n, *y.shape[1:]), dtype=y.dtype, device=device)
            out[i : i + len(y)] = y
        return out

    def apply_batches(self, batches, prefetch_depth: int = PREFETCH_DEPTH, device=None, engine=None):
        """Yields ``(self(X), y)`` on ``device`` (the env's unless named) for
        each ``(X, y)`` (or bare host ``X``, with ``y`` None) of
        ``batches``, in source order. The source runs on a prefetch thread
        ``prefetch_depth`` batches ahead (0: on the caller's) and copies
        each batch into a pinned buffer; the copy of batch b+1 to the card
        then runs while the stage computes on batch b.

        ``engine`` takes a ``workflow.serving.CompiledPipeline`` serving this
        stage: the stream goes to its ``apply_batches``, which keeps up to
        in-flight × replicas batches going across its pool and yields host
        (numpy) outputs."""
        if engine is not None:
            yield from engine.apply_batches(batches, prefetch_depth)
            return
        device = _env_device() if device is None else resolve_device(device)
        stager = HostStager(device, buffers=prefetch_depth + 2)

        def staged():
            for item in batches:
                X, y = item if isinstance(item, tuple) and len(item) == 2 else (item, None)
                X = torch.as_tensor(X)
                if X.device.type != "cpu":
                    raise ValueError(f"apply_batches takes host batches, got one on {X.device}")
                yield stager.fill(X.shape, X.dtype, lambda out: out.copy_(X)), y

        def upload(item):
            return None if item is None else (stager.upload(item[0]), item[1])

        with prefetched(staged(), prefetch_depth) as src:
            try:
                it = iter(src)
                nxt = upload(next(it, None))
                while nxt is not None:
                    cur, y = nxt
                    stager.reclaim()
                    nxt = upload(next(it, None))
                    yield self(stager.ready(cur)), y
            finally:
                stager.close()

    # -- identity ----------------------------------------------------------

    def signature(self) -> Any:
        """Key for structural prefix hashing; object identity by default.

        Deterministic nodes override this with ``stable_signature`` of their
        parameters, or install one on ``self._sig``; the id fallback carries
        the UNSTABLE poison so it never reaches a cross-process digest."""
        sig = getattr(self, "_sig", None)
        if sig is not None:
            return sig
        from keystone_tpu_torch.workflow.fingerprint import UNSTABLE

        return ("t-id", id(self), UNSTABLE)

    def stable_signature(self, *params) -> tuple:
        """Content-based signature: concrete class + constructor params."""
        return (type(self),) + params

    def chain_hash(self, h_in: int) -> int:
        """Prefix hash of applying this transformer to an input with hash
        ``h_in``. FusedTransformer folds so fusion never changes hashes."""
        return hash((("transformer", self.signature()), (h_in,)))

    def chain_digest(self, d_in):
        """Content-stable fold mirroring ``chain_hash`` (None = unstable)."""
        if d_in is None:
            return None
        from keystone_tpu_torch.workflow.fingerprint import digest_tree

        return digest_tree((("transformer", self.signature()), (d_in,)))

    # -- composition sugar -------------------------------------------------

    def to_pipeline(self) -> "Pipeline":
        source = fresh_source_id()
        graph, nid = Graph().add(TransformerOperator(self), [source])
        return Pipeline(graph, source, nid)

    def and_then(self, nxt, *fit_args) -> "Pipeline":
        return self.to_pipeline().and_then(nxt, *fit_args)

    def apply_pipeline(self, data) -> "PipelineDataset":
        return self.to_pipeline().apply(data)


class FusedTransformer(Transformer):
    """A chain of transformers run as one module: what the optimizer's
    chain-fusion rule makes of a chain of device stages, what the serving
    engine captures, and the eager chain of modules wherever code needs
    one."""

    def __init__(self, stages: Sequence[nn.Module]):
        super().__init__()
        flat: List[nn.Module] = []
        for s in stages:
            if isinstance(s, FusedTransformer):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = nn.ModuleList(flat)
        self.row_independent = all(getattr(s, "row_independent", True) for s in flat)
        self.host_stage = bool(flat) and all(getattr(s, "host_stage", False) for s in flat)

    def apply_batch(self, X):
        for s in self.stages:
            X = s(X)
        return X

    def signature(self):
        return ("fused",) + tuple(_signature_of(s) for s in self.stages)

    def chain_hash(self, h_in: int) -> int:
        # Fold stage-by-stage so the fused node's prefix hash equals the
        # unfused chain's: fusion is hash-invariant.
        for s in self.stages:
            h_in = _chain_hash_of(s, h_in)
        return h_in

    def chain_digest(self, d_in):
        for s in self.stages:
            d_in = _chain_digest_of(s, d_in)
        return d_in

    def __repr__(self):
        return "Fused(" + " | ".join(type(s).__name__ for s in self.stages) + ")"


class GatherTransformer(Transformer):
    """Branches over the same input as one module, their outputs
    concatenated on the feature (last) axis: the lowering of a
    ``GatherOperator`` over chains of one input. It hashes and digests as
    the gather node over its branches would, so lowering changes no key."""

    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        self.branches = nn.ModuleList(branches)
        self.row_independent = all(getattr(b, "row_independent", True) for b in self.branches)

    def apply_batch(self, X):
        return torch.cat([b(X) for b in self.branches], dim=-1)

    def signature(self):
        return ("gathered",) + tuple(_signature_of(b) for b in self.branches)

    def chain_hash(self, h_in: int) -> int:
        return hash((("gather",), tuple(_chain_hash_of(b, h_in) for b in self.branches)))

    def chain_digest(self, d_in):
        from keystone_tpu_torch.workflow.fingerprint import digest_tree

        ds = tuple(_chain_digest_of(b, d_in) for b in self.branches)
        if any(d is None for d in ds):
            return None
        return digest_tree((("gather",), ds))


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def _splice_data(graph: Graph, data: Any):
    """Splice data (raw batch or lazy PipelineDataset) into ``graph``.

    Returns (graph, graph_id_producing_the_data).
    """
    if isinstance(data, PipelineDataset):
        return graph.union(data.graph), data.sink
    g, nid = graph.add(DatasetOperator(data), [])
    return g, nid


def _estimator_signature(est) -> tuple:
    """Content signature: class + public hyperparameter fields.

    Fields starting with ``_`` and names in ``_signature_exclude`` (mutable
    outputs like diagnostics set at fit time) are skipped. Values without a
    content identity poison the tree.
    """
    from keystone_tpu_torch.workflow.fingerprint import stable_value

    exclude = set(getattr(est, "_signature_exclude", ()))
    fields = {k: v for k, v in est.__dict__.items() if not k.startswith("_") and k not in exclude}
    return ("est", stable_value(type(est)), stable_value(fields))


class Estimator:
    """``fit(data) -> Transformer``."""

    def signature(self) -> tuple:
        return _estimator_signature(self)

    def fit(self, data) -> nn.Module:
        raise NotImplementedError

    def with_data(self, data) -> "Pipeline":
        """A pipeline that lazily fits this estimator on ``data`` and applies
        the fitted transformer to the pipeline input (Estimator.withData)."""
        graph = Graph()
        graph, data_id = _splice_data(graph, data)
        graph, est_id = graph.add(EstimatorOperator(self), [data_id])
        source = fresh_source_id()
        graph, out_id = graph.add(DelegatingOperator(), [est_id, source])
        return Pipeline(graph, source, out_id)

    def fit_pipeline(self, data) -> "Pipeline":
        """Eagerly fit and return the fitted transformer as a pipeline."""
        return self.fit(_force(data)).to_pipeline()


class LabelEstimator:
    """``fit(data, labels) -> Transformer``."""

    def signature(self) -> tuple:
        return _estimator_signature(self)

    def fit(self, data, labels) -> nn.Module:
        raise NotImplementedError

    def with_data(self, data, labels) -> "Pipeline":
        graph = Graph()
        graph, data_id = _splice_data(graph, data)
        graph, labels_id = _splice_data(graph, labels)
        graph, est_id = graph.add(EstimatorOperator(self), [data_id, labels_id])
        source = fresh_source_id()
        graph, out_id = graph.add(DelegatingOperator(), [est_id, source])
        return Pipeline(graph, source, out_id)

    def fit_pipeline(self, data, labels) -> "Pipeline":
        """Eagerly fit and return the fitted transformer as a pipeline."""
        return self.fit(_force(data), _force(labels)).to_pipeline()


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class Pipeline:
    """A lazily-constructed dataflow from one source to one sink."""

    def __init__(self, graph: Graph, source: SourceId, sink: GraphId):
        self.graph = graph
        self.source = source
        self.sink = sink

    # -- composition -------------------------------------------------------

    @staticmethod
    def _coerce(obj) -> "Pipeline":
        if isinstance(obj, Pipeline):
            return obj
        if isinstance(obj, Transformer):
            return obj.to_pipeline()
        raise TypeError(f"cannot compose with {type(obj).__name__}")

    def and_then(self, nxt, *fit_args) -> "Pipeline":
        """``pipeline.and_then(transformer_or_pipeline)``, or
        ``pipeline.and_then(estimator, data[, labels])`` which fits the
        estimator on this pipeline applied to ``data``."""
        if isinstance(nxt, (Estimator, LabelEstimator)):
            return self._and_then_fit(nxt, *fit_args)
        if fit_args:
            raise TypeError("fit data only valid when composing an estimator")
        nxt = Pipeline._coerce(nxt)
        merged = self.graph.union(nxt.graph)
        merged, (new_sink,) = merged.instantiate([nxt.sink], {nxt.source: self.sink})
        return Pipeline(merged.pruned([new_sink]), self.source, new_sink)

    def _and_then_fit(self, est, data, labels=None) -> "Pipeline":
        if labels is None and not isinstance(est, Estimator):
            raise TypeError("LabelEstimator requires labels")
        if labels is not None and not isinstance(est, LabelEstimator):
            raise TypeError("labels are only valid for a LabelEstimator")
        features = self.apply(data)
        tail = est.with_data(features) if labels is None else est.with_data(features, labels)
        return self.and_then(tail)

    @staticmethod
    def gather(branches: Sequence[Union["Pipeline", Transformer]]) -> "Pipeline":
        """Merge parallel branches over the same input by concatenating their
        outputs on the feature axis (Pipeline.gather)."""
        branches = [Pipeline._coerce(b) for b in branches]
        source = fresh_source_id()
        merged = Graph()
        sinks: List[GraphId] = []
        for b in branches:
            merged = merged.union(b.graph)
            merged, (s,) = merged.instantiate([b.sink], {b.source: source})
            sinks.append(s)
        merged, out = merged.add(GatherOperator(), sinks)
        return Pipeline(merged.pruned([out]), source, out)

    def cache(self) -> "Pipeline":
        """Mark this pipeline's output for session-cache persistence (the
        explicit Cacher; the auto-cache rule inserts these automatically)."""
        from keystone_tpu_torch.workflow.cache import CacheOperator

        graph, nid = self.graph.add(CacheOperator(), [self.sink])
        return Pipeline(graph, self.source, nid)

    # -- application -------------------------------------------------------

    def apply(self, data) -> "PipelineDataset":
        """Lazily apply to a batch (array / tensor / host sequence /
        PipelineDataset)."""
        if isinstance(data, PipelineDataset):
            merged = self.graph.union(data.graph)
            merged, (sink,) = merged.instantiate([self.sink], {self.source: data.sink})
            return PipelineDataset(merged.pruned([sink]), sink)
        graph, data_id = self.graph.add(DatasetOperator(data), [])
        graph, (sink,) = graph.instantiate([self.sink], {self.source: data_id})
        return PipelineDataset(graph.pruned([sink]), sink)

    def __call__(self, data) -> "PipelineDataset":
        return self.apply(data)

    def serving_chain(self) -> nn.Module:
        """This pipeline fitted and lowered to the one module its inference
        path runs (``GraphExecutor.serving_chain``)."""
        from keystone_tpu_torch.workflow.executor import PipelineEnv

        fitted = self.fit()
        return PipelineEnv.get().executor.serving_chain(fitted.graph, fitted.source, fitted.sink)

    def apply_batches(self, batches, prefetch_depth: int = PREFETCH_DEPTH, engine=None):
        """Streams ``(X, y)`` host batches (or bare ``X``) through the
        pipeline, yielding ``(output, y)`` in source order on the env's
        device. The pipeline is fitted and lowered once to its serving
        chain, which then runs on each batch as it is staged through pinned
        memory (``Transformer.apply_batches``); with ``engine`` (a
        ``CompiledPipeline``) the batches go through its replica pool."""
        if engine is not None:
            yield from engine.apply_batches(batches, prefetch_depth)
            return
        yield from self.serving_chain().apply_batches(batches, prefetch_depth)

    def apply_datum(self, datum) -> Any:
        """Apply to a single datum, eagerly: lifted to a one-element batch
        (a leading axis on an array or tensor, a one-item list otherwise),
        then unwrapped."""
        from keystone_tpu_torch.workflow.executor import PipelineEnv

        if isinstance(datum, (np.ndarray, torch.Tensor)):
            batch: Any = datum[None, ...]
        elif isinstance(datum, (int, float, np.number)):
            batch = np.asarray([datum])
        else:
            batch = [datum]
        env = PipelineEnv.get()
        ds = self.apply(batch)
        fitted_graph = env.executor.fit_estimators(ds.graph, ds.sink)
        out = env.execute(fitted_graph, ds.sink)
        return out[0]

    # -- fitting -----------------------------------------------------------

    def fit(self, profile: Optional[bool] = None) -> "Pipeline":
        """Force every estimator in the graph and return a transformer-only
        pipeline (the reference's fitted pipeline). ``profile=True`` raises:
        the measured profile store it writes to comes with
        ``workflow/profile_store.py``, not yet ported."""
        if profile:
            raise NotImplementedError(
                "Pipeline.fit(profile=True) needs the measured profile store "
                "(workflow/profile_store.py, FitProfile), not yet ported: ROADMAP Queue 1 item 3"
            )
        from keystone_tpu_torch.workflow.executor import PipelineEnv

        graph = PipelineEnv.get().executor.fit_estimators(self.graph, self.sink)
        return Pipeline(graph, self.source, self.sink)

    def compiled(self, buckets=None, max_batch=None, devices=None, inflight=None):
        """Fit (if needed) and lower to a shape-stable serving engine,
        ``workflow.serving.CompiledPipeline``; call its ``warmup()`` with
        the traffic's feature shape to build every bucket on every replica
        before traffic."""
        from keystone_tpu_torch.workflow.serving import CompiledPipeline

        return CompiledPipeline(self, buckets=buckets, max_batch=max_batch, devices=devices,
                                inflight=inflight)

    # -- introspection -----------------------------------------------------

    def transformers(self) -> List[nn.Module]:
        """Transformer chain in topological order (fitted pipelines only)."""
        out = []
        for nid in self.graph.reachable([self.sink]):
            op = self.graph.operators[nid]
            if isinstance(op, TransformerOperator):
                out.append(op.transformer)
        return out

    def describe(self) -> str:
        lines = []
        for nid in self.graph.reachable([self.sink]):
            op = self.graph.operators[nid]
            deps = ", ".join(map(repr, self.graph.dependencies[nid]))
            lines.append(f"{nid!r}: {op.label()} <- [{deps}]")
        return "\n".join(lines)

    def to_dot(self) -> str:
        """Graphviz DOT source of the DAG. Render with ``dot -Tpng``;
        sources are diamonds, the sink is bold."""
        lines = ["digraph pipeline {", "  rankdir=LR;"]
        seen_srcs = set()
        for nid in self.graph.reachable([self.sink]):
            op = self.graph.operators[nid]
            style = " style=bold" if nid == self.sink else ""
            lines.append(f'  "{nid!r}" [label="{op.label()}"{style}];')
            for dep in self.graph.dependencies[nid]:
                if isinstance(dep, SourceId) and dep not in seen_srcs:
                    seen_srcs.add(dep)
                    lines.append(f'  "{dep!r}" [label="input" shape=diamond];')
                lines.append(f'  "{dep!r}" -> "{nid!r}";')
        lines.append("}")
        return "\n".join(lines)


class PipelineDataset:
    """Lazy handle to the result of applying a pipeline to a batch.
    ``get()`` triggers optimization + execution (memoized)."""

    def __init__(self, graph: Graph, sink: GraphId):
        self.graph = graph
        self.sink = sink
        self._value: Any = None
        self._computed = False

    def get(self) -> Any:
        if not self._computed:
            from keystone_tpu_torch.workflow.executor import PipelineEnv

            self._value = PipelineEnv.get().optimize_and_execute(self.graph, self.sink)
            self._computed = True
        return self._value


def _force(data):
    return data.get() if isinstance(data, PipelineDataset) else data
