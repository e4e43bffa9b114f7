"""A lean serial pipeline core.

Counterpart of ``keystone_tpu/workflow/pipeline.py`` (``Transformer``,
``Estimator``, ``LabelEstimator``, ``Pipeline.and_then``,
``Pipeline.gather``) and of ``workflow/operators.py::GatherOperator``,
without the graph optimizer, caches, executor pool or sharding: a pipeline
here is a list of ``nn.Module`` stages applied in order, and a gather runs
its branches on the same input and concatenates their outputs on the last
axis. ``and_then(estimator, data[, labels])`` fits eagerly: it applies the
pipeline to ``data`` in batches, fits the estimator on the result and
appends what it fitted.

Host stages (``host_stage = True``; the reference's ``jittable = False``,
``:79-96``) take and return host objects: strings, token lists, term maps,
numpy arrays or a ``utils/sparse.py::SparseBatch``. Their ``apply`` works on
one datum and ``apply_batch`` defaults to a list of ``apply`` over the
batch. A pipeline of host stages only is itself one; ``and_then`` applies
it to the whole of the fit data at once and gives the estimator what it
returns, and the labels as they came. ``Estimator.with_data`` and
``LabelEstimator.with_data`` (``:425-460``) fit at once and give a
pipeline of the fitted stage. ``apply_batches`` streams row batches through a
stage, reading them on a prefetch thread and staging them through pinned
memory (``workflow/pipeline.py::Pipeline.apply_batches``, ``:551-601``), or
with ``engine=`` through a serving engine's replica pool.
``Pipeline.compiled`` gives that engine (``:869-896``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.loaders.stream import PREFETCH_DEPTH, prefetched
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.utils.staging import HostStager

# Rows of fit data a pipeline prefix takes at once: a memory matter only,
# every stage being row-independent where a prefix is applied in batches.
FIT_BATCH = 64


class Estimator:
    """``fit(data) -> Transformer``."""

    def fit(self, data) -> nn.Module:
        raise NotImplementedError

    def with_data(self, data) -> "Pipeline":
        """A pipeline of this estimator fitted on ``data``."""
        return Pipeline([self.fit(data)])


class LabelEstimator:
    """``fit(data, labels) -> Transformer``."""

    def fit(self, data, labels) -> nn.Module:
        raise NotImplementedError

    def with_data(self, data, labels) -> "Pipeline":
        """A pipeline of this estimator fitted on ``data`` and ``labels``."""
        return Pipeline([self.fit(data, labels)])


class Transformer(nn.Module):
    """A batch-in/batch-out stage. ``row_independent`` says that row i of
    the output depends only on row i of the input, which is what lets the
    serving layer pad a batch up to its bucket and slice the padding off.
    ``host_stage`` marks a stage of host objects (module docstring); such a
    stage overrides ``apply`` (one datum) or ``apply_batch``."""

    row_independent: bool = True
    host_stage: bool = False

    def apply_batch(self, X):
        if not self.host_stage or type(self).apply is nn.Module.apply:
            raise NotImplementedError(f"{type(self).__name__} must override apply_batch() or apply()")
        return [self.apply(x) for x in X]

    def forward(self, X):
        return self.apply_batch(X)

    def and_then(self, nxt, *fit_args, **fit_kwargs) -> "Pipeline":
        return Pipeline([self]).and_then(nxt, *fit_args, **fit_kwargs)

    def apply_in_batches(self, data, batch_size: int = FIT_BATCH, device=None) -> torch.Tensor:
        """This stage applied to ``data`` (a host array or a tensor) in
        batches of ``batch_size`` rows on ``device``; the outputs are
        written into one tensor there."""
        device = resolve_device(device)
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
        """Yields ``(self(X), y)`` on ``device`` for each ``(X, y)`` (or bare
        host ``X``, with ``y`` None) of ``batches``, in source order. The
        source runs on a prefetch thread ``prefetch_depth`` batches ahead
        (0: on the caller's) and copies each batch into a pinned buffer; the
        copy of batch b+1 to the card then runs while the stage computes on
        batch b.

        ``engine`` takes a ``workflow.serving.CompiledPipeline`` serving this
        stage (``Pipeline.compiled()``): the stream goes to its
        ``apply_batches``, which keeps up to in-flight × replicas batches
        going across its pool and yields host (numpy) outputs."""
        if engine is not None:
            yield from engine.apply_batches(batches, prefetch_depth)
            return
        device = resolve_device(device)
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


class Pipeline(Transformer):
    """Stages applied in order."""

    def __init__(self, stages: Sequence[nn.Module]):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.row_independent = all(
            getattr(s, "row_independent", True) for s in self.stages
        )
        self.host_stage = len(self.stages) > 0 and all(
            getattr(s, "host_stage", False) for s in self.stages
        )

    def apply_batch(self, X):
        for stage in self.stages:
            X = stage(X)
        return X

    def and_then(self, nxt, data=None, labels=None, *, device=None) -> "Pipeline":
        """``and_then(module)`` appends a fitted stage.
        ``and_then(estimator, data[, labels])`` fits the estimator on this
        pipeline applied to ``data`` (in batches on ``device``; a pipeline
        of host stages to all of ``data`` at once) and appends the fitted
        stage."""
        if isinstance(nxt, (Estimator, LabelEstimator)):
            if data is None:
                raise TypeError("fitting an estimator needs its data")
            if isinstance(nxt, LabelEstimator) != (labels is not None):
                raise TypeError("labels go with a LabelEstimator, and only with one")
            if self.host_stage:
                features = self(data)
                mark("apply the host prefix to the fit data")
                nxt = nxt.fit(features) if labels is None else nxt.fit(features, labels)
                return Pipeline([*self.stages, nxt])
            device = resolve_device(device)
            features = self.apply_in_batches(data, device=device)
            mark("apply the prefix to the fit data")
            if labels is None:
                nxt = nxt.fit(features)
            else:
                nxt = nxt.fit(features, torch.as_tensor(labels).to(device))
        elif data is not None or labels is not None:
            raise TypeError("fit data only goes with an estimator")
        return Pipeline([*self.stages, nxt])

    def compiled(self, buckets=None, max_batch=None, devices=None, inflight=None):
        """This pipeline as a shape-stable serving engine,
        ``workflow.serving.CompiledPipeline``; call its ``warmup()`` with
        the traffic's feature shape to build every bucket on every replica
        (``devices``; every local CUDA device by default) before traffic."""
        from keystone_tpu_torch.workflow.serving import CompiledPipeline

        return CompiledPipeline(self, buckets=buckets, max_batch=max_batch, devices=devices,
                                inflight=inflight)

    @staticmethod
    def gather(branches: Sequence[nn.Module]) -> "Pipeline":
        """Branches over the same input, outputs concatenated on the
        feature (last) axis."""
        return Pipeline([Gather(branches)])


class Gather(Transformer):
    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        self.branches = nn.ModuleList(branches)
        self.row_independent = all(
            getattr(b, "row_independent", True) for b in self.branches
        )

    def apply_batch(self, X):
        return torch.cat([b(X) for b in self.branches], dim=-1)
