"""Replay a fitted pipeline's optimized graph as one pure function.

Counterpart of ``keystone_tpu/workflow/functional.py``. A fitted pipeline
is transformer-only, so its optimized graph can be re-executed eagerly
over an argument: ``fitted_forward`` builds and optimizes the graph once
on an example and returns ``fn(X)``, which runs each node's transformer
on whole batches (no row batching) and joins gathers with ``torch.cat``.
The reference's ``layout`` (a mesh's row sharding) has no counterpart on
one device.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.operators import DatasetOperator, GatherOperator, TransformerOperator


def fitted_forward(pipeline, example):
    """``fn(X)`` replaying ``pipeline``'s optimized transformer graph over
    the argument. ``pipeline`` must be fitted (transformer-only);
    ``example`` is a small batch used once to build and optimize the graph
    (chain fusion, node merging)."""
    ds = pipeline(example)
    g = PipelineEnv.get().optimizer.execute(ds.graph, [ds.sink])
    order = g.reachable([ds.sink])

    def fn(X):
        values = {}
        for nid in order:
            op = g.operators[nid]
            deps = g.dependencies[nid]
            if isinstance(op, DatasetOperator):
                values[nid] = X
            elif isinstance(op, TransformerOperator):
                values[nid] = op.transformer(values[deps[0]])
            elif isinstance(op, GatherOperator):
                values[nid] = torch.cat([values[d] for d in deps], dim=-1)
            elif getattr(op, "persist", False):
                values[nid] = values[deps[0]]
            else:
                raise TypeError(f"unexpected op in fitted graph: {op!r}")
        return values[ds.sink]

    return fn
