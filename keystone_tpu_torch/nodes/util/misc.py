"""Small utility nodes (counterpart of ``keystone_tpu/nodes/util/misc.py``):
``Identity``, ``Cast``, ``VectorSplitter`` and ``VectorCombiner`` on
tensors; ``Densify`` and ``Sparsify``, host stages between (index → value)
maps and dense float32 numpy rows; ``Cacher``, whose composition persists
the value in the session cache like ``Pipeline.cache()``."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from keystone_tpu_torch.workflow import Transformer


class Identity(Transformer):
    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        return X


class Cacher(Transformer):
    """The reference's Cacher node: composing ``pipeline.and_then(Cacher())``
    persists the value in the session cache exactly like
    ``pipeline.cache()``. Called directly on a batch it is the identity."""

    def to_pipeline(self):
        from keystone_tpu_torch.workflow.cache import CacheOperator
        from keystone_tpu_torch.workflow.graph import Graph, fresh_source_id
        from keystone_tpu_torch.workflow.pipeline import Pipeline

        source = fresh_source_id()
        graph, nid = Graph().add(CacheOperator(), [source])
        return Pipeline(graph, source, nid)

    def apply_batch(self, X):
        return X


class Cast(Transformer):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def apply_batch(self, X):
        return torch.as_tensor(X).to(self.dtype)


class VectorSplitter(Transformer):
    """The feature axis in blocks of ``block_size`` (a list of views)."""

    row_independent = False  # gives a list of blocks, not one batch

    def __init__(self, block_size: int):
        super().__init__()
        self.block_size = block_size

    def apply_batch(self, X) -> List:
        d = X.shape[-1]
        return [X[..., s : min(s + self.block_size, d)] for s in range(0, d, self.block_size)]


class VectorCombiner(Transformer):
    """A list of feature blocks concatenated on the feature axis."""

    row_independent = False  # takes a list of blocks, not one batch

    def apply_batch(self, blocks):
        return torch.cat(list(blocks), dim=-1)


class Densify(Transformer):
    """(index → value) maps, or sequences of (index, value) pairs, → dense
    float32 rows of ``dim`` columns."""

    host_stage = True

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def apply_batch(self, docs):
        out = np.zeros((len(docs), self.dim), dtype=np.float32)
        for i, doc in enumerate(docs):
            items = doc.items() if hasattr(doc, "items") else doc
            for j, v in items:
                j = int(j)
                if not 0 <= j < self.dim:
                    raise ValueError(f"feature index {j} out of range [0, {self.dim})")
                out[i, j] = v
        return out


class Sparsify(Transformer):
    """Dense rows → {index: value} maps of their nonzero entries."""

    host_stage = True

    def apply_batch(self, X):
        X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        return [{int(j): float(X[i, j]) for j in np.flatnonzero(X[i])} for i in range(X.shape[0])]
