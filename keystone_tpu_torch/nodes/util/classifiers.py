"""Prediction post-processing (counterpart of
keystone_tpu/nodes/util/classifiers.py: ``MaxClassifier`` :15 and
``TopKClassifier``)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class MaxClassifier(Transformer):
    """The index of the largest score, as int32 (the first on a tie, as
    ``jnp.argmax``)."""

    def signature(self):
        return self.stable_signature()

    def apply_batch(self, scores):
        return torch.argmax(scores, dim=-1).to(torch.int32)


class TopKClassifier(Transformer):
    """Indices of the k largest scores, best first, as int32. Ties may
    break in another order than ``jax.lax.top_k`` (lower index first)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def signature(self):
        return self.stable_signature(self.k)

    def apply_batch(self, scores):
        return torch.topk(scores, self.k, dim=-1, largest=True, sorted=True).indices.to(
            torch.int32
        )
