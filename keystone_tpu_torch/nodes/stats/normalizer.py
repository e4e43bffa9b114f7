"""Row L2 normalisation (counterpart of keystone_tpu/nodes/stats/normalizer.py)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class L2Normalizer(Transformer):
    def __init__(self, eps: float = 1e-12):
        super().__init__()
        self.eps = eps

    def signature(self):
        return self.stable_signature(self.eps)

    def apply_batch(self, X):
        norm = torch.linalg.vector_norm(X, dim=-1, keepdim=True)
        return X / torch.clamp_min(norm, self.eps)
