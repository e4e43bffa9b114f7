"""Signed square root, the Fisher-vector normalisation step (counterpart of
keystone_tpu/nodes/stats/hellinger.py)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class SignedHellingerMapper(Transformer):
    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        return torch.sign(X) * torch.sqrt(torch.abs(X))
