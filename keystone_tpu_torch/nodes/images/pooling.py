"""Spatial pooling and the symmetric rectifier (counterpart of
``keystone_tpu/nodes/images/pooling.py``: ``SymmetricRectifier`` :18,
``Pooler`` :32). Batches are NHWC; pooling windows are VALID."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class SymmetricRectifier(Transformer):
    """Doubles the channels: ``[max(X − α, m) | max(−X − α, m)]``."""

    def __init__(self, alpha: float = 0.0, max_val: float = 0.0):
        super().__init__()
        self.alpha = alpha
        self.max_val = max_val

    def signature(self):
        return self.stable_signature(self.alpha, self.max_val)

    def apply_batch(self, X):
        pos = torch.clamp_min(X - self.alpha, self.max_val)
        neg = torch.clamp_min(-X - self.alpha, self.max_val)
        return torch.cat([pos, neg], dim=-1)


class Pooler(Transformer):
    """``pool_size`` × ``pool_size`` windows at ``stride``; ``mode`` is
    ``sum`` (the CIFAR features), ``mean`` or ``max``."""

    def __init__(self, stride: int, pool_size: int, mode: str = "sum"):
        super().__init__()
        if mode not in ("sum", "mean", "max"):
            raise ValueError(f"unknown pooling mode {mode!r}")
        self.stride = stride
        self.pool_size = pool_size
        self.mode = mode

    def signature(self):
        return self.stable_signature(self.stride, self.pool_size, self.mode)

    def apply_batch(self, X):
        p, s = self.pool_size, self.stride
        wins = X.unfold(1, p, s).unfold(2, p, s)  # (n, out_h, out_w, c, p, p)
        if self.mode == "max":
            return wins.amax(dim=(-2, -1))
        out = wins.sum(dim=(-2, -1))
        return out / (p * p) if self.mode == "mean" else out
