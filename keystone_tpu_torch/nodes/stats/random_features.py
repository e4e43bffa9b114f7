"""Random Fourier features, ``cos(X W + b)`` (counterpart of
``keystone_tpu/nodes/stats/random_features.py``): W (d, D) Gaussian (the RBF
kernel) or Cauchy (the Laplacian kernel), scaled by ``gamma``, and b uniform
on [0, 2π). The product is one float32 gemm (TF32 off, as
``resolve_device`` leaves cuBLAS), as the reference leaves it to XLA.

``jax.random`` cannot be reproduced in torch, so ``create`` draws W and then
b from a ``torch.Generator`` seeded with ``seed``: a
port node and a JAX node made from one seed hold different W and b. A JAX
node's W and b come across as arrays (``convert.py``).
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch.config import default_dtype, resolve_device
from keystone_tpu_torch.workflow import Transformer


class CosineRandomFeatures(Transformer):
    def __init__(self, W, b, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("W", torch.as_tensor(W, dtype=default_dtype, device=device))
        self.register_buffer("b", torch.as_tensor(b, dtype=default_dtype, device=device))

    @classmethod
    def create(cls, input_dim: int, num_features: int, gamma: float = 1.0,
               distribution: str = "gaussian", seed: int = 0, device=None) -> "CosineRandomFeatures":
        g = torch.Generator().manual_seed(seed)
        W = torch.empty((input_dim, num_features), dtype=default_dtype)
        if distribution == "gaussian":
            W.normal_(generator=g)
        elif distribution == "cauchy":
            W.cauchy_(generator=g)
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        b = torch.rand((num_features,), generator=g, dtype=default_dtype) * (2 * math.pi)
        return cls(W * gamma, b, device=device)

    def apply_batch(self, X):
        return torch.cos(X @ self.W + self.b)
