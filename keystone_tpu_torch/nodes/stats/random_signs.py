"""Random sign flips (counterpart of
``keystone_tpu/nodes/stats/random_signs.py::RandomSignNode``, :16): each
row multiplied elementwise by a fixed ±1 vector.

The reference draws its signs with ``jax.random.rademacher``, which the
port does not reproduce: ``create`` draws them from a ``torch.Generator``
(seeded with ``seed`` unless one is given), so a port pipeline and a JAX
pipeline built from the same seed hold different signs. A JAX node's signs
come across as an array (``convert.py::random_sign_nodes``).
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.config import default_dtype, resolve_device
from keystone_tpu_torch.workflow import Transformer


class RandomSignNode(Transformer):
    def __init__(self, signs, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("signs", torch.as_tensor(signs, dtype=default_dtype, device=device))

    @classmethod
    def create(cls, dim: int, seed: int = 0, generator: Optional[torch.Generator] = None,
               device=None) -> "RandomSignNode":
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        signs = 2.0 * torch.randint(0, 2, (dim,), generator=g).to(default_dtype) - 1.0
        return cls(signs, device=device)

    def apply_batch(self, X):
        return X * self.signs
