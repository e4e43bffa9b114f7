"""The solver's products on one device.

Counterpart of the single-device math of
``keystone_tpu/linalg/row_matrix.py``: ``weighted_col_sums`` (``:299-331``)
and ``solver_matmul`` at the ``solver_precision`` default ``"highest"``
(``:32-37``, ``:63-77``). There is one card, so no mesh, row padding or
fold order: a matrix is an (n, d) tensor, and its column sums and
centering are ``A.sum(dim=0)`` and ``A - means``. ``"highest"`` is float32
with TF32 off, which ``resolve_device`` sets on the card; the reference's
``"high"``/``"default"`` and its bfloat16 storage mode are not ported.
"""

from __future__ import annotations

import torch

# The memory a solve may plan for (the reference's config.hbm_budget_bytes):
# it sizes the feature blocks and decides whether their inverses are cached.
HBM_BUDGET_BYTES = 12 * (1 << 30)


def solver_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the solver's precision is float32 with TF32 off; "
            "torch.backends.cuda.matmul.allow_tf32 is on"
        )
    return x @ y


def weighted_col_sums(A: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Σ_i w_i · row_i."""
    return solver_matmul(weights[None, :], A)[0]
