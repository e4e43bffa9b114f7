"""The solver's products on one device.

Counterpart of the single-device math of
``keystone_tpu/linalg/row_matrix.py``: ``storage_dtype`` (``:39-41``),
``solver_matmul`` with its precisions (``:32-37``, ``:63-77``) and
``weighted_col_sums`` (``:299-331``). There is one card, so no mesh, row
padding or fold order: a matrix is an (n, d) tensor, and its column sums
and centering are ``A.sum(dim=0)`` and ``A - means``.

Precisions map as XLA maps them on a GPU: ``highest`` is float32 with TF32
off, which ``resolve_device`` sets on the card; ``high`` and ``default``
are TF32, switched on around each float32 product of the solver and back
off after it, so that nothing else (SIFT, PCA, the head) runs in TF32. On
the CPU every precision gives the float32 product, as JAX's CPU backend
does.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

# HBM_BUDGET_BYTES: the solvers read the memory budget from here.
from keystone_tpu_torch.config import HBM_BUDGET_BYTES, solver_storage_dtype  # noqa: F401


def storage_dtype(dtype: Optional[str] = None) -> torch.dtype:
    """The torch dtype of ``solver_storage_dtype(dtype)``."""
    return getattr(torch, solver_storage_dtype(dtype))


@contextmanager
def tf32_matmuls():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def solver_matmul(x: torch.Tensor, y: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``x @ y`` (2-D) in float32. When either operand is bfloat16 (the
    storage mode), both are rounded to bfloat16 and multiplied into a
    float32 result; else at ``precision``."""
    if x.dtype == torch.bfloat16 or y.dtype == torch.bfloat16:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        if x.is_cuda:
            return torch.mm(x, y, out_dtype=torch.float32)
        # The CPU has no bfloat16 product into float32. A product of two
        # bfloat16 values is exact in float32, so the upcast does the same
        # arithmetic.
        return x.float() @ y.float()
    if not x.is_cuda:
        return x @ y
    if precision == "highest":
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the solver's precision is highest (float32, TF32 off); "
                "torch.backends.cuda.matmul.allow_tf32 is on"
            )
        return x @ y
    with tf32_matmuls():
        return x @ y


def weighted_col_sums(A: torch.Tensor, weights: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Σ_i w_i · row_i."""
    return solver_matmul(weights[None, :], A, precision)[0]
