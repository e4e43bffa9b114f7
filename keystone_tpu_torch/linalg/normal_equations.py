"""Ridge least squares through the normal equations, on one device.

Counterpart of the single-device math of
``keystone_tpu/linalg/normal_equations.py``: ``_chol_solve`` (:35-46) and
``solve_least_squares_normal`` (:49-58). The port has no ``RowMatrix``, so
A and B are (n, d) and (n, k) tensors, and AᵀA and AᵀB are
``row_matrix.solver_matmul`` products at the solver's precision (A may be
stored in bfloat16; the products are float32). The Cholesky solve and its
refinement step run in float32 with TF32 off. The chunked solve and its
checkpointer (:432-656) need the mesh and the stream, and are not ported.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import solver_precision
from keystone_tpu_torch.linalg.row_matrix import solver_matmul


def _chol_solve(gram: torch.Tensor, atb: torch.Tensor, lam: float, refine_steps: int = 1) -> torch.Tensor:
    """W with (gram + lam·I) W = atb: a Cholesky solve, then
    ``refine_steps`` steps of iterative refinement, each with its residual
    computed at full float32 precision, which remove most of the
    factorization's rounding."""
    reg = gram + lam * torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    L = torch.linalg.cholesky(reg)
    W = torch.cholesky_solve(atb, L)
    for _ in range(refine_steps):
        W = W + torch.cholesky_solve(atb - solver_matmul(reg, W, "highest"), L)
    return W


def solve_least_squares_normal(A: torch.Tensor, B: torch.Tensor, lam: float = 0.0,
                               refine_steps: int = 1) -> torch.Tensor:
    """argmin_W ‖AW − B‖² + lam‖W‖², a (d, k) float32 tensor on A's device;
    the products at ``config.solver_precision()``."""
    precision = solver_precision()
    gram = solver_matmul(A.T, A, precision)
    atb = solver_matmul(A.T, B, precision)
    return _chol_solve(gram, atb, lam, refine_steps)
