"""Block coordinate descent over feature blocks, on one device.

Counterpart of ``keystone_tpu/linalg/bcd.py::block_coordinate_descent``
(``:485-620``) with the math of ``_local_ridge_gram`` (``:54-64``),
``_batched_spd_inv`` (``:160-206``) and ``_local_solve_update``
(``:82-90``). It solves

    min_W  Σ_i w_i ‖(A W − B)_i‖² + λ ‖W‖²

(w_i = 1 without row weights) block by block, with a Python loop over
epochs and blocks. Visiting block b:

    R⁺ = R + A_b W_b;   W_b = (A_bᵀ diag(w) A_b + λI)⁻¹ A_bᵀ diag(w) R⁺;   R = R⁺ − A_b W_b

The ridge gram is epoch-invariant. With ``cache_grams`` (the reference's
auto rule: more than one epoch, and the inverses within a quarter of the
memory budget) each block's inverse is formed once, before the first epoch,
by ``torch.linalg.cholesky`` and ``torch.cholesky_inverse`` batched over
the blocks of equal width; an epoch is then gemms only. Without it each
visit factors its gram again and solves with ``torch.cholesky_solve``.
These are library calls, as the reference leaves them to XLA. Its TPU
workarounds (chunked triangular solves, the fused ``lax.scan`` programs,
donation, mesh folds, checkpoints) have no counterpart here.

An active ``StageTimer`` gets the "BCD factor phase" and each "BCD epoch"
as stages, and the objective after each epoch as a note.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from keystone_tpu_torch.linalg.row_matrix import HBM_BUDGET_BYTES, solver_matmul
from keystone_tpu_torch.utils.stages import mark, note


def ridge_gram(a_b: torch.Tensor, aw: torch.Tensor, lam: float) -> torch.Tensor:
    """(A_b·w)ᵀ A_b + λI."""
    gram = solver_matmul(aw.T, a_b)
    gram.diagonal().add_(lam)
    return gram


def spd_inverse(grams: torch.Tensor) -> torch.Tensor:
    """Inverse of each SPD matrix of a (…, b, b) stack, through its
    Cholesky factor."""
    return torch.cholesky_inverse(torch.linalg.cholesky(grams))


def _weighted(a_b, row_weights):
    return a_b if row_weights is None else a_b * row_weights[:, None]


def objective(R: torch.Tensor, W: List[torch.Tensor], lam: float, row_weights=None):
    """Σ_i w_i ‖R_i‖² + λ‖W‖² as a 0-d tensor, for the residual R = B − A W."""
    rr = (R * R).sum(dim=1)
    data = rr.sum() if row_weights is None else (row_weights * rr).sum()
    return data + lam * sum((w * w).sum() for w in W)


def block_coordinate_descent(
    A: torch.Tensor,
    B: torch.Tensor,
    block_size: int,
    num_iters: int,
    lam: float = 0.0,
    row_weights: Optional[torch.Tensor] = None,
    cache_grams: Optional[bool] = None,
) -> Tuple[List[torch.Tensor], List[Tuple[int, int]]]:
    """Returns (per-block weights, block column ranges). ``A`` (n, d) and
    ``B`` (n, k) are float32 on one device; ``A`` is only read (its column
    blocks are views)."""
    n, d = A.shape
    k = B.shape[1]
    if B.shape[0] != n:
        raise ValueError(f"A has {n} rows, B {B.shape[0]}")
    blocks = [(s, min(s + block_size, d)) for s in range(0, d, block_size)]
    if cache_grams is None:
        factor_bytes = sum((e - s) ** 2 for s, e in blocks) * A.element_size()
        cache_grams = num_iters > 1 and factor_bytes < HBM_BUDGET_BYTES // 4
    W = [A.new_zeros((e - s, k)) for s, e in blocks]
    R = B.clone()

    invs = None
    if cache_grams and num_iters > 0:
        invs = []
        # Equal-width blocks are factored as one batch; a ragged last block
        # on its own.
        for width in sorted({e - s for s, e in blocks}, reverse=True):
            idx = [i for i, (s, e) in enumerate(blocks) if e - s == width]
            grams = A.new_empty((len(idx), width, width))
            for j, i in enumerate(idx):
                a_b = A[:, blocks[i][0]:blocks[i][1]]
                grams[j] = ridge_gram(a_b, _weighted(a_b, row_weights), lam)
            invs.extend(zip(idx, spd_inverse(grams)))
            del grams
        invs = [inv for _, inv in sorted(invs, key=lambda t: t[0])]
        mark("BCD factor phase")

    for epoch in range(num_iters):
        for i, (s, e) in enumerate(blocks):
            a_b = A[:, s:e]
            aw = _weighted(a_b, row_weights)
            r_plus = R + solver_matmul(a_b, W[i])
            rhs = solver_matmul(aw.T, r_plus)
            if invs is not None:
                W[i] = solver_matmul(invs[i], rhs)
            else:
                W[i] = torch.cholesky_solve(rhs, torch.linalg.cholesky(ridge_gram(a_b, aw, lam)))
            R = r_plus - solver_matmul(a_b, W[i])
        mark(f"BCD epoch {epoch + 1}")
        note(f"objective after epoch {epoch + 1}",
             lambda: objective(R, W, lam, row_weights))
    return W, blocks
