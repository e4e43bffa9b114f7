"""Kernel ridge regression on one device, by conjugate gradient with the
kernel's rows made on the fly (counterpart of
keystone_tpu/nodes/learning/kernel_ridge.py).

The operator is the reference's ``_kernel_matvec`` (:55-78): ``(K + λI)v``
with ``K = exp(−γ·pairwise_sq_dists(X, X))``. The reference takes K's rows a
device's row shard at a time; here they come in chunks of at most
``config.kernel_block_bytes`` (``_chunk_rows``), so the n×n matrix is never
formed. Nothing is padded on one device, so no mask is needed. Both solvers
call the one ``_kernel_matvec``.

``_cg`` and ``_pcg`` follow the reference's ``_cg_fn`` (:81-113) and
``_pcg_fn`` (:117-225) step for step: x0 = 0, the same ``max(·, 1e-30)``
guards, and the same stopping rule, ``rs > tol²`` and ``i < max_iters``,
``rs`` compared in float32 as the reference's loop compares it. Nyström PCG
draws its landmarks with ``np.random.default_rng(seed).choice(n, m,
replace=False)``, sorted; ``W = k(L, L)`` is factored as ``cholesky(W +
1e-5·I)``; the whitened ``B = C·L⁻ᵀ`` comes from ``solve_triangular``; and
``G = BᵀB + (λ + 1e-6·trace(BᵀB)/m)·I`` is applied through
``cholesky_solve``, never as an explicit inverse (the reference's NOTE at
:165-172: an explicit float32 inverse of the whitened Nyström G breaks
PCG's symmetry until CG diverges). One departure: G and the
preconditioner's application are computed in float64 (``_pcg``), since
in float32 the Woodbury form loses positive definiteness when λ is small
against BᵀB's top eigenvalue, and PCG breaks down into NaN.

The reference's loop is an XLA while-loop; here it is a Python loop on the
data's device. Its stop test reads ``rs`` on the host, one sync per
iteration, which is small beside an iteration's whole n×n×d pass.
"""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.config import as_input, config, default_dtype, resolve_device
from keystone_tpu_torch.nodes.learning.kernels import GaussianKernelGenerator, KernelGenerator
from keystone_tpu_torch.workflow import LabelEstimator, Transformer


class KernelBlockLinearMapper(Transformer):
    """scores(x) = k(x, X_train) @ α, summed over blocks of ``block_size``
    training rows, so the test-kernel block never exceeds (batch, block)."""

    def __init__(self, kernel: KernelGenerator, X_train, alpha, block_size: int = 4096, device=None):
        super().__init__()
        device = resolve_device(device)
        self.kernel = kernel
        self.register_buffer("X_train", torch.as_tensor(X_train, dtype=default_dtype, device=device))
        self.register_buffer("alpha", torch.as_tensor(alpha, dtype=default_dtype, device=device))
        self.block_size = block_size

    def apply_batch(self, X):
        n = self.X_train.shape[0]
        out = None
        for s in range(0, n, self.block_size):
            e = min(s + self.block_size, n)
            contrib = self.kernel.block(X, self.X_train[s:e]) @ self.alpha[s:e]
            out = contrib if out is None else out + contrib
        return out


def _chunk_rows(n: int, block_bytes: int) -> int:
    """Rows of K in one chunk of at most ``block_bytes`` float32 bytes."""
    return max(1, min(n, block_bytes // (4 * n)))


def _kernel_matvec(X: torch.Tensor, gamma: float, lam: float, v: torch.Tensor,
                   chunk_rows: int) -> torch.Tensor:
    """(K + λI) v with K's rows made chunk by chunk: the ONE operator both
    solvers iterate on (a drift between them would solve different
    systems)."""
    kernel = GaussianKernelGenerator(gamma)
    out = torch.empty_like(v)
    for s in range(0, X.shape[0], chunk_rows):
        e = min(s + chunk_rows, X.shape[0])
        out[s:e] = kernel.block(X[s:e], X) @ v
    return out + lam * v


def _cg(X, Y, gamma: float, lam: float, max_iters: int, tol: float, chunk_rows: int):
    """CG solve of (K_gauss + λI)α = Y; returns (α, rs, iterations)."""
    x = torch.zeros_like(Y)
    r = Y.clone()  # since x0 = 0
    p = r.clone()
    rs = torch.sum(r * r)
    i = 0
    while bool(rs > tol * tol) and i < max_iters:
        Ap = _kernel_matvec(X, gamma, lam, p, chunk_rows)
        alpha = rs / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        rs = rs_new
        i += 1
    return x, rs, i


def _pcg(X, Y, gamma: float, lam: float, max_iters: int, tol: float, chunk_rows: int, L, W):
    """Nyström-preconditioned CG (the Falkon idea): landmarks L give the
    rank-m surrogate K̂ = C W⁻¹ Cᵀ with C = k(X, L); Woodbury turns
    (K̂ + λI)⁻¹ into (1/λ)(I − B (λI + BᵀB)⁻¹ Bᵀ) with B = C L⁻ᵀ. Same
    operator and stopping rule as ``_cg``, fewer steps."""
    m = W.shape[0]
    eye = torch.eye(m, dtype=W.dtype, device=W.device)
    # Whitened landmark block: the Woodbury inner matrix becomes λI + BᵀB,
    # whose conditioning λ floors exactly. Over-regularizing only weakens
    # the preconditioner, never the solution.
    Lw = torch.linalg.cholesky(W + 1e-5 * eye)
    C = GaussianKernelGenerator(gamma).block(X, L)
    B = torch.linalg.solve_triangular(Lw, C.T, upper=False).T.double()
    del C
    # From here on in float64, where the reference stays in float32: along
    # a singular direction σ of B, (r − B G⁻¹ Bᵀ r)/λ keeps only λ/(σ² + λ)
    # of r, which float32's rounding swamps once σ²/λ nears 1/eps_f32
    # (1.7e7). Then M⁻¹ is no longer positive definite, rᵀz turns negative
    # and PCG breaks down into NaN, as it did at λ = 1e-3 on 50,000 TIMIT
    # frames. In float64 M⁻¹ is positive definite for the B it is built
    # from; the cost is two (n, m) × (m, k) float64 products a step.
    BtB = B.T @ B
    trace_scale = torch.trace(BtB) / m
    G = BtB + (lam + 1e-6 * trace_scale) * torch.eye(m, dtype=B.dtype, device=B.device)
    # Applied by two triangular solves, not an explicit inverse (module
    # docstring).
    cholG = torch.linalg.cholesky(G)

    def minv(r):
        r64 = r.double()
        return ((r64 - B @ torch.cholesky_solve(B.T @ r64, cholG)) / lam).to(r.dtype)

    x = torch.zeros_like(Y)
    r = Y.clone()
    z = minv(r)
    p = z
    rz = torch.sum(r * z)
    rs = torch.sum(r * r)
    i = 0
    while bool(rs > tol * tol) and i < max_iters:
        Ap = _kernel_matvec(X, gamma, lam, p, chunk_rows)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp_min(rz, 1e-30)) * p
        rz = rz_new
        rs = torch.sum(r * r)
        i += 1
    return x, rs, i


class KernelRidgeRegression(LabelEstimator):
    """Gaussian-kernel ridge regression by CG (Nyström PCG with
    ``precond_landmarks``); any other kernel forms K once and solves it
    directly (``_fit_dense``). Fits on the device of a tensor it is given;
    host arrays go to ``device`` (``cuda`` unless named)."""

    # Set by each fit: an outcome, not a hyperparameter.
    _signature_exclude = ("last_cg_iters",)

    def __init__(
        self,
        kernel: KernelGenerator | None = None,
        lam: float = 1e-3,
        gamma: float | None = None,
        max_iters: int = 200,
        tol: float = 1e-5,
        predict_block_size: int = 4096,
        precond_landmarks: int | None = None,
        seed: int = 0,
        device=None,
    ):
        if kernel is not None and gamma is not None:
            raise ValueError("pass either `kernel` or `gamma`, not both")
        if kernel is None:
            kernel = GaussianKernelGenerator(gamma if gamma is not None else 1.0)
        self.kernel = kernel
        self.lam = lam
        self.max_iters = max_iters
        self.tol = tol
        self.predict_block_size = predict_block_size
        # Nyström preconditioning: landmark rows (None = plain CG).
        self.precond_landmarks = precond_landmarks
        self.seed = seed
        self.device = device
        self.last_cg_iters: int | None = None

    def fit(self, data, labels) -> KernelBlockLinearMapper:
        X = as_input(data, self.device)
        Y = as_input(labels, X.device).to(X.device)
        if Y.ndim == 1:
            Y = Y[:, None]
        if not isinstance(self.kernel, GaussianKernelGenerator):
            return self._fit_dense(X, Y)
        if self.precond_landmarks and self.lam <= 0.0:
            raise ValueError(
                "precond_landmarks requires lam > 0: the Woodbury "
                "preconditioner divides by lam (plain CG handles lam=0)"
            )
        n = X.shape[0]
        gamma = float(self.kernel.gamma)
        chunk_rows = _chunk_rows(n, config.kernel_block_bytes)
        if self.precond_landmarks:
            m = min(int(self.precond_landmarks), n)
            idx = np.random.default_rng(self.seed).choice(n, size=m, replace=False)
            L = X[torch.as_tensor(np.sort(idx), device=X.device)]
            W = self.kernel.block(L, L)
            alpha, _rs, iters = _pcg(X, Y, gamma, self.lam, self.max_iters, float(self.tol), chunk_rows, L, W)
        else:
            alpha, _rs, iters = _cg(X, Y, gamma, self.lam, self.max_iters, float(self.tol), chunk_rows)
        self.last_cg_iters = int(iters)
        return KernelBlockLinearMapper(self.kernel, X, alpha, self.predict_block_size, device=X.device)

    def _fit_dense(self, X, Y) -> KernelBlockLinearMapper:
        """Kernels that are not Gaussian: K formed once and solved directly
        (fine at the sample sizes such kernels see)."""
        n = X.shape[0]
        K = self.kernel.block(X, X)
        alpha = torch.linalg.solve(K + self.lam * torch.eye(n, dtype=X.dtype, device=X.device), Y)
        self.last_cg_iters = 0
        return KernelBlockLinearMapper(self.kernel, X, alpha, self.predict_block_size, device=X.device)
