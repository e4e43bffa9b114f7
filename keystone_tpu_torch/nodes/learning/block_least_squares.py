"""Block least squares: the linear model and its solver.

Counterpart of ``keystone_tpu/nodes/learning/block_least_squares.py``:

- ``BlockLinearMapper``: ``scores = Σ_b X[..., s:e] @ W_b + b``, per-block
  products in float32 (TF32 off), as the reference leaves them to XLA;
- ``resolve_block_size``: ``"auto"`` → the smallest power of two covering
  d, capped at 4,096 for CPU tensors and 8,192 on the card, and halved
  until the cached inverses fit a quarter of the memory budget;
- ``BlockLeastSquaresEstimator.fit``, the dense path: features and labels
  centered (weighted means when rows are weighted), the centered features
  stored in the solver's storage dtype, block coordinate descent
  (``linalg/bcd.py``), and the intercept ``b = ȳ_w − x̄_wᵀW``;
- ``BlockLeastSquaresEstimator.fit`` streamed (``stream``, ``:173-221``):
  the features stay in host memory, the caller's array, uncopied; the
  feature means come from a host matvec and are subtracted from each block
  as it is prepared (``col_center``), the label means from the labels on
  the device, and ``linalg/bcd.py::block_coordinate_descent_streamed``
  solves. ``stream=None`` streams when the features' float32 bytes exceed
  half the memory budget (6 GiB), wherever they lie, as the reference's
  auto rule does (``:167-177``); features on the card are then copied to
  the host first;
- ``precision`` and ``storage_dtype``: the solver's modes (``config.py``),
  passed to either solve; W stays float32;
- ``checkpoint_dir``: epoch checkpoints of either solve, and the streamed
  solve's mid-epoch snapshots, resumed by a later fit of the same problem;
- ``BlockWeightedLeastSquaresEstimator``: class-rebalanced row weights,
  ``(1 − mixture_weight) + mixture_weight · n / (k · n_c)`` for a row of
  class c;
- a ``SparseBatch`` (``_fit_sparse``, the reference's ``:316-349``): the
  features stay CSR in host memory and the streamed solve densifies one
  column block at a time on its prefetch thread. Centering would destroy
  sparsity, so the intercept is the weight of an appended all-ones
  column, ridge-penalised like the others when λ > 0 (exact at λ = 0).
  ``BlockLinearMapper`` takes a ``SparseBatch`` too, as a CSR tensor on its
  device times W.

The model-parallel ring is not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device, solver_precision
from keystone_tpu_torch.linalg.bcd import (
    block_coordinate_descent,
    block_coordinate_descent_streamed,
    host_matrix,
)
from keystone_tpu_torch.linalg.row_matrix import (
    HBM_BUDGET_BYTES,
    solver_matmul,
    storage_dtype,
    weighted_col_sums,
)
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import LabelEstimator, Transformer


class BlockLinearMapper(Transformer):
    def __init__(self, W, blocks: Sequence[Tuple[int, int]], b=None, device=None):
        """``W`` is the (d, C) weight matrix, the reference's ``W_blocks``
        stacked; ``blocks`` lists the (start, end) feature ranges."""
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("W", torch.as_tensor(W, dtype=default_dtype, device=device))
        self.blocks = [(int(s), int(e)) for s, e in blocks]
        if self.blocks[0][0] != 0 or self.blocks[-1][1] != self.W.shape[0] or any(
            e0 != s1 for (_, e0), (s1, _) in zip(self.blocks, self.blocks[1:])
        ):
            raise ValueError(f"blocks {self.blocks} do not tile 0..{self.W.shape[0]}")
        self.register_buffer(
            "b", None if b is None else torch.as_tensor(b, dtype=default_dtype, device=device)
        )

    def apply_batch(self, X):
        if isinstance(X, SparseBatch):
            out = X.to_torch(self.W.device) @ self.W
            return out if self.b is None else out + self.b
        out = None
        for s, e in self.blocks:
            contrib = X[..., s:e] @ self.W[s:e]
            out = contrib if out is None else out + contrib
        if self.b is not None:
            out = out + self.b
        return out


def resolve_block_size(block_size, d: int, device) -> int:
    if block_size != "auto":
        return int(block_size)
    cap = 4096 if torch.device(device).type == "cpu" else 8192
    b = min(cap, 1 << math.ceil(math.log2(max(d, 128))))
    itemsize = torch.finfo(default_dtype).bits // 8
    while b > 128 and d * b * itemsize > HBM_BUDGET_BYTES // 4:
        b //= 2
    return b


class BlockLeastSquaresEstimator(LabelEstimator):
    """The dense ``fit`` runs on the device of the data tensor it is given;
    host arrays go to ``device`` (``cuda`` unless named). The streamed fit
    keeps host features on the host and solves on ``device``, or on the
    card the features came from. ``precision`` and ``storage_dtype`` left
    at None take ``config.py``'s defaults."""

    def __init__(self, block_size="auto", num_iters: int = 1, lam: float = 0.0,
                 fit_intercept: bool = True, device=None,
                 checkpoint_dir: Optional[str] = None, stream: Optional[bool] = None,
                 precision: Optional[str] = None, storage_dtype: Optional[str] = None):
        self.block_size = block_size
        self.num_iters = num_iters
        self.lam = lam
        self.fit_intercept = fit_intercept
        self.device = device
        self.checkpoint_dir = checkpoint_dir
        self.stream = stream
        self.precision = precision
        self.storage_dtype = storage_dtype

    def _weights(self, Y: torch.Tensor) -> Optional[torch.Tensor]:
        return None

    def fit(self, data, labels) -> BlockLinearMapper:
        if isinstance(data, SparseBatch):
            return self._fit_sparse(data, labels)
        stream = self.stream
        if stream is None:
            itemsize = torch.finfo(default_dtype).bits // 8
            stream = math.prod(np.shape(data)) * itemsize > HBM_BUDGET_BYTES // 2
        if stream:
            return self._fit_streamed(data, labels)
        precision = solver_precision(self.precision)
        X = as_input(data, self.device)
        Y = as_input(labels, X.device).to(X.device)
        weights = self._weights(Y)
        x_mean = y_mean = None
        if self.fit_intercept:
            # The intercept of weighted ridge absorbs the weighted means.
            if weights is None:
                x_mean = X.sum(dim=0) / X.shape[0]
                y_mean = Y.sum(dim=0) / Y.shape[0]
            else:
                wsum = torch.clamp_min(weights.sum(), 1e-12)
                x_mean = weighted_col_sums(X, weights, precision) / wsum
                y_mean = weighted_col_sums(Y, weights, precision) / wsum
            # Centered in float32, rounded once into the storage dtype.
            A = torch.sub(X, x_mean, out=torch.empty(X.shape, dtype=storage_dtype(self.storage_dtype),
                                                     device=X.device))
            Y = Y - y_mean
            mark("centering")
        else:
            A = X.to(storage_dtype(self.storage_dtype))
        W_blocks, blocks = block_coordinate_descent(
            A, Y,
            block_size=resolve_block_size(self.block_size, A.shape[1], A.device),
            num_iters=self.num_iters,
            lam=self.lam,
            row_weights=weights,
            checkpoint_dir=self.checkpoint_dir,
            precision=precision,
        )
        W = torch.cat(W_blocks, dim=0)
        b = None if y_mean is None else y_mean - solver_matmul(x_mean[None, :], W, precision)[0]
        return BlockLinearMapper(W, blocks, b, device=W.device)

    def _fit_streamed(self, data, labels) -> BlockLinearMapper:
        on_card = isinstance(data, torch.Tensor) and data.device.type != "cpu"
        device = resolve_device(data.device if on_card else self.device)
        # Features on the card come to the host, as the reference's
        # np.asarray brings a device array there.
        X = host_matrix(data.cpu() if on_card else data)
        if on_card:
            mark("copy of the features to the host")
        Y = as_input(labels, device).to(device)
        weights = self._weights(Y)
        x_mean = y_mean = None
        if self.fit_intercept:
            # The dense path's means: x̄ on the host, as a matvec (no
            # X-sized temporary); ȳ on the device from the placed labels.
            if weights is None:
                x_mean = X.mean(dim=0)
                y_mean = Y.sum(dim=0) / Y.shape[0]
            else:
                w_host = weights.cpu()
                x_mean = torch.mv(X.T, w_host) / max(float(w_host.sum()), 1e-12)
                y_mean = weighted_col_sums(Y, weights) / torch.clamp_min(weights.sum(), 1e-12)
            Y = Y - y_mean
            mark("centering")
        W_blocks, blocks = block_coordinate_descent_streamed(
            X, Y,
            block_size=resolve_block_size(self.block_size, X.shape[1], device),
            num_iters=self.num_iters,
            lam=self.lam,
            row_weights=weights,
            checkpoint_dir=self.checkpoint_dir,
            col_center=x_mean,
            precision=self.precision,
            storage_dtype=self.storage_dtype,
        )
        W = torch.cat(W_blocks, dim=0)
        b = None if y_mean is None else y_mean - solver_matmul(
            x_mean.to(device)[None, :], W, solver_precision(self.precision))[0]
        return BlockLinearMapper(W, blocks, b, device=device)

    def _fit_sparse(self, data: SparseBatch, labels) -> BlockLinearMapper:
        on_card = isinstance(labels, torch.Tensor) and labels.device.type != "cpu"
        device = resolve_device(labels.device if on_card else self.device)
        Y = as_input(labels, device).to(device)
        A = data.append_ones() if self.fit_intercept else data
        W_blocks, blocks = block_coordinate_descent_streamed(
            A, Y,
            block_size=resolve_block_size(self.block_size, data.shape[1], device),
            num_iters=self.num_iters,
            lam=self.lam,
            row_weights=self._weights(Y),
            checkpoint_dir=self.checkpoint_dir,
            precision=self.precision,
            storage_dtype=self.storage_dtype,
        )
        W = torch.cat(W_blocks, dim=0)
        b = None
        if self.fit_intercept:
            # The ones column's weight is b; its column leaves the last block.
            W, b = W[:-1], W[-1]
            s, e = blocks.pop()
            if e - s > 1:
                blocks.append((s, e - 1))
        return BlockLinearMapper(W, blocks, b, device=device)


class BlockWeightedLeastSquaresEstimator(BlockLeastSquaresEstimator):
    def __init__(self, block_size="auto", num_iters: int = 1, lam: float = 0.0,
                 mixture_weight: float = 0.5, fit_intercept: bool = True, device=None,
                 checkpoint_dir: Optional[str] = None, stream: Optional[bool] = None,
                 precision: Optional[str] = None, storage_dtype: Optional[str] = None):
        super().__init__(block_size, num_iters, lam, fit_intercept, device, checkpoint_dir, stream,
                         precision, storage_dtype)
        self.mixture_weight = mixture_weight

    def _weights(self, Y: torch.Tensor) -> Optional[torch.Tensor]:
        if self.mixture_weight == 0.0:
            return None  # exactly the unweighted problem
        # A row's class is the argmax of its ±1 indicators.
        classes = Y.argmax(dim=1)
        n, k = Y.shape
        counts = torch.clamp_min(torch.bincount(classes, minlength=k).to(Y.dtype), 1.0)
        per_class = (1.0 - self.mixture_weight) + self.mixture_weight * n / (k * counts)
        return per_class[classes]
