"""The port's solver held against the JAX package and a float64 run.

The reference's solver runs on the suite's 8-device CPU mesh with its
fixed fold order; the port sums on one device in another order. So W and
b are compared at rtol 1e-3, atol 1e-4, and both are held against a
float64 numpy run of the same blocks and epochs: the port's error is at
most twice the reference's plus 1e-5. Every problem has n ≫ d, so that
the ridge grams are well conditioned. Row reductions: rtol 1e-5,
atol 1e-5; row weights: rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.linalg import RowMatrix
from keystone_tpu.linalg.bcd import block_coordinate_descent as j_bcd
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBlockLS
from keystone_tpu.nodes.learning import BlockWeightedLeastSquaresEstimator as JBlockWLS
from keystone_tpu.nodes.learning.block_least_squares import (
    resolve_block_size as j_resolve_block_size,
)
from keystone_tpu.nodes.stats import SignedHellingerMapper as JSignedHellingerMapper
from keystone_tpu_torch.linalg.bcd import block_coordinate_descent, objective
from keystone_tpu_torch.linalg.row_matrix import solver_matmul, weighted_col_sums
from keystone_tpu_torch.nodes.learning.block_least_squares import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    BlockWeightedLeastSquaresEstimator,
    resolve_block_size,
)
from keystone_tpu_torch.nodes.learning.kmeans import KMeansPlusPlusEstimator
from keystone_tpu_torch.nodes.stats.hellinger import SignedHellingerMapper
from keystone_tpu_torch.utils.stages import StageTimer
from keystone_tpu_torch.workflow import on_device

SOLVE_TOL = dict(rtol=1e-3, atol=1e-4)
F64_ATOL = 1e-5
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(n=400, d=48, k=3, seed=0, imbalance=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) + 0.3 * rng.normal(size=(1, d))
    p = np.linspace(1, 4, k) if imbalance else np.ones(k)
    y = rng.choice(k, size=n, p=p / p.sum())
    Y = 2.0 * np.eye(k)[y] - 1.0
    Y += 0.1 * (X[:, :k] @ rng.normal(size=(k, k)))
    return X.astype(np.float32), Y.astype(np.float32), y


def _class_weights(y, k, mixture_weight):
    counts = np.maximum(np.bincount(y, minlength=k), 1)
    per = (1 - mixture_weight) + mixture_weight * len(y) / (k * counts)
    return per[y]


def _bcd64(A, B, block_size, iters, lam, w=None):
    """The same blocks and epochs in float64 numpy."""
    A, B = A.astype(np.float64), B.astype(np.float64)
    w = np.ones(len(A)) if w is None else np.asarray(w, np.float64)
    blocks = [(s, min(s + block_size, A.shape[1])) for s in range(0, A.shape[1], block_size)]
    W = [np.zeros((e - s, B.shape[1])) for s, e in blocks]
    R = B.copy()
    for _ in range(iters):
        for i, (s, e) in enumerate(blocks):
            a = A[:, s:e]
            Rp = R + a @ W[i]
            W[i] = np.linalg.solve((a * w[:, None]).T @ a + lam * np.eye(e - s), (a * w[:, None]).T @ Rp)
            R = Rp - a @ W[i]
    return np.concatenate(W)


@pytest.mark.parametrize("d", [50, 128, 1000, 5000, 65536, 300_000])
def test_resolve_block_size_on_the_cpu(d):
    assert resolve_block_size("auto", d, "cpu") == j_resolve_block_size("auto", d)
    assert resolve_block_size(96, d, "cpu") == j_resolve_block_size(96, d) == 96


@pytest.mark.parametrize("d", [1000, 65536, 300_000])
def test_resolve_block_size_on_the_card(d, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert resolve_block_size("auto", d, "cuda") == j_resolve_block_size("auto", d)
    if d == 65536:
        assert resolve_block_size("auto", d, "cuda") == 8192  # 8 blocks


def test_row_reductions_match_the_reference():
    X, _, y = _problem(n=301, d=20)
    w = _class_weights(y, 3, 0.5).astype(np.float32)
    A = RowMatrix.from_array(X)
    means = X.mean(axis=0)
    np.testing.assert_allclose(torch.from_numpy(X).sum(dim=0).numpy(), np.asarray(A.col_sums()), **SUM_TOL)
    np.testing.assert_allclose(
        weighted_col_sums(torch.from_numpy(X), torch.from_numpy(w)).numpy(),
        np.asarray(A.weighted_col_sums(RowMatrix.from_array(w[:, None]))), **SUM_TOL,
    )
    np.testing.assert_allclose(
        (torch.from_numpy(X) - torch.from_numpy(means)).numpy(),
        A.centered(means).collect(), **SUM_TOL,
    )
    np.testing.assert_allclose(
        solver_matmul(torch.from_numpy(X.T), torch.from_numpy(X)).numpy(),
        X.T.astype(np.float64) @ X, rtol=1e-5, atol=1e-3,
    )


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_bcd_matches_the_reference_and_float64(cached, weighted):
    X, Y, y = _problem(seed=1)
    w = _class_weights(y, 3, 0.7).astype(np.float32) if weighted else None
    lam, iters, block = 0.5, 3, 16
    Wj, blocks_j = j_bcd(
        RowMatrix.from_array(X), RowMatrix.from_array(Y), block_size=block, num_iters=iters,
        lam=lam, row_weights=None if w is None else jax.numpy.asarray(w), cache_grams=cached,
    )
    Wp, blocks_p = block_coordinate_descent(
        torch.from_numpy(X), torch.from_numpy(Y), block_size=block, num_iters=iters, lam=lam,
        row_weights=None if w is None else torch.from_numpy(w), cache_grams=cached,
    )
    assert [tuple(b) for b in blocks_j] == blocks_p == [(0, 16), (16, 32), (32, 48)]
    Wj = np.concatenate([np.asarray(b) for b in Wj])
    Wp = torch.cat(Wp).numpy()
    np.testing.assert_allclose(Wp, Wj, **SOLVE_TOL)
    W64 = _bcd64(X, Y, block, iters, lam, w)
    assert np.abs(Wp - W64).max() <= 2 * np.abs(Wj - W64).max() + F64_ATOL


def test_bcd_ragged_last_block_and_the_objective_per_epoch():
    X, Y, y = _problem(n=500, d=40, seed=2)
    w = torch.from_numpy(_class_weights(y, 3, 0.5).astype(np.float32))
    with StageTimer("cpu") as timer:
        W, blocks = block_coordinate_descent(
            torch.from_numpy(X), torch.from_numpy(Y), block_size=16, num_iters=4, lam=0.2,
            row_weights=w, cache_grams=True,
        )
    assert blocks == [(0, 16), (16, 32), (32, 40)]
    np.testing.assert_allclose(torch.cat(W).numpy(), _bcd64(X, Y, 16, 4, 0.2, w.numpy()), rtol=1e-3, atol=1e-5)
    objs = [float(timer.notes[f"objective after epoch {e}"]) for e in range(1, 5)]
    assert all(b <= a * (1 + 1e-6) for a, b in zip(objs, objs[1:])), objs
    R = torch.from_numpy(Y) - torch.from_numpy(X) @ torch.cat(W)
    again = float(objective(R, W, 0.2, row_weights=w))
    assert again == pytest.approx(objs[-1], rel=1e-4)
    assert {"BCD factor phase", "BCD epoch 1", "BCD epoch 4"} <= set(timer.seconds())


@pytest.mark.parametrize("mixture_weight", [0.0, 0.5, 1.0])
def test_row_weights_match_the_reference(mixture_weight):
    _, Y, y = _problem(n=90, seed=3)
    Yi = (2.0 * np.eye(3)[y] - 1.0).astype(np.float32)
    want = JBlockWLS(mixture_weight=mixture_weight)._weights(jax.numpy.asarray(Yi))
    got = BlockWeightedLeastSquaresEstimator(mixture_weight=mixture_weight)._weights(torch.from_numpy(Yi))
    if mixture_weight == 0.0:
        assert got is None and want is None
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), _class_weights(y, 3, mixture_weight), rtol=1e-6)


@pytest.mark.parametrize("mixture_weight", [0.0, 0.5])
def test_weighted_estimator_fit_matches_the_reference(mixture_weight):
    X, Y, _ = _problem(n=480, d=64, seed=4)
    kw = dict(block_size=16, num_iters=3, lam=0.3, mixture_weight=mixture_weight)
    j = JBlockWLS(**kw).fit(X, Y)
    p = BlockWeightedLeastSquaresEstimator(**kw).fit(torch.from_numpy(X), torch.from_numpy(Y))
    assert isinstance(p, BlockLinearMapper) and p.blocks == [tuple(b) for b in j.blocks]
    np.testing.assert_allclose(p.W.numpy(), np.asarray(j.W), **SOLVE_TOL)
    np.testing.assert_allclose(p.b.numpy(), np.asarray(j.b), **SOLVE_TOL)
    Xt = X[:50]
    np.testing.assert_allclose(p(torch.from_numpy(Xt)).numpy(), np.asarray(j.apply_batch(Xt)), **SOLVE_TOL)


def test_estimator_without_intercept_matches_the_reference():
    X, Y, _ = _problem(n=300, d=32, seed=5)
    j = JBlockLS(block_size=8, num_iters=2, lam=0.1, fit_intercept=False).fit(X, Y)
    p = BlockLeastSquaresEstimator(block_size=8, num_iters=2, lam=0.1, fit_intercept=False).fit(
        torch.from_numpy(X), torch.from_numpy(Y)
    )
    assert p.b is None and j.b is None
    np.testing.assert_allclose(p.W.numpy(), np.asarray(j.W), **SOLVE_TOL)


def test_and_then_fits_the_estimator_on_the_prefix_output():
    X, Y, _ = _problem(n=200, d=24, seed=6)
    kw = dict(block_size=8, num_iters=2, lam=0.2, mixture_weight=0.5)
    j = JSignedHellingerMapper().to_pipeline().and_then(JBlockWLS(**kw), X, Y)
    want = np.asarray(j(X[:30]).get())
    prefix = SignedHellingerMapper().to_pipeline()
    with on_device("cpu"):
        fitted = [
            prefix.and_then(BlockWeightedLeastSquaresEstimator(**kw), X, Y).fit(),
            # The prefix applied in other batches: the batch size changes no result.
            prefix.and_then(
                BlockWeightedLeastSquaresEstimator(**kw).fit(
                    SignedHellingerMapper().apply_in_batches(X, batch_size=7, device="cpu"), torch.from_numpy(Y)
                )
            ),
        ]
        names = [type(s).__name__ for s in fitted[0].transformers()]
        assert names == ["SignedHellingerMapper", "BlockLinearMapper"]
        got = [f(torch.from_numpy(X[:30])).get().numpy() for f in fitted]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, **SOLVE_TOL)


def test_and_then_with_an_unlabelled_estimator_and_its_errors():
    X = np.random.default_rng(7).normal(size=(60, 4)).astype(np.float32)
    p = SignedHellingerMapper().and_then(KMeansPlusPlusEstimator(3, seed=1), X)
    with on_device("cpu"):
        assert p(torch.from_numpy(X)).get().shape == (60, 3)
    prefix = SignedHellingerMapper().to_pipeline()
    with pytest.raises(TypeError):
        prefix.and_then(KMeansPlusPlusEstimator(3), X, X)
    with pytest.raises(TypeError):
        prefix.and_then(BlockLeastSquaresEstimator(), X)
    with pytest.raises(TypeError):
        prefix.and_then(SignedHellingerMapper(), X)
