"""The rest of the learning nodes in the port, held against the JAX package
on the CPU: ``about_eq``, ``BatchIterator.from_csv``, the kernel generators,
``LocalLeastSquaresEstimator``, ``choose_solver`` and
``LeastSquaresEstimator``, ``LinearDiscriminantAnalysis`` and
``KernelRidgeRegression`` with ``KernelBlockLinearMapper``.

Tolerances, each for the reason given:

- ``about_eq``, ``choose_solver`` and ``from_csv``: equal (the same host
  code; the same choice and the same reason string on a grid of (n, d, k,
  budget) straddling every threshold, the budget passed so that the host
  does not decide).
- Kernel blocks: rtol 1e-5, atol 1e-6. Both expand ||x − z||² into float32
  gemms, XLA's and torch's, which sum in different orders.
- Least squares: W and b within rtol 1e-4, atol 1e-5 for the one-solve
  branches (float32 solves of well-conditioned ridge systems, sums in
  another order); the block branch's predictions within 1e-3 of the
  largest |prediction| (three epochs of block coordinate descent, the
  reference's sums over its 8 CPU devices).
- LDA: ``eigh`` picks eigenvector signs per solver, and ``Sb`` has rank at
  most C − 1, so directions past that rank are arbitrary. The projections
  are compared column by column up to sign, for ``dims ≤ C − 1`` only,
  within 1e-3 of each column's largest |value|.
- Kernel ridge: the reference runs on 8 CPU devices (``tests/conftest.py``),
  so its CG scalars are summed in shard order. With ``tol = 0`` and a fixed
  ``max_iters`` (1, 3 and 6) both take the same number of steps; α is
  compared within 1e-3 of its largest |value|. Later iterates of this
  system (condition number 270) are not fixed by float32: past about 8
  steps, CG in float32 (either package) and CG in float64 differ by up to
  1e-2 of the largest |α| before they converge together again, so the
  converged α is held instead, against a float64 numpy solve of
  (K + λI)α = Y within 1e-3 of its largest |value|. The dense
  linear-kernel fit: within rtol 1e-4, atol 1e-5 of the reference's
  predictions.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.stream import BatchIterator as JBatchIterator
from keystone_tpu.nodes.learning import GaussianKernelGenerator as JGaussianKernelGenerator
from keystone_tpu.nodes.learning import KernelRidgeRegression as JKernelRidgeRegression
from keystone_tpu.nodes.learning import LinearDiscriminantAnalysis as JLinearDiscriminantAnalysis
from keystone_tpu.nodes.learning import LinearKernelGenerator as JLinearKernelGenerator
from keystone_tpu.nodes.learning import LocalLeastSquaresEstimator as JLocalLeastSquaresEstimator
from keystone_tpu.nodes.learning.least_squares import LeastSquaresEstimator as JLeastSquaresEstimator
from keystone_tpu.nodes.learning.least_squares import choose_solver as j_choose_solver
from keystone_tpu.utils.stats import about_eq as j_about_eq
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.kernel_ridge import (
    KernelBlockLinearMapper,
    KernelRidgeRegression,
    _chunk_rows,
    _kernel_matvec,
)
from keystone_tpu_torch.nodes.learning.kernels import GaussianKernelGenerator, LinearKernelGenerator
from keystone_tpu_torch.nodes.learning.lda import LinearDiscriminantAnalysis
from keystone_tpu_torch.nodes.learning.least_squares import LeastSquaresEstimator, choose_solver
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
from keystone_tpu_torch.nodes.learning.local_least_squares import LocalLeastSquaresEstimator
from keystone_tpu_torch.utils.stats import about_eq

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
SOLVE_TOL = dict(rtol=1e-4, atol=1e-5)
REL_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_rel(got, want, rel=REL_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# --- small leftovers ---------------------------------------------------------


@pytest.mark.parametrize(
    "a, b, tol",
    [
        (1.0, 1.0 + 1e-7, 1e-6),
        (1.0, 1.0 + 1e-5, 1e-6),
        ([1.0, 2.0], [1.0, 2.0 + 5e-7], 1e-6),
        ([1.0, 2.0], [1.0, 2.0, 3.0], 1e-6),
        (np.zeros((0,)), np.zeros((0,)), 0.0),
        ([[1, 2], [3, 4]], [[1, 2], [3, 4.1]], 0.2),
    ],
)
def test_about_eq_agrees(a, b, tol):
    assert about_eq(a, b, tol) == j_about_eq(a, b, tol)


@pytest.mark.parametrize("label_col, label_dtype", [(0, np.int32), (2, np.float32), (None, np.int32)])
def test_from_csv_equals_the_reference(rng, tmp_path, label_col, label_dtype):
    X = rng.normal(size=(11, 4)).astype(np.float32)
    y = rng.normal(size=11) * 3
    path = tmp_path / "d.csv"
    with open(path, "w") as f:
        for i in range(11):
            vals = [f"{v:.6f}" for v in X[i]]
            vals.insert(label_col or 0, f"{y[i]:.4f}")
            f.write(",".join(vals) + "\n\n")
    got = list(BatchIterator.from_csv(str(path), label_col=label_col, batch_rows=4, label_dtype=label_dtype))
    want = list(JBatchIterator.from_csv(str(path), label_col=label_col, batch_rows=4, label_dtype=label_dtype))
    assert [g[0].shape[0] for g in got] == [4, 4, 3]
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        if label_col is None:
            assert gy is None and wy is None
        else:
            assert gy.dtype == wy.dtype
            np.testing.assert_array_equal(gy, wy)
    # Float labels keep their fraction; re-iterable.
    if label_dtype == np.float32:
        assert np.any(np.concatenate([g[1] for g in got]) % 1 != 0)
    assert len(list(BatchIterator.from_csv(str(path), label_col=label_col, batch_rows=4))) == 3


# --- kernel generators --------------------------------------------------------


@pytest.mark.parametrize("gamma", [0.05, 0.3, 2.0])
def test_gaussian_kernel_block(rng, gamma):
    X = rng.normal(size=(37, 9)).astype(np.float32)
    Z = rng.normal(size=(23, 9)).astype(np.float32)
    got = GaussianKernelGenerator(gamma).block(torch.from_numpy(X), torch.from_numpy(Z))
    want = JGaussianKernelGenerator(gamma).block(X, Z)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


def test_linear_kernel_block(rng):
    X = rng.normal(size=(37, 9)).astype(np.float32)
    Z = rng.normal(size=(23, 9)).astype(np.float32)
    got = LinearKernelGenerator().block(torch.from_numpy(X), torch.from_numpy(Z))
    np.testing.assert_allclose(_np(got), np.asarray(JLinearKernelGenerator().block(X, Z)), **KERNEL_TOL)


# --- least squares -------------------------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_local_least_squares(rng, lam):
    X = rng.normal(size=(60, 7)).astype(np.float32)
    Y = (X @ rng.normal(size=(7, 3)) + 2.0 + 0.1 * rng.normal(size=(60, 3))).astype(np.float32)
    got = LocalLeastSquaresEstimator(lam, device="cpu").fit(X, Y)
    want = JLocalLeastSquaresEstimator(lam).fit(X, Y)
    np.testing.assert_allclose(_np(got.W), np.asarray(want.W), **SOLVE_TOL)
    np.testing.assert_allclose(_np(got.b), np.asarray(want.b), **SOLVE_TOL)
    np.testing.assert_allclose(_np(got(torch.from_numpy(X))), np.asarray(want(X)), **SOLVE_TOL)


MiB = 1 << 20
SOLVER_GRID = [
    # local: n·d·4 just under / at 16 MiB, d at / past 2048.
    (2047, 2048, 10, 1 << 34),
    (2048, 2048, 10, 1 << 34),
    (100, 2049, 10, 1 << 34),
    (100, 10, 3, 1 << 34),
    # normal: (d² + 2dk)·4 at / past budget // 8, d at / past 32768.
    (10_000, 4096, 10, 8 * (4096 * 4096 + 2 * 4096 * 10) * 4),
    (10_000, 4096, 10, 8 * (4096 * 4096 + 2 * 4096 * 10) * 4 - 8),
    (10_000, 32768, 1, 1 << 40),
    (10_000, 32769, 1, 1 << 40),
    (1_000_000, 262_144, 1000, 80 << 30),
    (8192, 65536, 1000, 80 << 30),
    (60_000, 4104, 10, 80 << 30),
    (4096, 1024, 147, 80 << 30),
]


@pytest.mark.parametrize("n, d, k, budget", SOLVER_GRID)
def test_choose_solver_same_choice_and_reason(n, d, k, budget):
    for block_size in (4096, 512):
        got = choose_solver(n, d, k, budget, block_size)
        want = j_choose_solver(n, d, k, budget, block_size)
        assert (got.name, got.reason) == (want.name, want.reason)


def test_choose_solver_reads_the_cpu_budget_when_none_is_given():
    # On the CPU the port's budget is config.HBM_BUDGET_BYTES (12 GiB):
    # a 20 GiB gram is past an eighth of it.
    assert choose_solver(100_000, 4096, 10).name == "normal"
    assert choose_solver(100_000, 32768, 10, device="cpu").name == "block"


@pytest.mark.parametrize(
    "n, d, k, budget, branch",
    [
        (50, 6, 2, None, "local"),
        (32, 2049, 3, 1 << 34, "normal"),
        (32, 2049, 3, 1 * MiB, "block"),
    ],
)
def test_least_squares_estimator_each_branch(rng, n, d, k, budget, branch):
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    est = LeastSquaresEstimator(lam=0.5, block_size=512, num_iters=3, hbm_budget_bytes=budget, device="cpu")
    model = est.fit(X, Y)
    j_est = JLeastSquaresEstimator(lam=0.5, block_size=512, num_iters=3, hbm_budget_bytes=budget)
    j_model = j_est.fit(X, Y)
    assert est.last_choice.name == j_est.last_choice.name == branch
    assert est.last_choice.reason == j_est.last_choice.reason
    _close_rel(model(torch.from_numpy(X)), j_model(X))
    # The dispatcher runs the concrete estimator it names: the same result.
    concrete = {
        "local": LocalLeastSquaresEstimator(0.5, device="cpu"),
        "normal": LinearMapEstimator(0.5, device="cpu"),
        "block": BlockLeastSquaresEstimator(block_size=512, num_iters=3, lam=0.5, device="cpu"),
    }[branch].fit(X, Y)
    assert torch.equal(model(torch.from_numpy(X)), concrete(torch.from_numpy(X)))
    # optimize_node commits to the same estimator type from the shapes.
    assert type(est.optimize_node((n, d), (n, k))) is type(est._concrete(est.last_choice))
    assert est.optimize_node((n, d)) is est


def test_least_squares_online_calls_raise():
    est = LeastSquaresEstimator()
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        est.partial_fit(np.zeros((2, 2)), np.zeros((2, 1)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        est.solve_online(None)


# --- LDA -----------------------------------------------------------------------


@pytest.mark.parametrize("C, dims", [(2, 1), (4, 3), (5, 2)])
def test_lda_projections_up_to_sign(rng, C, dims):
    d, per = 6, 80
    centres = 2.5 * rng.normal(size=(C, d))
    X = np.concatenate([rng.normal(loc=centres[c], size=(per, d)) for c in range(C)]).astype(np.float32)
    y = np.repeat(np.arange(C), per)
    got = LinearDiscriminantAnalysis(dims=dims, device="cpu").fit(X, y)
    want = JLinearDiscriminantAnalysis(dims=dims).fit(X, y)
    np.testing.assert_allclose(_np(got.mean), np.asarray(want.mean), **SOLVE_TOL)
    zg = _np(got(torch.from_numpy(X)))
    zw = np.asarray(want(X))
    assert zg.shape == zw.shape == (C * per, dims)
    for j in range(dims):
        sign = np.sign(np.dot(zg[:, j], zw[:, j]))
        np.testing.assert_allclose(sign * zg[:, j], zw[:, j], rtol=0, atol=REL_TOL * np.abs(zw[:, j]).max())
    # Labels given as a tensor fit the same projection.
    same = LinearDiscriminantAnalysis(dims=dims, device="cpu").fit(torch.from_numpy(X), torch.from_numpy(y))
    assert torch.equal(same.components, got.components)


# --- kernel ridge regression ----------------------------------------------------


def _krr_problem(rng, n=150, d=5, k=2):
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    return X, Y


def _dense_alpha(X, Y, gamma, lam):
    X64 = X.astype(np.float64)
    sq = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    K = np.exp(-gamma * sq)
    return K, np.linalg.solve(K + lam * np.eye(len(X)), Y.astype(np.float64))


@pytest.mark.parametrize("landmarks", [None, 40])
@pytest.mark.parametrize("max_iters", [1, 3, 6])
def test_kernel_ridge_steps_equal_the_reference(rng, landmarks, max_iters):
    X, Y = _krr_problem(rng)
    kw = dict(gamma=0.3, lam=0.1, max_iters=max_iters, tol=0.0, precond_landmarks=landmarks, seed=3)
    est = KernelRidgeRegression(device="cpu", **kw)
    model = est.fit(X, Y)
    j_est = JKernelRidgeRegression(**kw)
    j_model = j_est.fit(X, Y)
    assert est.last_cg_iters == j_est.last_cg_iters == max_iters
    _close_rel(model.alpha, j_model.alpha)
    _close_rel(model(torch.from_numpy(X)), j_model(X))


@pytest.mark.parametrize("landmarks", [None, 64])
def test_kernel_ridge_converges_to_the_float64_solve(rng, landmarks, monkeypatch):
    X, Y = _krr_problem(rng)
    # Chunks of 16 rows: the operator's row chunking is exercised.
    from keystone_tpu_torch.config import config

    monkeypatch.setattr(config, "kernel_block_bytes", 16 * 4 * len(X))
    est = KernelRidgeRegression(gamma=0.3, lam=0.1, max_iters=400, tol=1e-6, precond_landmarks=landmarks,
                                device="cpu")
    model = est.fit(X, Y)
    K, alpha = _dense_alpha(X, Y, 0.3, 0.1)
    _close_rel(model.alpha, alpha)
    _close_rel(model(torch.from_numpy(X)), K @ alpha)
    assert 0 < est.last_cg_iters < 400
    j_est = JKernelRidgeRegression(gamma=0.3, lam=0.1, max_iters=400, tol=1e-6, precond_landmarks=landmarks)
    j_est.fit(X, Y)
    assert abs(est.last_cg_iters - j_est.last_cg_iters) <= 2


def test_preconditioner_cuts_iterations(rng):
    X = rng.normal(size=(300, 12)).astype(np.float32)
    Y = rng.normal(size=(300, 2)).astype(np.float32)
    plain = KernelRidgeRegression(gamma=0.05, lam=1e-3, max_iters=500, tol=1e-4, device="cpu")
    pre = KernelRidgeRegression(gamma=0.05, lam=1e-3, max_iters=500, tol=1e-4, precond_landmarks=150,
                                device="cpu")
    plain.fit(X, Y)
    pre.fit(X, Y)
    assert pre.last_cg_iters < plain.last_cg_iters / 2


def test_pcg_stays_positive_definite_at_small_lam(rng):
    """At lam 1e-6 against a wide kernel (BᵀB's top eigenvalue over lam
    far past 1/eps_f32), the Woodbury preconditioner in float32 can lose
    positive definiteness and PCG break down into NaN. The port applies it
    in float64, so its PCG stays finite and reaches the float64 solve's
    residual within 1e-3."""
    X = rng.normal(size=(600, 12)).astype(np.float32)
    Y = rng.normal(size=(600, 2)).astype(np.float32)
    est = KernelRidgeRegression(gamma=0.05, lam=1e-6, max_iters=300, tol=1e-6, precond_landmarks=200,
                                device="cpu")
    alpha = est.fit(X, Y).alpha.numpy().astype(np.float64)
    assert np.isfinite(alpha).all()
    K, _ = _dense_alpha(X, Y, 0.05, 1e-6)
    resid = np.linalg.norm((K + 1e-6 * np.eye(600)) @ alpha - Y) / np.linalg.norm(Y)
    assert resid < 1e-3


def test_kernel_matvec_chunks_give_the_same_operator(rng):
    X = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    whole = _kernel_matvec(X, 0.3, 0.1, v, 50)
    for rows in (1, 7, 16):
        torch.testing.assert_close(_kernel_matvec(X, 0.3, 0.1, v, rows), whole, rtol=1e-6, atol=1e-6)
    assert _chunk_rows(50_000, 1 << 30) == 5368
    assert _chunk_rows(10, 1 << 30) == 10
    assert _chunk_rows(1 << 30, 1) == 1


def test_kernel_ridge_dense_linear_kernel(rng):
    X = rng.normal(size=(60, 4)).astype(np.float32)
    Y = rng.normal(size=(60, 2)).astype(np.float32)
    est = KernelRidgeRegression(kernel=LinearKernelGenerator(), lam=0.5, device="cpu")
    model = est.fit(X, Y)
    want = JKernelRidgeRegression(kernel=JLinearKernelGenerator(), lam=0.5).fit(X, Y)
    assert est.last_cg_iters == 0
    np.testing.assert_allclose(_np(model.alpha), np.asarray(want.alpha), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(model(torch.from_numpy(X))), np.asarray(want(X)), **SOLVE_TOL)
    alpha = np.linalg.solve(X.astype(np.float64) @ X.T + 0.5 * np.eye(60), Y.astype(np.float64))
    _close_rel(model.alpha, alpha)


@pytest.mark.parametrize("block_size", [7, 64, 4096])
def test_kernel_block_linear_mapper_predictions(rng, block_size):
    from keystone_tpu.nodes.learning.kernel_ridge import KernelBlockLinearMapper as JKernelBlockLinearMapper

    X_train = rng.normal(size=(50, 6)).astype(np.float32)
    alpha = rng.normal(size=(50, 3)).astype(np.float32)
    X = rng.normal(size=(9, 6)).astype(np.float32)
    got = KernelBlockLinearMapper(GaussianKernelGenerator(0.2), X_train, alpha, block_size, device="cpu")
    want = JKernelBlockLinearMapper(JGaussianKernelGenerator(0.2), X_train, alpha, block_size)
    np.testing.assert_allclose(_np(got(torch.from_numpy(X))), np.asarray(want(X)), **SOLVE_TOL)


def test_kernel_ridge_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="not both"):
        KernelRidgeRegression(kernel=GaussianKernelGenerator(1.0), gamma=2.0)
    with pytest.raises(ValueError, match="requires lam > 0"):
        KernelRidgeRegression(gamma=1.0, lam=0.0, precond_landmarks=4, device="cpu").fit(
            np.ones((8, 2), np.float32), np.ones(8, np.float32))
    with pytest.raises(ValueError, match="requires lam > 0"):
        JKernelRidgeRegression(gamma=1.0, lam=0.0, precond_landmarks=4).fit(
            np.ones((8, 2), np.float32), np.ones(8, np.float32))
