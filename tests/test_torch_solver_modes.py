"""The solver's precision and bfloat16 storage modes, held against the JAX
package (its mode set on ``keystone_tpu.config.config``, as
``tests/test_bf16_mode.py`` sets it).

With A stored in bfloat16 the two packages do the same arithmetic: A and
the row weights rounded to bfloat16, A_b·w rounded to bfloat16, every
product that touches A multiplying bfloat16 operands exactly into float32,
and the ridge gram symmetrized before its Cholesky factor. What differs is
the float32 summation order (the reference sums rows in its mesh's fold).
Where that moves a value of R across a bfloat16 rounding boundary, the
value moves by one bfloat16 step, 2^-8 of it, so W and b are held to the
reference's within 2^-8 of the largest |value|.

On the CPU every precision gives the float32 product, as JAX's CPU backend
does: ``high`` and ``default`` equal ``highest`` bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import keystone_tpu.linalg.bcd as jbcd_module
import keystone_tpu_torch.linalg.bcd as pbcd
from keystone_tpu.config import Config
from keystone_tpu.config import config as jconfig
from keystone_tpu.linalg import RowMatrix, assemble_blocks
from keystone_tpu.linalg import block_coordinate_descent as j_bcd
from keystone_tpu.linalg import block_coordinate_descent_streamed as j_bcd_streamed
from keystone_tpu.nodes.learning import BlockWeightedLeastSquaresEstimator as JBlockWLS
from keystone_tpu_torch.config import solver_precision, solver_storage_dtype
from keystone_tpu_torch.linalg.bcd import (
    block_coordinate_descent,
    block_coordinate_descent_streamed,
    prepare_block,
)
from keystone_tpu_torch.linalg.row_matrix import solver_matmul, storage_dtype
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator

BF16_STEP = 2.0**-8


def _problem(n=200, d=48, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) + 0.3 * rng.normal(size=(1, d))
    y = rng.choice(k, size=n, p=np.linspace(1, 3, k) / np.linspace(1, 3, k).sum())
    Y = 2.0 * np.eye(k)[y] - 1.0 + 0.1 * (X[:, :k] @ rng.normal(size=(k, k)))
    return X.astype(np.float32), Y.astype(np.float32), y


def _weights(y, k=3, mixture_weight=0.5):
    counts = np.maximum(np.bincount(y, minlength=k), 1)
    return ((1 - mixture_weight) + mixture_weight * len(y) / (k * counts))[y].astype(np.float32)


def _close_to_the_reference(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=BF16_STEP * np.abs(want).max())


@pytest.fixture
def ref_bf16(monkeypatch):
    monkeypatch.setattr(jconfig, "solver_storage_dtype", "bfloat16")


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("streamed", [False, True], ids=["dense", "streamed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_solves_match_the_reference(ref_bf16, seed, streamed, weighted):
    X, Y, y = _problem(seed=seed)
    center = X.mean(axis=0)
    w = _weights(y) if weighted else None
    kw = dict(block_size=16, num_iters=3, lam=0.1)
    B = RowMatrix.from_array(Y)
    jw = None if w is None else jnp.asarray(w)
    pw = None if w is None else torch.from_numpy(w)
    if streamed:
        want, _ = j_bcd_streamed(X, B, row_weights=jw, col_center=center, **kw)
        got, _ = block_coordinate_descent_streamed(X, torch.from_numpy(Y), row_weights=pw, col_center=center,
                                                   storage_dtype="bfloat16", **kw)
    else:
        A = X - center
        want, _ = j_bcd(RowMatrix.from_array(A, dtype=jnp.bfloat16), B, row_weights=jw, **kw)
        got, _ = block_coordinate_descent(torch.from_numpy(A).to(torch.bfloat16), torch.from_numpy(Y),
                                          row_weights=pw, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    _close_to_the_reference(torch.cat(got).numpy(), assemble_blocks(want))


@pytest.mark.parametrize("mixture_weight", [0.0, 0.5])
@pytest.mark.parametrize("stream", [False, True], ids=["dense", "streamed"])
def test_bfloat16_estimator_matches_the_reference(ref_bf16, stream, mixture_weight):
    X, Y, _ = _problem(seed=2)
    kw = dict(block_size=16, num_iters=3, lam=0.2, mixture_weight=mixture_weight, stream=stream)
    want = JBlockWLS(**kw).fit(X, Y)
    got = BlockWeightedLeastSquaresEstimator(device="cpu", storage_dtype="bfloat16", **kw).fit(X, Y)
    assert got.W.dtype == got.b.dtype == torch.float32
    _close_to_the_reference(got.W.numpy(), want.W)
    _close_to_the_reference(got.b.numpy(), want.b)
    # The mode is bfloat16's: not the float32 solve.
    f32 = BlockWeightedLeastSquaresEstimator(device="cpu", **kw).fit(X, Y)
    assert not torch.equal(got.W, f32.W)


@pytest.mark.parametrize("stream", [False, True], ids=["dense", "streamed"])
def test_a_is_stored_in_bfloat16_and_the_state_in_float32(monkeypatch, stream):
    X, Y, y = _problem(seed=3)
    seen = []
    for name in ("_solve_update", "_first_update"):
        real = getattr(pbcd, name)

        def hooked(a_b, aw, *args, real=real):
            out = real(a_b, aw, *args)
            seen.append((a_b.dtype, aw.dtype, *(t.dtype for t in args if torch.is_tensor(t)),
                         *(t.dtype for t in out)))
            return out

        monkeypatch.setattr(pbcd, name, hooked)
    head = BlockWeightedLeastSquaresEstimator(block_size=16, num_iters=2, lam=0.1, device="cpu",
                                              stream=stream, storage_dtype="bfloat16").fit(X, Y)
    assert head.W.dtype == torch.float32
    assert seen, "no block update ran"
    for a_dtype, aw_dtype, *state in seen:
        # A and A·w in bfloat16; the inverse, R and W_b in, and R, W_b (and
        # the inverse) out, in float32.
        assert (a_dtype, aw_dtype) == (torch.bfloat16, torch.bfloat16)
        assert set(state) == {torch.float32}


def test_the_streamed_block_is_centered_before_the_cast(monkeypatch, ref_bf16):
    """A column with a large mean: centered in float32 and then rounded, the
    block keeps its small values; rounded first, they would carry the
    mean's rounding error. The port's prepared block equals the
    reference's ``host_block`` bit for bit."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    X[:, 3] = 1000.0 + 0.01 * rng.normal(size=64).astype(np.float32)
    Y = rng.normal(size=(64, 2)).astype(np.float32)
    center = X.mean(axis=0)
    blocks = []
    real_jax = jbcd_module.jax

    class Recording:
        """The reference's jax module, with its host-to-device puts recorded."""

        def __getattr__(self, name):
            return getattr(real_jax, name)

        def device_put(self, x, *args, **kwargs):
            if isinstance(x, np.ndarray) and x.ndim == 2:
                blocks.append(np.array(x))
            return real_jax.device_put(x, *args, **kwargs)

    monkeypatch.setattr(jbcd_module, "jax", Recording())
    j_bcd_streamed(X, RowMatrix.from_array(Y), block_size=8, num_iters=1, lam=0.1, col_center=center)
    assert [b.shape for b in blocks] == [(64, 8), (64, 8)]
    A, c = torch.from_numpy(X), torch.from_numpy(center)
    for (s, e), want in zip(((0, 8), (8, 16)), blocks):
        out = torch.empty((64, e - s), dtype=torch.bfloat16)
        prepare_block(A, c, s, e, out)
        assert str(want.dtype) == "bfloat16"
        np.testing.assert_array_equal(out.float().numpy(), want.astype(np.float32))
    # Rounded first (bfloat16 steps are 4 apart near 1000), the column
    # would have lost its values.
    rounded_first = (A[:, 3].to(torch.bfloat16).float() - c[3]).numpy()
    assert np.unique(rounded_first).size == 1
    assert np.unique(blocks[0][:, 3]).size > 32


@pytest.mark.parametrize("raw", [None, "", "highest", "high", " DEFAULT ", "bogus"])
def test_the_precision_variable_parses_like_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("KEYSTONE_SOLVER_PRECISION", raising=False)
    else:
        monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", raw)
    if raw == "bogus":
        with pytest.raises(ValueError, match="KEYSTONE_SOLVER_PRECISION"):
            Config()
        with pytest.raises(ValueError, match="KEYSTONE_SOLVER_PRECISION"):
            solver_precision()
    else:
        assert solver_precision() == Config().solver_precision
    assert solver_precision("high") == "high"  # an argument wins
    with pytest.raises(ValueError, match="expected one of"):
        solver_precision("fast")


@pytest.mark.parametrize("raw", [None, "", "bfloat16", "float32", "bogus"])
def test_the_storage_variable_parses_like_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("KEYSTONE_SOLVER_DTYPE", raising=False)
    else:
        monkeypatch.setenv("KEYSTONE_SOLVER_DTYPE", raw)
    monkeypatch.setattr(jconfig, "solver_storage_dtype", Config().solver_storage_dtype)
    from keystone_tpu.linalg.row_matrix import storage_dtype as j_storage_dtype

    if raw == "bogus":
        with pytest.raises(TypeError):
            j_storage_dtype()
        with pytest.raises(ValueError, match="KEYSTONE_SOLVER_DTYPE"):
            storage_dtype()
    else:
        assert solver_storage_dtype() == str(j_storage_dtype())
        assert storage_dtype() == getattr(torch, str(j_storage_dtype()))
    assert storage_dtype("bfloat16") == torch.bfloat16  # an argument wins
    with pytest.raises(ValueError, match="expected one of"):
        storage_dtype("float16")


@pytest.mark.parametrize("precision", ["high", "default"])
def test_on_the_cpu_every_precision_gives_the_float32_result(precision):
    X, Y, y = _problem(seed=5)
    A, B, w = torch.from_numpy(X - X.mean(axis=0)), torch.from_numpy(Y), torch.from_numpy(_weights(y))
    want, _ = block_coordinate_descent(A, B, 16, 2, lam=0.1, row_weights=w, precision="highest")
    got, _ = block_coordinate_descent(A, B, 16, 2, lam=0.1, row_weights=w, precision=precision)
    assert torch.equal(torch.cat(got), torch.cat(want))
    got, _ = block_coordinate_descent_streamed(X, B, 16, 2, lam=0.1, row_weights=w, precision=precision,
                                               col_center=X.mean(axis=0))
    want, _ = block_coordinate_descent_streamed(X, B, 16, 2, lam=0.1, row_weights=w, precision="highest",
                                                col_center=X.mean(axis=0))
    assert torch.equal(torch.cat(got), torch.cat(want))


def test_a_bfloat16_product_is_exact_into_float32():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(40, 300)).astype(np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    got = solver_matmul(x, y)
    assert got.dtype == torch.float32
    exact = x.double() @ y.to(torch.bfloat16).double()  # y rounded to bfloat16, products exact
    torch.testing.assert_close(got.double(), exact, rtol=0, atol=300 * 2.0**-24 * float(exact.abs().max()))
    assert not torch.allclose(got, x.float() @ y, rtol=0, atol=1e-6)  # y was rounded


@pytest.mark.parametrize("first, second", [("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("streamed", [False, True], ids=["dense", "streamed"])
def test_a_checkpoint_of_another_storage_dtype_is_ignored_with_a_warning(tmp_path, streamed, first, second):
    X, Y, _ = _problem(seed=7)
    center = X.mean(axis=0)
    B = torch.from_numpy(Y)
    ck = str(tmp_path / "ck")

    def solve(dtype, checkpoint_dir=None):
        if streamed:
            return block_coordinate_descent_streamed(X, B, 16, 1, lam=0.1, col_center=center, storage_dtype=dtype,
                                                     checkpoint_dir=checkpoint_dir)[0]
        A = torch.from_numpy(X - center).to(getattr(torch, dtype))
        return block_coordinate_descent(A, B, 16, 1, lam=0.1, checkpoint_dir=checkpoint_dir)[0]

    solve(first, ck)
    want = torch.cat(solve(second))
    with pytest.warns(UserWarning, match="different solve"):
        got = torch.cat(solve(second, ck))
    assert torch.equal(got, want)
