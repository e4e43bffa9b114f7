"""The port on the card: kernels against their plain versions.

These tests need a CUDA device and skip without one. They import nothing of
JAX, so on a machine with a card and no JAX they run without the suite's
conftest (which builds the JAX CPU mesh):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernel vs plain version on the card: the kernel's 3xTF32 tensor-core
products keep float32-level accuracy and the two differ in summation order,
so they are held at rtol 1e-4, atol 1e-5, at every serving bucket's width
and with variances near the 1e-4 floor. The SIFT front
is held against itself on the CPU at the descriptor tolerance of
tests/test_descriptors.py (rtol 2e-4, atol 2e-4), which cuDNN's TF32
convolutions would miss.
"""

import numpy as np
import pytest
import torch

import keystone_tpu_torch.ops.fisher_vector as fvo
from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
from keystone_tpu_torch.ops.sift import dense_sift

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-5)
DESC_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gmm_case(B, m, d, k, seed, zero_component=False, var_range=(0.5, 1.5), mu_scale=0.5):
    """Descriptors drawn from a random diagonal GMM, and that GMM."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, size=k)
    if zero_component:
        w[-1] = 0.0
    w /= w.sum()
    mu = mu_scale * rng.normal(size=(k, d))
    var = rng.uniform(*var_range, size=(k, d))
    z = rng.integers(0, k, size=(B, m))
    X = mu[z] + np.sqrt(var[z]) * rng.normal(size=(B, m, d))
    return [a.astype(np.float32) for a in (X, w, mu, var)]


@pytest.mark.parametrize(
    "B, m, d, k, zero_component",
    [
        (2, 3721, 64, 256, False),  # full width
        (1, 3721, 64, 256, False),  # a one-image request
        (3, 37, 64, 256, False),  # m shorter than one split
        (2, 1000, 64, 256, True),  # a starved component: zero block, no NaN
        (2, 100, 8, 16, False),  # the CPU tests' widths
        (3, 3721, 64, 256, False),  # the serving buckets of 3, 16 and 64 images
        (16, 3721, 64, 256, False),
        (64, 3721, 64, 256, False),
        (2, 500, 8, 5, False),  # k not a multiple of the 8-wide MMA tile
    ],
)
def test_kernel_matches_plain(cuda, B, m, d, k, zero_component):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(B, m, d, k, m, zero_component))
    before = fvo.LAUNCHES
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    assert fvo.LAUNCHES == before + 1
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    torch.cuda.synchronize()
    assert got.shape == (B, 2 * k * d) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, **TOL)


def test_kernel_matches_plain_near_floor_variances(cuda):
    # Variances uniform in 1e-4..1e-3, as a fitted GMM reaches, with the
    # means a few standard deviations apart.
    case = _gmm_case(3, 3721, 64, 256, 6, var_range=(1e-4, 1e-3), mu_scale=0.05)
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in case)
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    torch.testing.assert_close(got, ref, **TOL)


def test_two_launches_are_bitwise_equal(cuda):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(4, 3721, 64, 256, 5))
    ops = fvo.fv_operands(w, mu, var)
    first = fvo.fisher_vectors(X, ops)
    second = fvo.fisher_vectors(X, ops)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_node_on_the_card_launches_the_kernel(cuda):
    X, w, mu, var = _gmm_case(2, 300, 16, 8, 0)
    node = FisherVector(w, mu, var, device=cuda)
    before = fvo.LAUNCHES
    got = node(torch.from_numpy(X).to(cuda))
    assert fvo.LAUNCHES == before + 1
    want = FisherVector(w, mu, var, device="cpu")(torch.from_numpy(X))
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(1, 50, 12, 4, 0))
    with pytest.raises(ValueError, match="d in"):
        fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(1, 50, 16, 4, 0))
    ops = fvo.fv_operands(w, mu, var)
    with pytest.raises(ValueError, match="contiguous"):
        fvo.fisher_vectors(X[:, ::2], ops)
    with pytest.raises(ValueError, match="float32"):
        fvo.fisher_vectors(X.double(), ops)


def test_sift_on_the_card_matches_the_cpu(cuda):
    imgs = np.random.default_rng(1).uniform(size=(2, 64, 72)).astype(np.float32)
    want = dense_sift(torch.from_numpy(imgs))
    got = dense_sift(torch.from_numpy(imgs).to(cuda)).cpu()
    torch.testing.assert_close(got, want, **DESC_TOL)
