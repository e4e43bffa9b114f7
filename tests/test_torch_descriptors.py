"""The port's descriptor fronts held against the JAX package.

Port dense SIFT vs ``ops/sift_xla.py::dense_sift_xla`` (through
``SIFTExtractor(backend="xla")``), port LCS vs ``LCSExtractor``, and the
grayscale conversion, on the same numpy images, at the tolerance of
tests/test_descriptors.py (rtol 2e-4, atol 2e-4).
"""

import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.ops.sift_xla import dense_sift_xla
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
from keystone_tpu_torch.nodes.images.pixels import GrayScaler
from keystone_tpu_torch.ops.sift import dense_sift
from keystone_tpu_torch.workflow import on_device

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax(out):
    """A JAX transformer returns an array, a JAX pipeline a lazy result."""
    return np.asarray(out.get() if hasattr(out, "get") else out)


@pytest.mark.parametrize(
    "shape, step, bin_size", [((3, 48, 40), 4, 4), ((2, 37, 53), 5, 3)]
)
def test_dense_sift_matches_xla(shape, step, bin_size):
    imgs = np.random.default_rng(step).uniform(size=shape).astype(np.float32)
    ref = np.asarray(dense_sift_xla(imgs, step=step, bin_size=bin_size))
    got = dense_sift(torch.from_numpy(imgs), step=step, bin_size=bin_size).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_flat_image_gives_exact_zero_descriptors():
    imgs = np.full((2, 32, 32), 0.5, dtype=np.float32)
    got = dense_sift(torch.from_numpy(imgs)).numpy()
    ref = np.asarray(dense_sift_xla(imgs))
    assert got.shape == ref.shape
    assert (got == 0.0).all() and (ref == 0.0).all()


@pytest.mark.parametrize("nhw1", [True, False], ids=["NHW1", "NHW"])
def test_sift_extractor_matches_jax(nhw1):
    imgs = np.random.default_rng(1).uniform(size=(2, 36, 36, 1)).astype(np.float32)
    if not nhw1:
        imgs = imgs[..., 0]
    ref = _jax(JSIFTExtractor(scale_factor=2.0, backend="xla")(imgs))
    got = SIFTExtractor(scale_factor=2.0)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_sift_extractor_rejects_color():
    with pytest.raises(ValueError, match="grayscale"):
        SIFTExtractor()(torch.zeros((1, 32, 32, 3)))


def test_grayscale_matches_jax():
    imgs = np.random.default_rng(2).uniform(size=(2, 20, 24, 3)).astype(np.float32)
    ref = _jax(JGrayScaler()(imgs))
    got = GrayScaler()(torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape == (2, 20, 24, 1)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize(
    "shape, step, bin_size", [((3, 40, 36, 3), 4, 4), ((2, 37, 53, 3), 5, 3)]
)
def test_lcs_matches_jax(shape, step, bin_size):
    imgs = np.random.default_rng(3).uniform(size=shape).astype(np.float32)
    ref = _jax(JLCSExtractor(step=step, bin_size=bin_size)(imgs))
    node = LCSExtractor(step=step, bin_size=bin_size)
    got = node(torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape
    assert got.shape[1] == node.num_keypoints(shape[1], shape[2])
    np.testing.assert_allclose(got, ref, **TOL)


def test_gray_sift_chain_matches_jax():
    imgs = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    ref = _jax(JGrayScaler().and_then(JSIFTExtractor(backend="xla"))(imgs))
    with on_device("cpu"):
        got = GrayScaler().and_then(SIFTExtractor())(torch.from_numpy(imgs)).get().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
