"""The image descriptors of the port, held against the JAX package on the
CPU: ``utils/image.py``'s ``clamped_gradients`` and ``orientation_maps``
(signed and unsigned), ``HogExtractor`` and ``DaisyExtractor``, on RGB and
grey images of odd sizes, random and structured (ramps and steps, whose
angles fall on bin edges and on the wrap at 0 = period).

Tolerances:

- gradients: equal (central differences of the same floats);
- orientation maps: rtol 1e-5, atol 1e-6. ``atan2`` may differ by an ulp
  between XLA's and torch's CPU code; the soft binning is continuous across
  bin edges and the wrap, so an ulp of angle moves a map by about an ulp of
  magnitude, never a whole bin;
- HOG and DAISY: atol 1e-5 on descriptors of unit norm. The cell sums
  (HOG) and the box means (DAISY, three passes) add in another order than
  XLA's ``reduce_window``.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images.daisy import DaisyExtractor as JDaisyExtractor
from keystone_tpu.nodes.images.hog import HogExtractor as JHogExtractor
from keystone_tpu.utils.image import clamped_gradients as j_clamped_gradients
from keystone_tpu.utils.image import orientation_maps as j_orientation_maps
from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor
from keystone_tpu_torch.nodes.images.hog import HogExtractor
from keystone_tpu_torch.utils.image import clamped_gradients, orientation_maps

MAP_TOL = dict(rtol=1e-5, atol=1e-6)
DESC_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _structured(n, h, w):
    """Ramps, steps and a checkerboard: gradients along the axes and the
    diagonals, zero gradients, and angles of exactly 0, ±π/2 and π."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = [x / w, 1.0 - y / h, ((x + y) % 7 < 3).astype(np.float32), ((x // 4 + y // 4) % 2).astype(np.float32)]
    return np.stack([imgs[i % len(imgs)] for i in range(n)]).astype(np.float32)


def _gray(rng, n, h, w, structured):
    return _structured(n, h, w) if structured else rng.uniform(size=(n, h, w)).astype(np.float32)


@pytest.mark.parametrize("structured", [False, True])
def test_clamped_gradients_equal(rng, structured):
    g = _gray(rng, 4, 13, 17, structured)
    got = clamped_gradients(torch.from_numpy(g))
    want = j_clamped_gradients(g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("signed, num_bins", [(False, 9), (True, 8), (True, 5), (False, 4)])
@pytest.mark.parametrize("structured", [False, True])
def test_orientation_maps(rng, signed, num_bins, structured):
    g = _gray(rng, 4, 19, 23, structured)
    got = orientation_maps(torch.from_numpy(g), num_bins, signed)
    want = np.asarray(j_orientation_maps(g, num_bins, signed))
    assert got.shape == want.shape == (4, 19, 23, num_bins)
    np.testing.assert_allclose(got.numpy(), want, **MAP_TOL)
    # Each pixel's magnitude is split over its two bins, nothing lost.
    gx, gy = clamped_gradients(torch.from_numpy(g))
    torch.testing.assert_close(got.sum(-1), torch.sqrt(gx * gx + gy * gy), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "shape, structured, kw",
    [
        ((2, 37, 53, 3), False, {}),
        ((3, 41, 29, 1), False, {}),
        ((4, 33, 35, 1), True, {}),
        ((2, 30, 45, 3), False, dict(cell_size=6, num_bins=6, clip=0.3)),
    ],
)
def test_hog(rng, shape, structured, kw):
    if structured:
        X = _structured(shape[0], shape[1], shape[2])[..., None]
    else:
        X = rng.uniform(size=shape).astype(np.float32)
    got = HogExtractor(**kw)(torch.from_numpy(X))
    want = np.asarray(JHogExtractor(**kw)(X))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **DESC_TOL)


@pytest.mark.parametrize("h, w", [(15, 40), (40, 12)])
def test_hog_refuses_tiny_images(h, w):
    X = np.zeros((1, h, w, 1), np.float32)
    with pytest.raises(ValueError, match="too small for HOG") as got:
        HogExtractor()(torch.from_numpy(X))
    with pytest.raises(ValueError, match="too small for HOG") as want:
        JHogExtractor()(X)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "shape, structured, kw",
    [
        ((2, 37, 53, 3), False, {}),
        ((3, 41, 29, 1), False, dict(step=6, radius=8)),
        ((4, 35, 33, 1), True, dict(step=4, radius=6)),
        ((2, 31, 27, 3), False, dict(step=5, radius=7, rings=3, ring_points=6, num_bins=5)),
    ],
)
def test_daisy(rng, shape, structured, kw):
    if structured:
        X = _structured(shape[0], shape[1], shape[2])[..., None]
    else:
        X = rng.uniform(size=shape).astype(np.float32)
    port = DaisyExtractor(**kw)
    got = port(torch.from_numpy(X))
    want = np.asarray(JDaisyExtractor(**kw)(X))
    assert got.shape == want.shape
    assert got.shape[-1] == port.descriptor_dim == JDaisyExtractor(**kw).descriptor_dim
    np.testing.assert_allclose(got.numpy(), want, **DESC_TOL)


def test_daisy_refuses_images_inside_its_radius():
    X = np.zeros((1, 20, 40, 1), np.float32)
    with pytest.raises(ValueError, match="smaller than the DAISY radius"):
        DaisyExtractor()(torch.from_numpy(X))
