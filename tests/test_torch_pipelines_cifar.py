"""RandomPatchCifar, LinearPixels and their parts in the port, held against
the JAX package on the CPU.

- Loaders (the binary fixture, synthetic with and without label noise),
  ``RandomPatcher``, ``Windower``, ``Cropper``, ``ImageVectorizer``,
  ``SymmetricRectifier`` and ``Pooler`` at ``max``: the same arrays, bit
  for bit (gathers, slices and maxima round nothing). ``PixelScaler``:
  rtol 1e-6, atol 1e-6 (one division). ``Pooler`` at ``sum`` and
  ``mean``: within 1e-6 of the largest |output| (float32 sums of up to 169
  terms in another order).
- ``Convolver`` in float32, with and without the ZCA fold: rtol 1e-5, atol
  1e-5 of the largest |output| (float32 sums of 108 products in another
  order). In ``bfloat16`` both take bfloat16 operands into float32 sums:
  atol 1e-4 of the largest |output|, the same sums in another order and
  each product exact.
- ``ZCAWhitenerEstimator.fit``: the mean within 1e-6 and the whitener within
  rtol 1e-4, atol 1e-4 of its largest entry (eigh in float32; the whitener
  does not depend on the eigenvectors' signs).
- RandomPatchCifar at 512 images, 32 filters and 2,000 patches: the port's
  own filters (same patches, same filter picks) within 1e-3 of the
  reference's largest |filter| and bias; with the reference's Convolver
  carried across, features within 1e-4 of the largest |feature|, the head
  (block least squares) fitted on them, test scores within 1e-3 of the
  largest |score| and predictions equal but for at most one of the 256
  test images. LinearPixels: W and b within rtol 1e-3, atol 1e-4 and
  predictions equal but for one. Both ``run``s reach the reference's test
  accuracy within 0.02.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.cifar import CifarLoader as JCifarLoader
from keystone_tpu.nodes.images import Convolver as JConvolver
from keystone_tpu.nodes.images import Pooler as JPooler
from keystone_tpu.nodes.images import SymmetricRectifier as JSymmetricRectifier
from keystone_tpu.nodes.images.patches import Cropper as JCropper
from keystone_tpu.nodes.images.patches import RandomPatcher as JRandomPatcher
from keystone_tpu.nodes.images.patches import Windower as JWindower
from keystone_tpu.nodes.images.pixels import ImageVectorizer as JImageVectorizer
from keystone_tpu.nodes.images.pixels import PixelScaler as JPixelScaler
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBlockLeastSquares
from keystone_tpu.nodes.learning import LinearMapper as JLinearMapper
from keystone_tpu.nodes.learning import ZCAWhitenerEstimator as JZCAWhitenerEstimator
from keystone_tpu.nodes.util import ClassLabelIndicators as JClassLabelIndicators
from keystone_tpu.pipelines.images import linear_pixels as ref_lp
from keystone_tpu.pipelines.images import random_patch_cifar as ref
from keystone_tpu_torch.convert import convolver_from_numpy, zca_from_numpy
from keystone_tpu_torch.loaders.cifar import CifarLoader
from keystone_tpu_torch.nodes.images.convolver import Convolver
from keystone_tpu_torch.nodes.images.patches import Cropper, RandomPatcher, Windower
from keystone_tpu_torch.nodes.images.pixels import ImageVectorizer, PixelScaler
from keystone_tpu_torch.nodes.images.pooling import Pooler, SymmetricRectifier
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.pipelines.images import linear_pixels as port_lp
from keystone_tpu_torch.pipelines.images import random_patch_cifar as port
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapper
from keystone_tpu_torch.workflow import PipelineDataset, on_device

CIFAR_FIXTURE = "tests/fixtures/data/cifar/data_batch.bin"


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _ref(node, X) -> np.ndarray:
    out = node(X)
    return np.asarray(out.get() if hasattr(out, "get") else out)


def _close_to_max(got, want, tol):
    """|got − want| within ``tol`` times the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), tol * scale)


def _port(node, X):
    """A port node or pipeline on X on the CPU, as numpy (a pipeline's
    result is lazy)."""
    with torch.inference_mode(), on_device("cpu"):
        out = node(torch.from_numpy(np.ascontiguousarray(X)))
        return (out.get() if isinstance(out, PipelineDataset) else out).numpy()


def _own(pipeline, cls):
    """The one node of type ``cls`` of a fitted port pipeline (searched
    through fused chains and gathered branches)."""
    def flat(t):
        for part in getattr(t, "stages", None) or getattr(t, "branches", None) or [t]:
            yield from ([part] if part is t else flat(part))

    (found,) = [n for t in pipeline.fit().transformers() for n in flat(t) if isinstance(n, cls)]
    return found


def _fitted(pipeline, cls):
    """The one node of type ``cls`` of a reference pipeline, its estimators
    fitted (a fitted chain may come back fused: its stages are searched)."""
    nodes = [t for t in pipeline.fit().transformers() for t in getattr(t, "stages", [t])]
    (found,) = [t for t in nodes if isinstance(t, cls)]
    return found


# --- loaders ---------------------------------------------------------------


def test_binary_fixture_loads_bit_equal():
    got, want = CifarLoader.load(CIFAR_FIXTURE), JCifarLoader.load(CIFAR_FIXTURE)
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)


def test_binary_of_the_wrong_size_raises(tmp_path):
    path = tmp_path / "short.bin"
    path.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="not CIFAR-10"):
        CifarLoader.load(str(path))


@pytest.mark.parametrize("noise", ["", "0.2"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_bit_equal(monkeypatch, seed, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    for got, want in zip(CifarLoader.synthetic(n=64, seed=seed), JCifarLoader.synthetic(n=64, seed=seed)):
        _equal(got.data, want.data)
        _equal(got.labels, want.labels)


# --- patches and pixels ----------------------------------------------------


@pytest.mark.parametrize("num_patches, size, seed", [(50, 5, 3), (7, 16, 0), (20, 1, 9)])
def test_random_patcher_bit_equal(rng, num_patches, size, seed):
    X = rng.uniform(size=(7, 16, 16, 3)).astype(np.float32)
    got = _port(RandomPatcher(num_patches, size, seed=seed), X)
    _equal(got, _ref(JRandomPatcher(num_patches, size, seed=seed), X))
    assert not RandomPatcher(1, 1).row_independent


@pytest.mark.parametrize("stride, window", [(1, 3), (2, 4), (5, 5)])
def test_windower_bit_equal(rng, stride, window):
    X = rng.uniform(size=(2, 11, 13, 3)).astype(np.float32)
    _equal(_port(Windower(stride, window), X), _ref(JWindower(stride, window), X))


def test_cropper_and_pixels(rng):
    X = rng.uniform(size=(3, 10, 12, 3)).astype(np.float32)
    _equal(_port(Cropper(1, 2, 6, 7), X), _ref(JCropper(1, 2, 6, 7), X))
    with pytest.raises(ValueError, match="exceeds"):
        _port(Cropper(5, 0, 6, 3), X)
    with pytest.raises(ValueError, match="invalid"):
        Cropper(-1, 0, 2, 2)
    _equal(_port(ImageVectorizer(), X), _ref(JImageVectorizer(), X))
    U = (255 * X).astype(np.float32)
    np.testing.assert_allclose(_port(PixelScaler(), U), _ref(JPixelScaler(), U), rtol=1e-6, atol=1e-6)


# --- convolution, rectification, pooling, ZCA ------------------------------


def _zca_pair(rng, d=48, n=400):
    P = (rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32) + 0.5
    return P, JZCAWhitenerEstimator(eps=0.1).fit(P), ZCAWhitenerEstimator(eps=0.1, device="cpu").fit(P)


def test_zca_fit(rng):
    P, want, got = _zca_pair(rng)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=0, atol=1e-6)
    _close_to_max(got.whitener.numpy(), want.whitener, 1e-4)
    _close_to_max(_port(got, P[:10]), _ref(want, P[:10]), 1e-4)
    carried = zca_from_numpy(want.whitener, want.mean, device="cpu")
    _close_to_max(_port(carried, P[:10]), _ref(want, P[:10]), 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_convolver_float32(rng, stride):
    X = rng.uniform(size=(3, 12, 12, 3)).astype(np.float32)
    F = rng.normal(size=(5, 4, 4, 3)).astype(np.float32)
    want = _ref(JConvolver(F, stride=stride), X)
    for dtype in (None, "float32"):
        got = _port(Convolver(F, stride=stride, compute_dtype=dtype, device="cpu"), X)
        _close_to_max(got, want, 1e-5)
    with pytest.raises(ValueError, match="compute_dtype"):
        Convolver(F, compute_dtype="float16", device="cpu")


def test_convolver_folds_the_whitener(rng):
    _, jwhite, white = _zca_pair(rng, d=4 * 4 * 3)
    X = rng.uniform(size=(3, 10, 10, 3)).astype(np.float32)
    F = rng.normal(size=(6, 4, 4, 3)).astype(np.float32)
    jconv = JConvolver(F, whitener=jwhite)
    conv = Convolver(F, whitener=zca_from_numpy(jwhite.whitener, jwhite.mean, device="cpu"), device="cpu")
    _close_to_max(conv.filters.numpy(), jconv.filters, 1e-5)
    _close_to_max(conv.bias.numpy(), jconv.bias, 1e-5)
    _close_to_max(_port(conv, X), _ref(jconv, X), 1e-5)
    carried = convolver_from_numpy(jconv.filters, jconv.bias, device="cpu")
    _close_to_max(_port(carried, X), _ref(jconv, X), 1e-5)
    with pytest.raises(ValueError, match="not both"):
        Convolver(F, whitener=white, bias=np.zeros(6, np.float32), device="cpu")


def test_convolver_bfloat16(rng):
    X = rng.uniform(size=(3, 12, 12, 3)).astype(np.float32)
    F = rng.normal(size=(5, 6, 6, 3)).astype(np.float32)
    want = _ref(JConvolver(F, compute_dtype="bfloat16"), X)
    conv = Convolver(F, compute_dtype="bfloat16", device="cpu")
    assert conv.compute_dtype == "bfloat16"
    got = _port(conv, X)
    assert got.dtype == np.float32
    _close_to_max(got, want, 1e-4)
    # Rounding the operands matters: float32 is further away than that.
    f32 = _port(Convolver(F, device="cpu"), X)
    assert np.abs(f32 - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("alpha, max_val", [(0.0, 0.0), (0.25, 0.0), (0.1, -0.5)])
def test_symmetric_rectifier(rng, alpha, max_val):
    X = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    _equal(_port(SymmetricRectifier(alpha, max_val), X), _ref(JSymmetricRectifier(alpha, max_val), X))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("stride, size", [(13, 13), (2, 3), (4, 5)])
def test_pooler(rng, mode, stride, size):
    X = rng.normal(size=(2, 27, 27, 6)).astype(np.float32)
    got, want = _port(Pooler(stride, size, mode), X), _ref(JPooler(stride, size, mode), X)
    if mode == "max":
        _equal(got, want)
    else:
        _close_to_max(got, want, 1e-6)
    with pytest.raises(ValueError, match="pooling mode"):
        Pooler(2, 2, "median")


# --- the pipelines ---------------------------------------------------------


SMALL = dict(synthetic_n=512, num_filters=32, patch_sample=2000, num_iters=2, lam=5.0)


@pytest.fixture(scope="module")
def cifar_small():
    return JCifarLoader.synthetic(n=SMALL["synthetic_n"])


@pytest.mark.parametrize("feature_dtype", [None, "bfloat16"])
def test_random_patch_cifar_matches(cifar_small, feature_dtype):
    train, test = cifar_small
    conf = ref.RandomPatchCifarConfig(**SMALL, feature_dtype=feature_dtype)
    jfeat = ref.build_featurizer(conf, train.data)
    jconv = _fitted(jfeat, JConvolver)
    pconf = port.RandomPatchCifarConfig(**SMALL, feature_dtype=feature_dtype)
    # The port's own fit: the same patches and filter picks, filters from
    # its own ZCA.
    own = port.build_featurizer(pconf, train.data, device="cpu")
    conv = _own(own, Convolver)
    _close_to_max(conv.filters.numpy(), jconv.filters, 1e-3)
    _close_to_max(conv.bias.numpy(), jconv.bias, 1e-3)

    feat = port.conv_featurizer(
        pconf, convolver_from_numpy(jconv.filters, jconv.bias, compute_dtype=feature_dtype, device="cpu"))
    got_f, want_f = _port(feat, test.data), _ref(jfeat, test.data)
    assert got_f.shape == want_f.shape == (len(test.data), 2 * 2 * 2 * 32)
    _close_to_max(got_f, want_f, 1e-4)

    targets = JClassLabelIndicators(10)(train.labels)
    jscored = jfeat.and_then(JBlockLeastSquares(block_size=conf.block_size, num_iters=conf.num_iters,
                                                 lam=conf.lam), train.data, targets)
    solver = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam)
    scored = feat.and_then(solver, train.data, ClassLabelIndicators(10)(torch.as_tensor(train.labels)))
    got_s, want_s = _port(scored, test.data), _ref(jscored, test.data)
    _close_to_max(got_s, want_s, 1e-3)
    got_p = _port(scored.and_then(MaxClassifier()), test.data)
    assert (got_p != want_s.argmax(axis=1)).sum() <= 1


def test_random_patch_cifar_run_and_main():
    want = ref.run(ref.RandomPatchCifarConfig(**SMALL))
    got = port.run(port.RandomPatchCifarConfig(**SMALL), device="cpu")
    assert set(got) == set(want)
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 0.02, (got["summary"], want["summary"])
    out = port.main(["--device", "cpu", "--synthetic-n", "256", "--num-filters", "8",
                     "--feature-dtype", "bfloat16", "--num-iters", "1"])
    assert 0.0 <= out["test_accuracy"] <= 1.0
    with pytest.raises(ValueError, match="--test"):
        port.run(port.RandomPatchCifarConfig(train_path=CIFAR_FIXTURE), device="cpu")


def test_linear_pixels_matches(cifar_small):
    train, test = cifar_small
    conf = ref_lp.LinearPixelsConfig(synthetic_n=SMALL["synthetic_n"])
    from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
    from keystone_tpu.nodes.images import ImageVectorizer as JImageVectorizer2
    from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMapEstimator

    jpipe = JGrayScaler().and_then(JImageVectorizer2()).and_then(
        JLinearMapEstimator(lam=conf.lam), train.data, JClassLabelIndicators(10)(train.labels))
    pipe = port_lp.fit(port_lp.LinearPixelsConfig(synthetic_n=SMALL["synthetic_n"]), train.data, train.labels,
                       device="cpu")
    jmap, mapper = _fitted(jpipe, JLinearMapper), _own(pipe, LinearMapper)
    np.testing.assert_allclose(mapper.W.numpy(), np.asarray(jmap.W), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mapper.b.numpy(), np.asarray(jmap.b), rtol=1e-3, atol=1e-4)
    got_p = _port(pipe, test.data)
    assert got_p.dtype == np.int32 and (got_p != _ref(jpipe, test.data).argmax(axis=1)).sum() <= 1

    want = ref_lp.run(conf)
    got = port_lp.run(port_lp.LinearPixelsConfig(synthetic_n=SMALL["synthetic_n"]), device="cpu")
    assert set(got) == set(want) and abs(got["test_accuracy"] - want["test_accuracy"]) <= 0.02
    assert 0.0 <= port_lp.main(["--device", "cpu", "--synthetic-n", "256"])["test_accuracy"] <= 1.0
