"""The port's native host library, held against the reference's on the CPU.

The port builds its own copy of the reference's C++ (``csrc/native/``) with
the reference Makefile's flags (``build.native_library``); importing the
reference's binding runs its own ``make``, as its own tests do. Both
libraries load into this one process, so they run under the same
``OMP_NUM_THREADS`` and the same OpenMP runtime.

- ``dense_sift``, ``gmm_fit``, ``fisher_vector`` and ``decode_jpeg_batch``:
  bit-equal to the reference library's outputs (the same source, compiler
  and flags; every reduction is per image or per thread in a static
  schedule);
- the backends through the port's nodes against the reference's nodes:
  ``SIFTExtractor(backend="native")`` and ``FisherVector(backend="native")``
  bit-equal; ``GMMFisherVectorEstimator(gmm_backend="native")`` bit-equal
  (the same descriptor sample, then the same C++ EM); native SIFT against
  the port's ``xla`` SIFT within the reference's descriptor tolerance, rtol
  2e-4, atol 2e-4 (``tests/test_descriptors.py:136-145``);
- with the build forced to fail (``monkeypatch``), every explicitly native
  backend raises with the compiler's output, and ``auto`` takes the port's
  own route.

torch runs on two threads here, restored after the module.
"""

import io

import numpy as np
import pytest
import torch

from keystone_tpu import native as jnative
from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
from keystone_tpu.nodes.images.external.fisher_vector import (
    GMMFisherVectorEstimator as JGMMFisherVectorEstimator,
)
from keystone_tpu.nodes.images.external.sift import SIFTExtractor as JSIFTExtractor
from keystone_tpu_torch import build, native
from keystone_tpu_torch.nodes.images.external.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
    fit_fisher_featurizer,
)
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.workflow import on_device

DESC_TOL = dict(rtol=2e-4, atol=2e-4)
COMPILER_OUTPUT = "sift.cpp:1:1: error: forced by the test"


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not jnative.available():
        pytest.fail(f"the reference's native library did not build: {jnative.build_error()}")
    assert native.available(), native.build_error()


@pytest.fixture
def broken_build(monkeypatch):
    """The port's library as if ``g++`` had failed: the binding forgets the
    loaded library and its next build raises with the compiler's output."""

    def fail():
        raise RuntimeError(f"g++ failed for sift.cpp (rc 1):\n{COMPILER_OUTPUT}")

    monkeypatch.setattr(build, "native_library", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_has_jpeg", False)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _jpegs(rng, sizes, mode="RGB"):
    from PIL import Image

    bufs = []
    for h, w in sizes:
        arr = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        im = Image.fromarray(arr).convert(mode)
        out = io.BytesIO()
        im.save(out, format="JPEG", quality=90)
        bufs.append(out.getvalue())
    return bufs


# --- the library, function by function ---------------------------------------


@pytest.mark.parametrize("shape, step, bin_size", [((3, 37, 45), 4, 4), ((2, 64, 48), 8, 4), ((1, 40, 53), 5, 3)])
def test_dense_sift_bit_equal(rng, shape, step, bin_size):
    imgs = rng.uniform(size=shape).astype(np.float32)
    _equal(native.dense_sift(imgs, step, bin_size), jnative.dense_sift(imgs, step, bin_size))
    assert native.sift_num_keypoints(shape[1], shape[2], step, bin_size) == jnative.sift_num_keypoints(
        shape[1], shape[2], step, bin_size
    )
    flat = np.full((1, 32, 32), 0.5, np.float32)
    _equal(native.dense_sift(flat), jnative.dense_sift(flat))
    with pytest.raises(ValueError, match="bad SIFT grid"):
        native.sift_num_keypoints(8, 8, 0, 4)


@pytest.mark.parametrize("k, iters, seed", [(2, 10, 1), (5, 25, 0), (16, 3, 7)])
def test_gmm_fit_bit_equal(rng, k, iters, seed):
    X = np.concatenate([rng.normal(-2, 0.5, (400, 6)), rng.normal(2, 1.0, (900, 6))]).astype(np.float32)
    for got, want in zip(native.gmm_fit(X, k, iters, seed), jnative.gmm_fit(X, k, iters, seed)):
        _equal(got, want)


def test_fisher_vector_bit_equal(rng):
    X = rng.normal(size=(2000, 8)).astype(np.float32)
    w, mu, var = jnative.gmm_fit(X, 6, 8, 2)
    for m in (1, 37, 500):
        _equal(native.fisher_vector(X[:m], w, mu, var), jnative.fisher_vector(X[:m], w, mu, var))


def test_decode_jpeg_batch_bit_equal(rng):
    bufs = _jpegs(rng, [(50, 40), (375, 500), (33, 97), (256, 256)]) + _jpegs(rng, [(70, 60)], mode="L")
    for size in (32, 64):
        _equal(native.decode_jpeg_batch(bufs, size), jnative.decode_jpeg_batch(bufs, size))
    _equal(native.decode_jpeg_batch([], 8), jnative.decode_jpeg_batch([], 8))
    # libjpeg gives no RGB for a CMYK file: both fail on the same image.
    cmyk = _jpegs(rng, [(40, 40)], mode="CMYK")
    for lib in (native, jnative):
        with pytest.raises(ValueError, match="failed at image 2"):
            lib.decode_jpeg_batch(bufs[:2] + cmyk + bufs[2:], 16)


def test_library_is_named_by_its_sources_and_flags():
    path, jpeg = build.native_library()
    assert path.parent == build.BUILD_DIR and path.exists() and jpeg == native.jpeg_available()
    sources = (*build.NATIVE_SOURCES, build.NATIVE_JPEG_SOURCE) if jpeg else build.NATIVE_SOURCES
    host = build.native_host(build.cxx())
    assert build.native_library_path(sources, jpeg, host) == path
    assert build.native_library_path(build.NATIVE_SOURCES, False, host) != path
    # Built for another processor, it is another library.
    assert build.native_library_path(sources, jpeg, "another host") != path
    # The probe's answer is kept for this host, and read back.
    marker = build.BUILD_DIR / f"native-jpeg-{host}.txt"
    assert marker.read_text() == ("1" if jpeg else "0")
    assert build.native_has_jpeg(build.cxx(), host) == jpeg


# --- the backends, through the port's nodes ------------------------------------


def test_native_sift_node_equals_the_reference_and_the_device_path(rng):
    imgs = rng.uniform(size=(2, 40, 44, 1)).astype(np.float32)
    got = SIFTExtractor(step=4, backend="native", scale_factor=2.0)(torch.from_numpy(imgs))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _equal(got.numpy(), np.asarray(JSIFTExtractor(step=4, backend="native", scale_factor=2.0)(imgs)))
    xla = SIFTExtractor(step=4, backend="xla", scale_factor=2.0)(torch.from_numpy(imgs))
    np.testing.assert_allclose(xla.numpy(), got.numpy(), **DESC_TOL)
    # NHW input as well as NHW1.
    _equal(SIFTExtractor(step=4, backend="native")(torch.from_numpy(imgs[..., 0])).numpy(),
           jnative.dense_sift(imgs[..., 0], 4, 4))


def test_native_fisher_vector_node_equals_the_reference(rng):
    X = rng.normal(size=(3, 120, 8)).astype(np.float32)
    w, mu, var = jnative.gmm_fit(X.reshape(-1, 8), 4, 10, 0)
    got = FisherVector(w, mu, var, device="cpu", backend="native")(torch.from_numpy(X))
    _equal(got.numpy(), np.asarray(JFisherVector(w, mu, var, backend="native")(X)))
    # The port's kernel path encodes the same vectors, summed in another order.
    plain = FisherVector(w, mu, var, device="cpu")(torch.from_numpy(X))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-3, atol=1e-4)


def test_native_gmm_backend_equals_the_reference(rng):
    sets = rng.normal(size=(6, 150, 5)).astype(np.float32)
    port = GMMFisherVectorEstimator(k=3, em_iters=7, sample_size=500, seed=4, device="cpu",
                                    gmm_backend="native").fit(sets)
    ref = JGMMFisherVectorEstimator(k=3, em_iters=7, sample_size=500, seed=4, gmm_backend="native").fit(sets)
    for name in ("weights", "means", "variances"):
        _equal(getattr(port, name).numpy(), getattr(ref, name))
    assert GMMFisherVectorEstimator(k=3, gmm_backend="auto").gmm_backend == "native"
    assert GMMFisherVectorEstimator(k=3).gmm_backend == "tpu"
    with pytest.raises(ValueError, match="GMM backend"):
        GMMFisherVectorEstimator(k=3, gmm_backend="cuda")


def test_native_fisher_featurizer_runs_the_host_encoder(rng):
    images = rng.uniform(size=(6, 24, 24, 1)).astype(np.float32)
    front = SIFTExtractor(step=4, backend="native")
    pipe = fit_fisher_featurizer(front, images, pca_dims=8, gmm_k=2, em_iters=3, sample_size=200,
                                 device="cpu", backend="native")
    fv = [s for s in pipe.transformers() if isinstance(s, FisherVector)]
    assert len(fv) == 1 and fv[0].backend == "native"
    with on_device("cpu"):
        out = pipe(torch.from_numpy(images)).get()
    assert out.shape == (6, 2 * 2 * 8) and torch.isfinite(out).all()


# --- a build that fails ------------------------------------------------------------


def test_explicit_native_backends_raise_with_the_compiler_output(broken_build, rng):
    assert not native.available() and not native.jpeg_available()
    assert COMPILER_OUTPUT in native.build_error()
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        SIFTExtractor(backend="native")
    w, mu, var = np.full(2, 0.5, np.float32), np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        FisherVector(w, mu, var, device="cpu", backend="native")
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        GMMFisherVectorEstimator(k=2, gmm_backend="native")
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        native.dense_sift(np.zeros((1, 16, 16), np.float32))
    # ``auto`` takes the port's own EM.
    assert GMMFisherVectorEstimator(k=2, gmm_backend="auto").gmm_backend == "tpu"
