"""VOCSIFTFisher and its loader in the port, held against the JAX package on
the CPU.

- ``VOCLoader.load`` on the JPEG and XML fixtures, and ``synthetic`` with
  and without label noise: the same arrays, bit for bit.
- The backends: ``sift_backend="native"`` and ``fv_backend="native"`` run
  the port's build of the reference's host C++ kernels, and raise with the
  compiler's output where that build fails (forced here); ``tpu`` and
  ``pallas`` name the port's Fisher-vector kernel. The port's default SIFT
  backend is ``xla``. ``main`` with both native backends reaches the mAP
  of the reference's ``run`` at its native defaults within 0.05.
- The mean average precision of the same scores: equal to 1e-12.
- The pipeline at 48 images of 64×64, 4 classes, ``pca_dims=16``,
  ``gmm_k=4``: the reference is fitted with its XLA SIFT and its Fisher
  vector reached through the ``tpu`` backend (its jnp math), as its own
  tests reach it on the CPU. With its PCA and GMM carried across, the
  port's features are within 1e-3 of the largest |feature| (SIFT within
  its descriptor tolerance 2e-4, then PCA, the Fisher vector and the
  signed square root, which magnifies differences near 0); the head
  fitted on them gives test scores within 1e-2 of the largest |score|, and
  the whole fitted pipeline carried by ``convert.voc_params_from_numpy``
  gives the reference's scores within 1e-3. mAPs within 0.02; the port's
  ``run`` reaches the reference ``run``'s mAP within 0.05.

torch runs on two threads here, restored after the module.
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu.evaluation.mean_average_precision import (
    MeanAveragePrecisionEvaluator as JMeanAveragePrecisionEvaluator,
)
from keystone_tpu.loaders.voc import VOCLoader as JVOCLoader
from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBlockLeastSquares
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.nodes.learning.block_least_squares import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.pipelines.images import voc_sift_fisher as ref
from keystone_tpu_torch.convert import voc_params_from_numpy
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.voc import VOC_CLASSES, VOCLoader
from keystone_tpu_torch.nodes.images.external.fisher_vector import fit_fisher_featurizer
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.pipelines.images import voc_sift_fisher as port
from keystone_tpu_torch.workflow import PipelineDataset, on_device

VOC = os.path.join("tests", "fixtures", "data", "voc")


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
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, tol * scale)


def _port(node, X):
    """A port node or pipeline on X on the CPU, as numpy (a pipeline's
    result is lazy)."""
    with torch.inference_mode(), on_device("cpu"):
        out = node(torch.from_numpy(np.ascontiguousarray(X)))
        return (out.get() if isinstance(out, PipelineDataset) else out).numpy()


def _fitted(pipeline, cls):
    """The one node of type ``cls`` of a reference pipeline, its estimators
    fitted (a fitted chain may come back fused: its stages are searched)."""
    nodes = [t for t in pipeline.fit().transformers() for t in getattr(t, "stages", [t])]
    (found,) = [t for t in nodes if isinstance(t, cls)]
    return found


# --- the loader ------------------------------------------------------------


@pytest.mark.parametrize("size, workers", [(32, 2), (128, 16)])
def test_fixture_loads_bit_equal(size, workers):
    args = (os.path.join(VOC, "JPEGImages"), os.path.join(VOC, "Annotations"))
    got, want = VOCLoader.load(*args, size=size, workers=workers), JVOCLoader.load(*args, size=size, workers=workers)
    assert got.data.shape == (3, size, size, 3) and got.labels.shape == (3, len(VOC_CLASSES))
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)
    few = ("car", "person", "dog")
    _equal(VOCLoader.load(*args, size=16, classes=few).labels, JVOCLoader.load(*args, size=16, classes=few).labels)


@pytest.mark.parametrize("noise", ["", "0.25"])
@pytest.mark.parametrize("seed, classes", [(0, 6), (2, 20)])
def test_synthetic_bit_equal(monkeypatch, seed, classes, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    got = VOCLoader.synthetic(n=24, num_classes=classes, size=32, seed=seed)
    want = JVOCLoader.synthetic(n=24, num_classes=classes, size=32, seed=seed)
    for g, w in zip(got, want):
        _equal(g.data, w.data)
        _equal(g.labels, w.labels)
    assert VOCLoader.SYNTH_PRESENT_CLASSES_MEAN == JVOCLoader.SYNTH_PRESENT_CLASSES_MEAN


# --- backends and the evaluator --------------------------------------------


COMPILER_OUTPUT = "sift.cpp:1:1: error: forced by the test"


def test_native_backends_raise_and_xla_is_the_default(monkeypatch):
    """``xla`` stays the port's default SIFT backend, where the reference's
    is ``native``. With the port's native build forced to fail, the native
    SIFT and Fisher-vector backends raise with the compiler's output; an
    unknown backend raises in any case."""
    from keystone_tpu_torch import build, native

    assert port.VOCSIFTFisherConfig().sift_backend == "xla"
    assert ref.VOCSIFTFisherConfig().sift_backend == "native"
    assert SIFTExtractor().backend == "xla"
    with pytest.raises(ValueError, match="SIFT backend"):
        SIFTExtractor(backend="gpu")
    images = np.zeros((2, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="Fisher-vector backend"):
        fit_fisher_featurizer(SIFTExtractor(), images, pca_dims=8, gmm_k=2, backend="cuda", device="cpu")

    def fail():
        raise RuntimeError(f"g++ failed for sift.cpp (rc 1):\n{COMPILER_OUTPUT}")

    monkeypatch.setattr(build, "native_library", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        SIFTExtractor(backend="native")
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        fit_fisher_featurizer(SIFTExtractor(), images, pca_dims=8, gmm_k=2, backend="native", device="cpu")
    with pytest.raises(RuntimeError, match=COMPILER_OUTPUT):
        port.main(["--device", "cpu", "--sift-backend", "native"])


def test_native_backends_run_the_pipeline():
    """Native SIFT and the native Fisher vector through ``run``: the
    reference's ``run`` at its native defaults (native SIFT, and its GMM by
    the native EM) reaches the same mAP within 0.05, and the port's native
    SIFT run within 0.05 of its ``xla`` run."""
    want = ref.run(ref.VOCSIFTFisherConfig(**SMALL))
    native_run = port.run(port.VOCSIFTFisherConfig(**SMALL, sift_backend="native", fv_backend="native"),
                          device="cpu")
    xla_run = port.run(port.VOCSIFTFisherConfig(**SMALL), device="cpu")
    assert abs(native_run["map"] - want["map"]) <= 0.05, (native_run["summary"], want["summary"])
    assert abs(native_run["map"] - xla_run["map"]) <= 0.05, (native_run["summary"], xla_run["summary"])


def test_mean_average_precision_equal(rng):
    scores = rng.normal(size=(40, 5))
    labels = (rng.uniform(size=(40, 5)) < 0.3).astype(np.int32)
    labels[:, 4] = 0  # a class with no positives: nan, left out of the mean
    for eleven in (True, False):
        got = MeanAveragePrecisionEvaluator(5, eleven).evaluate(scores, labels)
        want = JMeanAveragePrecisionEvaluator(5, eleven).evaluate(scores, labels)
        np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], rtol=0, atol=1e-12)
        assert abs(got["map"] - want["map"]) <= 1e-12


# --- the pipeline ----------------------------------------------------------


SMALL = dict(synthetic_n=48, synthetic_classes=4, pca_dims=16, gmm_k=4, descriptor_sample=10_000,
             num_iters=1)


@pytest.fixture(scope="module")
def reference_fit():
    conf = ref.VOCSIFTFisherConfig(**SMALL, sift_backend="xla")
    train, test = JVOCLoader.synthetic(n=conf.synthetic_n, num_classes=conf.synthetic_classes)
    featurizer = ref.build_featurizer(conf, train.data)
    scored = featurizer.and_then(
        JBlockLeastSquares(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam),
        train.data, (2.0 * train.labels - 1.0).astype(np.float32),
    )
    return conf, train, test, featurizer, scored


def _carried(featurizer, scored) -> dict:
    """The reference's fitted PCA, GMM and head under ``convert.py``'s keys."""
    pca, fv = _fitted(featurizer, JPCATransformer), _fitted(featurizer, JFisherVector)
    head = _fitted(scored, JBlockLinearMapper)
    d = {"sift.pca.components": pca.components, "sift.pca.mean": pca.mean}
    for key in ("weights", "means", "variances"):
        d[f"sift.gmm.{key}"] = getattr(fv, key)
    d["head.W"] = np.concatenate([np.asarray(w) for w in head.W_blocks])
    d["head.blocks"] = head.blocks
    d["head.b"] = head.b
    return {k: np.array(v) for k, v in d.items()}


def test_pipeline_with_the_reference_parameters_matches(reference_fit):
    conf, train, test, featurizer, scored = reference_fit
    params = _carried(featurizer, scored)
    pca, fv, head = voc_params_from_numpy(params, device="cpu")
    pconf = port.VOCSIFTFisherConfig(**SMALL)
    feat = port.featurizer_from_params(pconf, pca, fv)
    got_f, want_f = _port(feat, test.data), _ref(featurizer, test.data)
    assert got_f.shape == want_f.shape == (len(test.data), pconf.feature_dim)
    _close_to_max(got_f, want_f, 1e-3)

    want_s = _ref(scored, test.data)
    _close_to_max(_port(feat.and_then(head), test.data), want_s, 1e-3)
    targets = 2.0 * torch.as_tensor(train.labels, dtype=torch.float32) - 1.0
    solver = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam)
    got_s = port.scores(feat.and_then(solver, train.data, targets), test.data, device="cpu")
    _close_to_max(got_s, want_s, 1e-2)
    k = conf.synthetic_classes
    got_map = port.evaluate(got_s, test.labels, k, 0.0)["map"]
    want_map = JMeanAveragePrecisionEvaluator(k).evaluate(want_s, test.labels)["map"]
    assert abs(got_map - want_map) <= 0.02, (got_map, want_map)


def test_run_and_main_reach_the_reference_map():
    want = ref.run(ref.VOCSIFTFisherConfig(**SMALL, sift_backend="xla"))
    got = port.run(port.VOCSIFTFisherConfig(**SMALL), device="cpu")
    assert set(got) == set(want) and len(got["per_class_ap"]) == SMALL["synthetic_classes"]
    assert abs(got["map"] - want["map"]) <= 0.05, (got["summary"], want["summary"])
    out = port.main(["--device", "cpu", "--synthetic-n", "24", "--pca-dims", "8", "--gmm-k", "2",
                     "--fv-backend", "pallas"])
    assert 0.0 <= out["map"] <= 1.0
    with pytest.raises(ValueError, match="annotation"):
        port.run(port.VOCSIFTFisherConfig(image_dir="x"), device="cpu")
