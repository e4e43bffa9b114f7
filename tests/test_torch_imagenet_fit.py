"""The port's fit of ImageNetSiftLcsFV, as a whole, held against the JAX
package.

The reference's ``run`` steps (``build_featurizer``, then the class-weighted
head through ``and_then``) run at ``gmm_k=4``, ``pca_dims=8`` on 64×64
synthetic images with its XLA SIFT. Its fitted PCA and GMM are fed to the
port, whose ``fit_head`` fits the head on the port's features of the same
training images. A tiny fit leaves GMM variances near the 1e-4 floor,
where float32 keeps only a couple of digits of the features (ROADMAP
Queue 3), so the two heads are compared by what ``run`` reports: equal
``feature_dim``, and top-1 and top-k errors within 2 of the 128 test
images (0.016) of the reference's.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
from keystone_tpu.nodes.images.external.fisher_vector import fit_fisher_featurizer
from keystone_tpu.nodes.learning import BlockWeightedLeastSquaresEstimator as JBlockWLS
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.nodes.util import ClassLabelIndicators as JClassLabelIndicators
from keystone_tpu.nodes.util import TopKClassifier as JTopKClassifier
from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as ref
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.convert import params_from_numpy, params_to_numpy
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.nodes.images.external.fisher_vector import GMMFisherVectorEstimator
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModelEstimator
from keystone_tpu_torch.nodes.learning.kmeans import KMeansPlusPlusEstimator
from keystone_tpu_torch.nodes.learning.pca import PCAEstimator
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.utils.stages import StageTimer
from keystone_tpu_torch.nodes.util.misc import Identity
from keystone_tpu_torch.workflow import on_device
from keystone_tpu_torch.workflow.serving import CompiledPipeline

ERROR_TOL = 2 / 128
# The reference's (top-k, top-1) test errors at these settings: the
# synthetic classes are easy, so the errors alone discriminate little; the
# head's W, b and scores are compared on the reference's features below.
REFERENCE_ERRORS = (0.0, 0.0)
# The port's head against the reference's on the same features (see the test).
HEAD_ATOL = 1e-2
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
SMALL = dict(gmm_k=4, pca_dims=8, synthetic_n=64, synthetic_classes=8, top_k=3)
KEYS = {"top_k_error", "top_1_error", "feature_dim", "seconds", "summary"}


def _fitted(pipeline, cls):
    found = [
        op.transformer for op in pipeline.graph.operators.values()
        if isinstance(getattr(op, "transformer", None), cls)
    ]
    assert len(found) == 1
    return found[0]


def _errors(topk, labels):
    return float(1.0 - (topk == labels[:, None]).any(axis=1).mean()), float((topk[:, 0] != labels).mean())


@pytest.fixture(scope="module")
def reference_fit():
    """The reference's run at the small settings, step by step."""
    conf = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(
        gmm_k=4, pca_dims=8, sift_backend="xla", synthetic_n=128, synthetic_classes=16, top_k=3,
    ))
    train, test = JImageNetLoader.synthetic(n=128, num_classes=16)
    # The reference's run, step by step (its build_featurizer), keeping
    # each branch.
    sift_front = JGrayScaler().and_then(JSIFTExtractor(backend="xla"))
    lcs_front = JLCSExtractor().to_pipeline()
    branches = [
        fit_fisher_featurizer(
            front, train.data, pca_dims=8, gmm_k=4, em_iters=conf.gmm_iters,
            sample_size=conf.descriptor_sample, backend=conf.fv_backend, seed=seed,
        )
        for front, seed in ((sift_front, conf.seed), (lcs_front, conf.seed + 1))
    ]
    featurizer = JPipeline.gather(branches)
    solver = JBlockWLS(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
                       mixture_weight=conf.mixture_weight)
    scored = featurizer.and_then(solver, train.data, JClassLabelIndicators(16)(train.labels))
    want = _errors(np.asarray(scored.and_then(JTopKClassifier(3))(test.data).get()), test.labels)
    return conf, train, test, branches, featurizer, scored, want


def test_head_fitted_on_the_reference_branches_matches_its_errors(reference_fit):
    conf, train, test, branches, _, _, want = reference_fit
    assert want == REFERENCE_ERRORS
    d = {}
    for br, branch in zip(("sift", "lcs"), branches):
        pca, fv = _fitted(branch, JPCATransformer), _fitted(branch, JFisherVector)
        d[f"{br}.pca.components"], d[f"{br}.pca.mean"] = np.array(pca.components), np.array(pca.mean)
        for key in ("weights", "means", "variances"):
            d[f"{br}.gmm.{key}"] = np.array(getattr(fv, key))
    d.update({"head.W": np.zeros((128, 16), np.float32), "head.blocks": [(0, 128)]})
    pconf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, synthetic_classes=16, top_k=3)
    pfeat = port.build_featurizer(params_from_numpy(d, device="cpu"), pconf)
    pscored = port.fit_head(pfeat, pconf, train.data, train.labels, 16, device="cpu")
    got = port.evaluate(pscored, pconf, test, device="cpu")
    assert port.resolve_scale(pconf).feature_dim == 2 * (2 * conf.gmm_k * conf.pca_dims) == 128
    assert abs(got[0] - want[0]) <= ERROR_TOL and abs(got[1] - want[1]) <= ERROR_TOL, (got, want)


def _head64(X, labels, k, lam, mixture_weight):
    """The class-weighted ridge head in float64 numpy: one block, so every
    epoch solves the same normal equations."""
    X = X.astype(np.float64)
    Y = 2.0 * np.eye(k)[labels] - 1.0
    counts = np.maximum(np.bincount(labels, minlength=k), 1)
    w = ((1 - mixture_weight) + mixture_weight * len(labels) / (k * counts))[labels]
    x_mean, y_mean = w @ X / w.sum(), w @ Y / w.sum()
    A = X - x_mean
    gram = (A * w[:, None]).T @ A + lam * np.eye(X.shape[1])
    W = np.linalg.solve(gram, (A * w[:, None]).T @ (Y - y_mean))
    return W, y_mean - x_mean @ W


def test_head_solver_on_the_reference_features_matches_its_head(reference_fit):
    """The port's fit_head on the reference's own features (an empty
    featurizer) against the head the reference's run fits on them: W, b
    and test scores. With n = d = 128 and λ = 1e-3 the ridge gram's
    condition number is about 4e4, so float32 keeps 3-4 digits of W (both
    heads sit 3e-3 to 4e-3 from a float64 solve, |W| up to 2): the two are
    compared at atol HEAD_ATOL, and each against the float64 solve, where
    the port's error is at most twice the reference's plus 1e-5."""
    conf, train, test, _, featurizer, _, _ = reference_fit
    feats = np.array(featurizer(train.data).get())
    test_feats = np.array(featurizer(test.data).get())
    pconf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, synthetic_classes=16, top_k=3)
    head = port.fit_head(Identity().to_pipeline(), pconf, feats, train.labels, 16, device="cpu").transformers()[-1]
    # The head the reference's run fits, on the same features.
    jhead = JBlockWLS(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
                      mixture_weight=conf.mixture_weight).fit(feats, JClassLabelIndicators(16)(train.labels))
    assert head.blocks == [tuple(b) for b in jhead.blocks] == [(0, 128)]
    W64, b64 = _head64(feats, train.labels, 16, conf.lam, conf.mixture_weight)
    with torch.inference_mode():
        scores = head(torch.from_numpy(test_feats)).numpy()
    for got, want, exact in (
        (head.W.numpy(), np.asarray(jhead.W), W64),
        (head.b.numpy(), np.asarray(jhead.b), b64),
        (scores, np.asarray(jhead.apply_batch(test_feats)), test_feats.astype(np.float64) @ W64 + b64),
    ):
        np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_ATOL)
        assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max() + 1e-5


def test_run_on_the_cpu_returns_the_reference_keys():
    out = port.run(port.ImageNetSiftLcsFVConfig(**SMALL), device="cpu")
    assert set(out) == KEYS
    assert out["feature_dim"] == 128
    assert 0.0 <= out["top_1_error"] <= 1.0 and 0.0 <= out["top_k_error"] <= out["top_1_error"]
    assert out["summary"] == f"top-3 error: {out['top_k_error']:.4f} | top-1 error: {out['top_1_error']:.4f}"


def test_main_fits_prints_the_summary_and_saves_what_serves(capsys, tmp_path):
    path = tmp_path / "fitted.npz"
    out = port.main([
        "--fit", "--device", "cpu", "--gmm-k", "4", "--pca-dims", "8", "--synthetic-n", "64",
        "--synthetic-classes", "8", "--top-k", "3", "--save-params", str(path),
    ])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == out["summary"]
    assert lines[1].startswith("feature dim 128 | total ")
    served = port.main([
        "--device", "cpu", "--params", str(path), "--gmm-k", "4", "--pca-dims", "8",
        "--image-size", "64", "--max-batch", "4", "--requests", "2", "--top-k", "3",
    ])
    assert served[0].shape == (2, 3) and served[0].max() < 8


def test_fitted_pipeline_round_trips_and_serves():
    conf = port.resolve_scale(port.ImageNetSiftLcsFVConfig(**SMALL))
    train, test = ImageNetLoader.synthetic(n=conf.synthetic_n, num_classes=8)
    scored = port.fit(conf, train, 8, device="cpu")
    d = params_to_numpy(scored)
    again = params_to_numpy(port.build_serving_pipeline(params_from_numpy(d, "cpu"), conf))
    assert set(d) == set(again)
    for key in d:
        np.testing.assert_array_equal(again[key], d[key])
    X = test.data[:5]
    with torch.inference_mode(), on_device("cpu"):
        want = scored(torch.from_numpy(X)).get().numpy()
    engine = CompiledPipeline(scored, max_batch=4, devices=["cpu"])
    np.testing.assert_allclose(engine(X), want, **SCORE_TOL)


@pytest.mark.parametrize("data_path, gmm_k, num_iters", [(None, None, None), ("x", None, None), ("x", 7, 5)])
def test_resolve_scale_matches_the_reference(data_path, gmm_k, num_iters):
    got = port.resolve_scale(port.ImageNetSiftLcsFVConfig(data_path=data_path, gmm_k=gmm_k, num_iters=num_iters))
    want = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(data_path=data_path, gmm_k=gmm_k, num_iters=num_iters))
    assert (got.gmm_k, got.num_iters, got.feature_dim) == (want.gmm_k, want.num_iters, 2 * 2 * want.gmm_k * 64)
    for field in ("data_path", "pca_dims", "gmm_iters", "descriptor_sample", "lam", "mixture_weight",
                  "block_size", "top_k", "seed", "synthetic_n", "synthetic_classes"):
        assert getattr(got, field) == getattr(want, field), field


def test_fit_marks_every_stage_and_the_objective():
    conf = port.ImageNetSiftLcsFVConfig(**SMALL)
    train, _ = ImageNetLoader.synthetic(n=32, num_classes=8)
    with StageTimer("cpu") as timer:
        port.fit(conf, train, 8, device="cpu")
    stages = list(timer.seconds())
    assert stages == [
        "copy of the images to the device", "descriptor fronts", "sampling", "PCA", "k-means", "EM",
        "apply the prefix to the fit data", "centering", "BCD factor phase", "BCD epoch 1", "BCD epoch 2",
    ]
    objs = [float(timer.notes[f"objective after epoch {e}"]) for e in (1, 2)]
    assert objs[1] <= objs[0] * (1 + 1e-6)


def test_fit_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = port.ImageNetSiftLcsFVConfig(**SMALL)
    train, _ = ImageNetLoader.synthetic(n=8, num_classes=8)
    X, Y = np.ones((8, 4), np.float32), np.ones((8, 2), np.float32)
    for call in (
        lambda: port.run(conf),
        lambda: port.fit(conf, train, 8),
        lambda: port.fit_featurizer(conf, train.data),
        lambda: port.main(["--fit", "--gmm-k", "4"]),
        lambda: Identity().and_then(port.BlockWeightedLeastSquaresEstimator(), train.data, train.labels).fit(),
        # Estimators given host arrays, with no device named.
        lambda: port.BlockWeightedLeastSquaresEstimator().fit(X, Y),
        lambda: BlockLeastSquaresEstimator().fit(X, Y),
        lambda: PCAEstimator(2).fit(X),
        lambda: KMeansPlusPlusEstimator(2).fit(X),
        lambda: GaussianMixtureModelEstimator(2).fit(X),
        lambda: GMMFisherVectorEstimator(2).fit(X.reshape(2, 4, 4)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
