"""The port's estimators of the featurizer fit held against the JAX package.

Inputs are made with numpy from a seed and go through both packages.
Tolerances, float32 throughout:

- the sampler and the label indicators: equal;
- pairwise distances: rtol 1e-5, atol 1e-4 (the expanded form cancels
  terms of order 10² in float32);
- Lloyd and EM, on well-separated clusters, so that no argmin sits on a
  tie: rtol 1e-4, atol 1e-5 (sums in another order);
- PCA, on data whose singular values are well apart, each component up to
  its sign: atol 1e-4;
- Fisher vectors of two fitted GMMs: rtol 1e-3, atol 1e-3 (the fits'
  rtol 1e-4 carried through (x − μ)²/σ², with σ² down to 0.02);
- descriptors: the descriptor tolerance of tests/test_descriptors.py
  (rtol 2e-4, atol 2e-4).

The reference draws its k-means++ seeds from ``jax.random``, which torch
cannot replay. So the port's Lloyd sweeps start from the reference's seeds
(``_fit_kmeans`` with 0 sweeps), its EM from the reference's k-means, and
its own seeding is held only as a distribution; the whole estimators are
compared up to the order of their components.
"""

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.nodes.images.external.fisher_vector import (
    GMMFisherVectorEstimator as JGMMFisherVectorEstimator,
)
from keystone_tpu.nodes.learning.gmm import GaussianMixtureModelEstimator as JGMMEstimator
from keystone_tpu.nodes.learning.gmm import _fit_gmm
from keystone_tpu.nodes.learning.kernels import pairwise_sq_dists as j_sq_dists
from keystone_tpu.nodes.learning.kmeans import _fit_kmeans
from keystone_tpu.nodes.learning.pca import PCAEstimator as JPCAEstimator
from keystone_tpu.nodes.stats.samplers import sample_rows as j_sample_rows
from keystone_tpu.nodes.util.labels import ClassLabelIndicators as JClassLabelIndicators
from keystone_tpu_torch.nodes.images.external.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
    fit_fisher_featurizer,
    sample_descriptors,
)
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
from keystone_tpu_torch.nodes.images.pixels import GrayScaler
from keystone_tpu_torch.nodes.learning.gmm import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
    em_sweeps,
    gmm_from_centers,
)
from keystone_tpu_torch.nodes.learning.kernels import pairwise_sq_dists
from keystone_tpu_torch.nodes.learning.kmeans import (
    KMeansModel,
    KMeansPlusPlusEstimator,
    kmeans_plus_plus_seeds,
    lloyd,
)
from keystone_tpu_torch.nodes.learning.pca import PCAEstimator, PCATransformer
from keystone_tpu_torch.nodes.stats.samplers import sample_row_indices, sample_rows
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.workflow import on_device

DIST_TOL = dict(rtol=1e-5, atol=1e-4)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
FV_TOL = dict(rtol=1e-3, atol=1e-3)
DESC_TOL = dict(rtol=2e-4, atol=2e-4)
MIN_VAR = 1e-4


def _clusters(k=5, d=6, per=120, spread=10.0, sd=0.3, seed=0):
    """Well-separated Gaussian clusters, shuffled: (X (n, d) float32, centers)."""
    rng = np.random.default_rng(seed)
    centers = spread * rng.normal(size=(k, d))
    z = rng.permutation(np.repeat(np.arange(k), per))
    X = centers[z] + sd * rng.uniform(0.5, 1.5, size=(k, d))[z] * rng.normal(size=(len(z), d))
    return X.astype(np.float32), centers


def _t(a):
    return torch.from_numpy(np.array(a))


def _by_first_coordinate(means):
    return np.lexsort(np.asarray(means).T[::-1])


@pytest.mark.parametrize("n, num_samples, seed", [(1000, 37, 0), (1000, 1000, 1), (50, 80, 2), (30_000, 500, 3)])
def test_sample_rows_picks_the_reference_rows(n, num_samples, seed):
    X = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    want = j_sample_rows(X, num_samples, seed=seed)
    np.testing.assert_array_equal(sample_rows(X, num_samples, seed=seed), want)
    idx = sample_row_indices(n, num_samples, seed)
    np.testing.assert_array_equal(X if idx is None else X[idx], want)


def test_class_label_indicators_equal_the_reference():
    y = np.random.default_rng(0).integers(0, 7, size=40).astype(np.int32)
    want = np.asarray(JClassLabelIndicators(7).apply_batch(y))
    got = ClassLabelIndicators(7)(torch.from_numpy(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, m, d", [(50, 7, 3), (300, 32, 64)])
def test_pairwise_sq_dists_match_the_reference(n, m, d):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Z = rng.normal(size=(m, d)).astype(np.float32)
    Z[0] = X[0]  # an exact match: clamped at 0, not negative
    got = pairwise_sq_dists(_t(X), _t(Z)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_sq_dists(X, Z)), **DIST_TOL)
    assert got.min() >= 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_lloyd_from_the_reference_seeds(seed):
    X, _ = _clusters(seed=seed)
    key = jax.random.PRNGKey(seed)
    seeds = np.asarray(_fit_kmeans(X, key, 5, 0))
    want = np.asarray(_fit_kmeans(X, key, 5, 5))
    got = lloyd(_t(X), _t(seeds), 5).numpy()
    np.testing.assert_allclose(got, want, **FIT_TOL)


def test_empty_cluster_keeps_its_center():
    X, _ = _clusters(k=3, seed=4)
    far = np.full((1, X.shape[1]), 1e3, np.float32)
    seeds = np.concatenate([X[:2], far])
    got = lloyd(_t(X), _t(seeds), 3).numpy()
    np.testing.assert_array_equal(got[2], far[0])


@pytest.mark.parametrize("iters", [1, 10])
def test_em_from_the_reference_kmeans(iters):
    X, _ = _clusters(seed=5)
    key = jax.random.PRNGKey(3)
    seeds = _t(np.asarray(_fit_kmeans(X, key, 5, 0)))
    init = gmm_from_centers(_t(X), lloyd(_t(X), seeds, 5), MIN_VAR)
    got = em_sweeps(_t(X), *init, iters, MIN_VAR)
    want = _fit_gmm(X, key, 5, iters, MIN_VAR)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FIT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_plus_plus_seeds_are_rows_and_find_the_outlier(seed):
    X, _ = _clusters(k=4, seed=seed)
    X = np.concatenate([X, np.full((3, X.shape[1]), 500.0, np.float32)])  # a far cluster
    seeds = kmeans_plus_plus_seeds(_t(X), 5, torch.Generator().manual_seed(seed)).numpy()
    rows = {tuple(r) for r in X}
    assert all(tuple(s) in rows for s in seeds)
    assert (seeds == 500.0).all(axis=1).sum() == 1
    # One seed in each of the five clusters.
    assert len({tuple(np.round(c)) for c in lloyd(_t(X), _t(seeds), 5).numpy()}) == 5


def test_kmeans_estimator_agrees_with_the_reference_up_to_order():
    X, _ = _clusters(seed=6)
    from keystone_tpu.nodes.learning.kmeans import KMeansPlusPlusEstimator as JKMeans

    want = np.asarray(JKMeans(5, max_iters=10, seed=0).fit(X).centers)
    model = KMeansPlusPlusEstimator(5, max_iters=10, seed=0, device="cpu").fit(X)
    got = model.centers.numpy()
    np.testing.assert_allclose(got[_by_first_coordinate(got)], want[_by_first_coordinate(want)], **FIT_TOL)
    onehot = model(_t(X)).numpy()
    assert onehot.shape == (len(X), 5) and (onehot.sum(axis=1) == 1).all()
    np.testing.assert_array_equal(onehot.argmax(axis=1), model.predict(_t(X)).numpy())
    assert isinstance(model, KMeansModel)


def test_gmm_estimator_agrees_with_the_reference_up_to_order():
    X, _ = _clusters(seed=7)
    j = JGMMEstimator(5, max_iters=8, seed=0).fit(X)
    p = GaussianMixtureModelEstimator(5, max_iters=8, seed=0, device="cpu").fit(X)
    assert isinstance(p, GaussianMixtureModel)
    jo, po = _by_first_coordinate(j.means), _by_first_coordinate(p.means.numpy())
    for name in ("weights", "means", "variances"):
        np.testing.assert_allclose(getattr(p, name).numpy()[po], np.asarray(getattr(j, name))[jo], **FIT_TOL)
    r = p(_t(X)).numpy()
    np.testing.assert_allclose(r[:, po], np.asarray(j.apply_batch(X))[:, jo], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(p.predict(_t(X)).numpy().shape, (len(X),))


def test_gmm_fisher_vector_estimator_agrees_with_the_reference_up_to_order():
    """Both fit their GMM on the same sample of (B, m, d) descriptor sets
    (the reference's jnp EM, ``gmm_backend="tpu"``), and their Fisher
    vectors agree once the components are put in one order."""
    X, _ = _clusters(k=4, d=8, per=150, seed=8)
    sets = X.reshape(6, 100, 8)
    j = JGMMFisherVectorEstimator(k=4, em_iters=6, sample_size=450, gmm_backend="tpu", seed=2).fit(sets)
    p = GMMFisherVectorEstimator(k=4, em_iters=6, sample_size=450, seed=2, device="cpu").fit(sets)
    assert isinstance(p, FisherVector)
    jo, po = _by_first_coordinate(j.means), _by_first_coordinate(p.means.numpy())
    for name in ("weights", "means", "variances"):
        np.testing.assert_allclose(getattr(p, name).numpy()[po], np.asarray(getattr(j, name))[jo], **FIT_TOL)
    want = np.asarray(j.apply_batch(sets)).reshape(6, 2, 4, 8)[:, :, jo]
    got = p(_t(sets)).numpy().reshape(6, 2, 4, 8)[:, :, po]
    np.testing.assert_allclose(got, want, **FV_TOL)


@pytest.mark.parametrize("given", ["host array", "cpu tensor"])
def test_pca_matches_the_reference_up_to_sign(given):
    rng = np.random.default_rng(9)
    Q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    s = 2.0 ** -np.arange(12)  # singular values well apart
    X = (rng.normal(size=(400, 12)) * 10 * s) @ Q.T + 3.0
    X = X.astype(np.float32)
    j = JPCAEstimator(dims=4).fit(X)
    # A host array goes to the named device; a tensor stays on its own.
    p = PCAEstimator(dims=4, device="cpu").fit(X) if given == "host array" else PCAEstimator(dims=4).fit(_t(X))
    assert isinstance(p, PCATransformer) and p.components.shape == (12, 4)
    assert p.components.device.type == "cpu"
    jc = np.asarray(j.components)
    signs = np.sign((p.components.numpy() * jc).sum(axis=0))
    np.testing.assert_allclose(p.components.numpy() * signs, jc, atol=1e-4)
    np.testing.assert_allclose(p.mean.numpy(), np.asarray(j.mean), rtol=1e-6, atol=1e-6)


def _fronts():
    return {
        "sift": (GrayScaler().and_then(SIFTExtractor()), JGrayScaler().and_then(JSIFTExtractor(backend="xla"))),
        "lcs": (LCSExtractor().to_pipeline(), JLCSExtractor().to_pipeline()),
    }


@pytest.mark.parametrize("br", ["sift", "lcs"])
def test_sampled_descriptors_are_the_reference_sample(br):
    """The front runs batch by batch and keeps the rows that the
    reference's ``sample_rows`` over every descriptor keeps."""
    images = JImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=1)[0].data[:5]
    front, jfront = _fronts()[br]
    jd = np.asarray(jfront(images).get())
    want = j_sample_rows(jd.reshape(-1, jd.shape[-1]), 40, seed=3)
    for batch in (1, 2, 5):
        got = sample_descriptors(front, images, 40, 3, batch_size=batch, device="cpu")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **DESC_TOL)
    everything = sample_descriptors(front, images, 10**6, 3, batch_size=2, device="cpu")
    np.testing.assert_allclose(everything.numpy(), jd.reshape(-1, jd.shape[-1]), **DESC_TOL)


def test_fit_fisher_featurizer_on_the_reference_sample():
    """The branch's PCA, fitted on the reference's descriptor sample, is
    the reference's up to sign; the branch ends in the fitted PCA and GMM,
    signed square root and L2, and gives unit rows."""
    images = JImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=2)[0].data[:6]
    front, jfront = _fronts()["lcs"]
    jd = np.asarray(jfront(images).get())
    flat = j_sample_rows(jd.reshape(-1, jd.shape[-1]), 300, seed=1)
    jpca = JPCAEstimator(dims=6).fit(flat)
    branch = fit_fisher_featurizer(front, images, pca_dims=6, gmm_k=3, em_iters=4,
                                   sample_size=300, seed=1, device="cpu")
    names = [type(s).__name__ for s in branch.transformers()]
    assert names == ["LCSExtractor", "PCATransformer", "FisherVector", "SignedHellingerMapper", "L2Normalizer"]
    pca = branch.transformers()[1]
    # The port's PCA of the port's sample, against the reference's PCA of
    # its own sample: the samples agree at DESC_TOL, and the first
    # components are well separated on these descriptors.
    jc = np.asarray(jpca.components)[:, :2]
    pc = pca.components.numpy()[:, :2]
    np.testing.assert_allclose(pc * np.sign((pc * jc).sum(axis=0)), jc, atol=1e-3)
    with on_device("cpu"):
        feats = branch(torch.from_numpy(images)).get().numpy()
    assert feats.shape == (6, 2 * 3 * 6)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, rtol=1e-5)
