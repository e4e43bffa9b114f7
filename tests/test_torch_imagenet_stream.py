"""The port's streamed ImageNetSiftLcsFV and its test-time augmentation,
held against the JAX package.

The reference's featurizer is fitted once (``gmm_k=4``, ``pca_dims=8``, its
XLA SIFT, 64 synthetic 64×64 training images of 8 classes) and both
``run``s are given it: the reference's through its ``build_featurizer``,
the port's as the same PCA and GMM through ``fit_featurizer``. The two
GMMs would otherwise come from different random streams, and a GMM this
small moves the errors of a 128-image test split by several images. Each
run then fits its own head and scores the test split, streamed or not,
with or without the ten views; the port's top-k and top-1 errors are held
to the reference's within 2 of the 128 test images (0.016).

Streamed TTA against the port's eager TTA: each image's average over its
views within 1e-5 of the largest |score| (float32 products over batches
of other sizes).
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
from keystone_tpu.nodes.images.external.fisher_vector import fit_fisher_featurizer
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as ref
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.linalg import bcd as pbcd
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.utils.stages import StageTimer
from keystone_tpu_torch.nodes.util.misc import Identity
from keystone_tpu_torch.workflow import on_device

ERROR_TOL = 2 / 128
VIEW_TOL = 1e-5
SMALL = dict(gmm_k=4, pca_dims=8, synthetic_n=64, synthetic_classes=8, top_k=3,
             stream_batch=32, fit_sample_images=64)


def _fitted(pipeline, cls):
    found = [
        op.transformer for op in pipeline.graph.operators.values()
        if isinstance(getattr(op, "transformer", None), cls)
    ]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def featurizers():
    """The reference's featurizer fitted on the training images, and the
    port's with the same PCA and GMM."""
    conf = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(sift_backend="xla", **SMALL))
    train, _ = JImageNetLoader.synthetic(n=64, num_classes=8)
    fronts = ((JGrayScaler().and_then(JSIFTExtractor(backend="xla")), conf.seed),
              (JLCSExtractor().to_pipeline(), conf.seed + 1))
    branches = [
        fit_fisher_featurizer(front, train.data, pca_dims=8, gmm_k=4, em_iters=conf.gmm_iters,
                              sample_size=conf.descriptor_sample, backend=conf.fv_backend, seed=seed)
        for front, seed in fronts
    ]
    d = {"head.W": np.zeros((128, 8), np.float32), "head.blocks": [(0, 128)]}
    for br, branch in zip(("sift", "lcs"), branches):
        pca, fv = _fitted(branch, JPCATransformer), _fitted(branch, JFisherVector)
        d[f"{br}.pca.components"], d[f"{br}.pca.mean"] = np.array(pca.components), np.array(pca.mean)
        for key in ("weights", "means", "variances"):
            d[f"{br}.gmm.{key}"] = np.array(getattr(fv, key))
    pconf = port.ImageNetSiftLcsFVConfig(**SMALL)
    return JPipeline.gather(branches), port.build_featurizer(params_from_numpy(d, device="cpu"), pconf)


@pytest.mark.parametrize("options", [dict(stream=True), dict(augment=True), dict(stream=True, augment=True)],
                         ids=["stream", "augment", "stream-augment"])
def test_run_matches_the_reference_errors(featurizers, monkeypatch, options):
    jfeat, pfeat = featurizers
    monkeypatch.setattr(ref, "build_featurizer", lambda conf, images: jfeat)
    monkeypatch.setattr(port, "fit_featurizer", lambda conf, images, device=None: pfeat)
    want = ref.run(ref.ImageNetSiftLcsFVConfig(sift_backend="xla", **SMALL, **options))
    got = port.run(port.ImageNetSiftLcsFVConfig(**SMALL, **options), device="cpu")
    assert set(got) == set(want)
    assert got["feature_dim"] == want["feature_dim"] == 128
    if "num_views" in want:
        assert got["num_views"] == want["num_views"] == 10
    tail = lambda out: out["summary"].split(f"top-1 error: {out['top_1_error']:.4f}")[1]  # noqa: E731
    assert tail(got) == tail(want)
    for key in ("top_k_error", "top_1_error"):
        assert abs(got[key] - want[key]) <= ERROR_TOL, (key, got, want)


def test_streamed_tta_averages_equal_the_eager_ones():
    conf = port.resolve_scale(port.ImageNetSiftLcsFVConfig(**SMALL, augment=True))
    train, test = ImageNetLoader.synthetic(n=64, num_classes=8)
    scored = port.fit(conf, train, 8, device="cpu")
    patcher, averager = port.build_tta(conf, 64)
    assert (patcher.crop_size, patcher.num_views) == (56, 10)
    X = test.data[:24]
    with torch.inference_mode(), on_device("cpu"):
        eager = averager.average_scores(scored(patcher(torch.from_numpy(X))).get()).numpy()
    # stream_batch 32 → 3 images (30 views) at a time, in batches of 10 images.
    got, labels = port.score_streamed(scored, conf, BatchIterator.from_arrays(X, test.labels[:24], 10),
                                      64, device="cpu")
    np.testing.assert_array_equal(labels, test.labels[:24])
    assert got.shape == eager.shape == (24, 8)
    assert np.abs(got - eager).max() <= VIEW_TOL * np.abs(eager).max()


def test_the_streamed_fit_marks_its_stages_and_checkpoints(tmp_path):
    ck = str(tmp_path / "ck")
    conf = port.ImageNetSiftLcsFVConfig(**SMALL, checkpoint_dir=ck)
    train, _ = ImageNetLoader.synthetic(n=64, num_classes=8)
    with StageTimer("cpu") as timer:
        scored = port.fit_streamed(conf, train.data[:32], BatchIterator.from_arrays(train.data, train.labels, 16),
                                   8, device="cpu")
    assert list(timer.seconds()) == [
        "descriptor fronts", "sampling", "PCA", "k-means", "EM", "featurizing the training set",
        "assembling the host features", "centering", "BCD epoch 1", "BCD epoch 2",
    ]
    assert len(timer.notes["streamed BCD blocks"]) == 2  # one block of 128 features, two epochs
    assert sorted(os.listdir(ck)) == ["epoch_1.pt", "epoch_2.pt"]
    assert not os.path.exists(os.path.join(ck, pbcd.SNAPSHOT))
    assert scored.transformers()[-1].W.shape == (128, 8)


def test_main_streams_and_augments(capsys):
    out = port.main([
        "--stream", "--augment", "--device", "cpu", "--gmm-k", "4", "--pca-dims", "8",
        "--synthetic-n", "64", "--synthetic-classes", "8", "--top-k", "3", "--stream-batch", "32",
        "--fit-sample-images", "32", "--augment-crop", "48",
    ])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == out["summary"] and out["summary"].endswith("(streamed, TTA x10)")
    assert out["num_views"] == 10
    assert lines[1].startswith("feature dim 128 | total ")


def test_streamed_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = port.ImageNetSiftLcsFVConfig(**SMALL)
    train, _ = ImageNetLoader.synthetic(n=8, num_classes=8)
    batches = BatchIterator.from_arrays(train.data, train.labels, 4)
    X, Y = np.ones((8, 4), np.float32), np.ones((8, 2), np.float32)
    for call in (
        lambda: port.run(port.ImageNetSiftLcsFVConfig(**SMALL, stream=True)),
        lambda: port.run_streamed(conf),
        lambda: port.fit_streamed(conf, train.data, batches, 8),
        lambda: port.score_streamed(Identity().to_pipeline(), conf, batches, 64),
        lambda: next(Identity().to_pipeline().apply_batches(batches)),
        lambda: port.main(["--stream", "--gmm-k", "4"]),
        lambda: port.BlockWeightedLeastSquaresEstimator(stream=True).fit(X, Y),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
