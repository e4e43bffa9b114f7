"""The port's ImageNetSiftLcsFV on real JPEG data, held against the JAX
package.

A small dataset is written from a seed: 8 synsets, half as ``.tar``
archives and half as directories, of 64×64 JPEG gratings (an angle and a
frequency per class, a random phase and tint per image), 6 training and 2
test images each, and the label map. Both loaders decode them at 256×256
with PIL (``KEYSTONE_JPEG_BACKEND=pil``).

As in ``tests/test_torch_imagenet_stream.py``, the reference's featurizer
(``gmm_k=4``, ``pca_dims=8``, its XLA SIFT, which is the port's SIFT's
counterpart) is fitted once, here on the decoded training images, and both
``run``s are given it: the two GMMs would otherwise come from different
random streams. Each run loads or streams the data itself, fits its own
head and scores the 16 test images; the port's top-k and top-1 errors are
held to the reference's within 2 test images, with equal feature
dimensions and summary tails.
"""

import io
import os
import tarfile

import numpy as np
import pytest

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
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port

SYNSETS = 8
TRAIN_PER, TEST_PER = 6, 2
ERROR_TOL = 2 / (SYNSETS * TEST_PER)
SMALL = dict(gmm_k=4, pca_dims=8, top_k=3, stream_batch=16, fit_sample_images=16)


def _jpeg(rng, c: int, side: int = 64) -> bytes:
    from PIL import Image

    yy, xx = np.mgrid[0:side, 0:side]
    angle = np.pi * c / SYNSETS
    freq = 2 + c % 4
    phase = rng.uniform(0, 2 * np.pi)
    base = 0.5 + 0.5 * np.sin(2 * np.pi * freq / side * (xx * np.cos(angle) + yy * np.sin(angle)) + phase)
    tint = 0.5 + 0.5 * rng.uniform(size=3)
    img = np.clip(255 * base[..., None] * tint + rng.normal(0, 8, size=(side, side, 3)), 0, 255)
    out = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(out, format="JPEG", quality=90)
    return out.getvalue()


def write_dataset(root, seed: int = 0):
    """``root/train``, ``root/test`` and ``root/labels.txt``; synsets with an
    even index are tars, odd ones directories."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "labels.txt"), "w") as f:
        for c in range(SYNSETS):
            f.write(f"n{c:08d} {c}\n")
    for split, per in (("train", TRAIN_PER), ("test", TEST_PER)):
        os.makedirs(os.path.join(root, split))
        for c in range(SYNSETS):
            synset = f"n{c:08d}"
            images = [_jpeg(rng, c) for _ in range(per)]
            if c % 2 == 0:
                with tarfile.open(os.path.join(root, split, f"{synset}.tar"), "w") as tf:
                    for i, data in enumerate(images):
                        info = tarfile.TarInfo(f"{synset}_{i}.JPEG")
                        info.size = len(data)
                        tf.addfile(info, io.BytesIO(data))
            else:
                os.makedirs(os.path.join(root, split, synset))
                for i, data in enumerate(images):
                    with open(os.path.join(root, split, synset, f"{synset}_{i}.JPEG"), "wb") as f:
                        f.write(data)
    return {"data_path": os.path.join(root, "train"), "test_data_path": os.path.join(root, "test"),
            "label_map_path": os.path.join(root, "labels.txt")}


@pytest.fixture(autouse=True)
def pil(monkeypatch):
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", "pil")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("imagenet")))


def _fitted(pipeline, cls):
    found = [
        op.transformer for op in pipeline.graph.operators.values()
        if isinstance(getattr(op, "transformer", None), cls)
    ]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def featurizers(paths):
    """The reference's featurizer fitted on the decoded training images, and
    the port's with the same PCA and GMM."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("KEYSTONE_JPEG_BACKEND", "pil")
        train = JImageNetLoader.load(paths["data_path"], JImageNetLoader.load_label_map(paths["label_map_path"]))
    conf = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(sift_backend="xla", **paths, **SMALL))
    fronts = ((JGrayScaler().and_then(JSIFTExtractor(backend="xla")), conf.seed),
              (JLCSExtractor().to_pipeline(), conf.seed + 1))
    branches = [
        fit_fisher_featurizer(front, train.data, pca_dims=8, gmm_k=4, em_iters=conf.gmm_iters,
                              sample_size=conf.descriptor_sample, backend=conf.fv_backend, seed=seed)
        for front, seed in fronts
    ]
    d = {"head.W": np.zeros((128, SYNSETS), np.float32), "head.blocks": [(0, 128)]}
    for br, branch in zip(("sift", "lcs"), branches):
        pca, fv = _fitted(branch, JPCATransformer), _fitted(branch, JFisherVector)
        d[f"{br}.pca.components"], d[f"{br}.pca.mean"] = np.array(pca.components), np.array(pca.mean)
        for key in ("weights", "means", "variances"):
            d[f"{br}.gmm.{key}"] = np.array(getattr(fv, key))
    pconf = port.ImageNetSiftLcsFVConfig(**SMALL)
    return JPipeline.gather(branches), port.build_featurizer(params_from_numpy(d, device="cpu"), pconf)


@pytest.fixture
def shared_featurizer(featurizers, monkeypatch):
    jfeat, pfeat = featurizers
    sizes = []
    monkeypatch.setattr(ref, "build_featurizer", lambda conf, images: jfeat)

    def fitted(conf, images, device=None):
        sizes.append(np.shape(images))
        return pfeat

    monkeypatch.setattr(port, "fit_featurizer", fitted)
    return sizes


@pytest.mark.parametrize("options", [{}, dict(stream=True), dict(stream=True, augment=True)],
                         ids=["in-memory", "stream", "stream-augment"])
def test_run_on_real_data_matches_the_reference_errors(paths, shared_featurizer, options):
    want = ref.run(ref.ImageNetSiftLcsFVConfig(sift_backend="xla", **paths, **SMALL, **options))
    got = port.run(port.ImageNetSiftLcsFVConfig(**paths, **SMALL, **options), device="cpu")
    assert set(got) == set(want)
    assert got["feature_dim"] == want["feature_dim"] == 128
    tail = lambda out: out["summary"].split(f"top-1 error: {out['top_1_error']:.4f}")[1]  # noqa: E731
    assert tail(got) == tail(want)
    for key in ("top_k_error", "top_1_error"):
        assert abs(got[key] - want[key]) <= ERROR_TOL, (key, got, want)
    # The featurizer's images: the whole training set in memory, a
    # class-balanced sample of fit_sample_images when streamed; 256x256.
    n = SMALL["fit_sample_images"] if options.get("stream") else SYNSETS * TRAIN_PER
    assert shared_featurizer == [(n, 256, 256, 3)]


def test_real_data_resolves_to_the_reference_scale(paths):
    got = port.resolve_scale(port.ImageNetSiftLcsFVConfig(**paths))
    want = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(**paths))
    assert (got.gmm_k, got.num_iters, got.feature_dim) == (want.gmm_k, want.num_iters, 65536) == (256, 3, 65536)
    synthetic = port.resolve_scale(port.ImageNetSiftLcsFVConfig())
    assert (synthetic.gmm_k, synthetic.num_iters) == (16, 2)


@pytest.mark.parametrize("missing", ["test_data_path", "label_map_path"])
@pytest.mark.parametrize("stream", [False, True], ids=["in-memory", "stream"])
def test_real_data_without_a_test_path_or_label_map_raises(paths, missing, stream):
    kw = {**paths, missing: None}
    with pytest.raises(ValueError, match="requires test path and label map"):
        ref.run(ref.ImageNetSiftLcsFVConfig(sift_backend="xla", stream=stream, **kw, **SMALL))
    with pytest.raises(ValueError, match="requires test path and label map"):
        port.run(port.ImageNetSiftLcsFVConfig(stream=stream, **kw, **SMALL), device="cpu")


def test_a_stream_of_no_known_synset_raises(paths, tmp_path, shared_featurizer):
    labels = tmp_path / "labels.txt"
    labels.write_text("n99999999 0\n")
    conf = port.ImageNetSiftLcsFVConfig(**{**paths, "label_map_path": str(labels)}, **SMALL, stream=True)
    with pytest.raises(ValueError):
        port.run(conf, device="cpu")


@pytest.mark.parametrize("stream", [False, True], ids=["in-memory", "stream"])
def test_main_fits_and_scores_real_data(paths, shared_featurizer, capsys, stream):
    out = port.main([
        "--data", paths["data_path"], "--test-data", paths["test_data_path"],
        "--label-map", paths["label_map_path"], "--device", "cpu", "--gmm-k", "4", "--pca-dims", "8",
        "--top-k", "3", "--stream-batch", "16", "--fit-sample-images", "16", *(["--stream"] if stream else []),
    ])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == out["summary"]
    assert out["summary"].endswith(" (streamed)") == stream
    assert lines[1].startswith("feature dim 128 | total ")
