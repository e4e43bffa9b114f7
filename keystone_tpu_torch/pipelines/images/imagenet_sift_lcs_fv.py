"""ImageNetSiftLcsFV — the north-star pipeline: fit and serve.

Counterpart of ``keystone_tpu/pipelines/images/imagenet_sift_lcs_fv.py``:

    images (n, H, W, 3) ─┬─ GrayScaler → dense SIFT (128-d) → PCA → FisherVector → SignedHellinger → L2 ─┐
                         └─ LCS (96-d)                       → PCA → FisherVector → SignedHellinger → L2 ─┴─ gather → BlockLinearMapper → TopK

Fitting (the reference's ``run``) goes in two steps:

- ``fit_featurizer``: each branch's PCA and GMM on a descriptor sample of
  the training images (branch seeds ``seed`` and ``seed + 1``);
- ``fit_head``: the class-weighted block least-squares head on the
  training set's features, through ``Pipeline.and_then(estimator, data,
  labels)``, fitted by the graph executor (``workflow/executor.py``): the
  optimizer fuses the gathered branches into one module that the walk
  applies to the training images in batches of ``FIT_BATCH``.

Every entry point runs its graph walks on its ``device`` argument
(``workflow.on_device``) and returns fitted pipelines.

``run`` fits on the training images and scores the test split;
``evaluate`` gives its top-k and top-1 errors. The images are synthetic,
or with ``data_path`` real ones (the reference's ``:345-351``): the
training and test directories of per-synset tars or directories of JPEGs
that ``loaders/imagenet.py`` reads, labelled by the map at
``label_map_path``, decoded at 256×256. With ``stream`` (the reference's
``run_streamed``, ``:167-338``) the featurizer is fitted on
``fit_sample_images`` training images (``fit_streamed``; on real data a
class-balanced sample), the training set is featurized in batches of
``stream_batch`` through ``apply_batches`` (on real data decoded by
``ImageNetLoader.stream_batches`` on its own thread), only its features
are kept, on the host, and the head is solved streamed from there;
``score_streamed`` scores the test set batch by batch, the head served by
``_scoring_engine`` (one bucket at ``stream_batch``). With ``augment``
each test image is scored as the average over its ten center and corner
views (``CenterCornerPatcher``, crop 7/8 of the side unless
``augment_crop``), on either path. Full width, as ``resolve_scale`` sets
it when ``data_path`` is given: ``pca_dims=64``, ``gmm_k=256``, so
2·(2·256·64) = 65,536 features, solved in 3 epochs over 8 blocks of 8,192
on the card.

The port's dense SIFT runs on the device (``ops/sift.py``): it is the
counterpart of the reference's ``sift_backend="xla"``, not of its default
host ``native`` backend, and there is no backend option.

Run ``python -m keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv``
to serve synthetic requests with seeded random parameters, or pass
``--params file.npz`` with arrays under the keys ``convert.py`` documents;
``--fit`` fits on synthetic images instead and prints the errors;
``--data DIR --test-data DIR --label-map FILE`` fits and scores on real
images; ``--stream``, ``--augment`` and ``--checkpoint-dir`` set the
fit's options (the first two imply ``--fit``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.convert import BRANCHES, ServingParams, params_from_numpy, params_to_numpy
from keystone_tpu_torch.evaluation.augmented import AugmentedExamplesEvaluator
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader, LabeledData
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.nodes.images.external.fisher_vector import fit_fisher_featurizer
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.nodes.images.lcs import LCSExtractor
from keystone_tpu_torch.nodes.images.patches import CenterCornerPatcher
from keystone_tpu_torch.nodes.images.pixels import GrayScaler
from keystone_tpu_torch.nodes.learning.block_least_squares import (
    BlockWeightedLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats.hellinger import SignedHellingerMapper
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.nodes.util.classifiers import TopKClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import FusedTransformer, Pipeline, Transformer, on_device
from keystone_tpu_torch.workflow.serving import CompiledPipeline

# Feature block width of the head: the reference's resolve_block_size cap on
# an accelerator.
HEAD_BLOCK = 8192


@dataclass
class ImageNetSiftLcsFVConfig:
    # Real images: training and test directories and the synset label map
    # (None: synthetic images).
    data_path: Optional[str] = None
    test_data_path: Optional[str] = None
    label_map_path: Optional[str] = None
    sift_step: int = 4
    sift_bin: int = 4
    lcs_step: int = 4
    lcs_bin: int = 4
    pca_dims: int = 64
    # None = resolve_scale: 256 for real data, 16 for synthetic.
    gmm_k: Optional[int] = None
    gmm_iters: int = 20
    descriptor_sample: int = 200_000
    lam: float = 1e-3
    mixture_weight: float = 0.5
    block_size: "int | str" = "auto"
    # None = resolve_scale: 3 epochs for real data, 2 for synthetic.
    num_iters: Optional[int] = None
    top_k: int = 5
    # Test-time augmentation: each test image scored as the mean over its
    # center and corner crops, each also flipped; 0 = 7/8 of the side.
    augment: bool = False
    augment_crop: int = 0
    seed: int = 0
    synthetic_n: int = 512
    synthetic_classes: int = 16
    # Out-of-core fit: the featurizer on a sample of images, the training
    # set featurized batch by batch, features kept on the host and the
    # head solved from there.
    stream: bool = False
    stream_batch: int = 256
    fit_sample_images: int = 512
    # Where the head's solve checkpoints and resumes (None: nowhere).
    checkpoint_dir: Optional[str] = None

    @property
    def feature_dim(self) -> int:
        return 2 * (2 * self.gmm_k * self.pca_dims)


# What resolve_scale fills in: the reference's settings for real ImageNet
# (65,536 features, 3 epochs) and for its synthetic images.
REAL_SCALE = dict(gmm_k=256, num_iters=3)
SYNTHETIC_SCALE = dict(gmm_k=16, num_iters=2)


def resolve_scale(conf: ImageNetSiftLcsFVConfig) -> ImageNetSiftLcsFVConfig:
    """Fill gmm_k and num_iters at the reference's real-data scale when
    ``data_path`` is set, else at its synthetic scale. An explicit value
    always wins."""
    scale = REAL_SCALE if conf.data_path is not None else SYNTHETIC_SCALE
    return replace(conf, **{key: value if getattr(conf, key) is None else getattr(conf, key)
                            for key, value in scale.items()})


def _fronts(conf: ImageNetSiftLcsFVConfig):
    return {
        "sift": GrayScaler().and_then(
            SIFTExtractor(step=conf.sift_step, bin_size=conf.sift_bin)
        ),
        "lcs": LCSExtractor(step=conf.lcs_step, bin_size=conf.lcs_bin).to_pipeline(),
    }


def build_featurizer(params: ServingParams, conf: ImageNetSiftLcsFVConfig) -> Pipeline:
    """Both descriptor branches, gathered: images → (n, feature_dim)."""
    fronts = _fronts(conf)
    branches = [
        fronts[br]
        .and_then(getattr(params, f"{br}_pca"))
        .and_then(getattr(params, f"{br}_fv"))
        .and_then(SignedHellingerMapper())
        .and_then(L2Normalizer())
        for br in BRANCHES
    ]
    return Pipeline.gather(branches)


def build_serving_pipeline(params: ServingParams, conf: ImageNetSiftLcsFVConfig) -> Pipeline:
    """images → top-k class indices (int32, best first); without the last
    ``and_then``, ``build_featurizer(...).and_then(params.head)`` gives
    scores."""
    return (
        build_featurizer(params, conf)
        .and_then(params.head)
        .and_then(TopKClassifier(conf.top_k))
    )


def seeded_params(
    seed: int = 0,
    gmm_k: int = 256,
    pca_dims: int = 64,
    num_classes: int = 1000,
    device=None,
    conf: ImageNetSiftLcsFVConfig | None = None,
) -> dict:
    """Random parameters of the served shapes, from a ``torch.Generator``
    seeded with ``seed``, as a ``convert.py`` dict of tensors on ``device``:

    - PCA: the mean of synthetic images' descriptors and an orthonormal
      basis (QR of a Gaussian);
    - GMM: means drawn near PCA-projected synthetic descriptors (so that
      responsibilities are spread, not one-hot), variances in [0.5, 1.5],
      normalised weights;
    - head: Gaussian ``W`` (scaled by 1/√feature_dim) and ``b``, in blocks
      of ``HEAD_BLOCK`` features.
    """
    device = resolve_device(device)
    conf = conf or ImageNetSiftLcsFVConfig(gmm_k=gmm_k, pca_dims=pca_dims)
    g = torch.Generator().manual_seed(seed)
    train, _ = ImageNetLoader.synthetic(n=8, num_classes=8, size=64, seed=seed)
    images = torch.from_numpy(train.data).to(device)
    d = {}
    for br, front in _fronts(conf).items():
        with torch.inference_mode(), on_device(device):
            descs = front(images).get().reshape(-1, 128 if br == "sift" else 96).cpu()
        mean = descs.mean(dim=0)
        comps, _ = torch.linalg.qr(torch.randn(descs.shape[1], pca_dims, generator=g))
        proj = (descs - mean) @ comps
        pick = torch.randint(0, proj.shape[0], (gmm_k,), generator=g)
        spread = proj.std(dim=0, keepdim=True)
        means = proj[pick] + 0.1 * spread * torch.randn(gmm_k, pca_dims, generator=g)
        weights = torch.rand(gmm_k, generator=g) + 0.5
        d[f"{br}.pca.components"] = comps
        d[f"{br}.pca.mean"] = mean
        d[f"{br}.gmm.weights"] = weights / weights.sum()
        d[f"{br}.gmm.means"] = means
        d[f"{br}.gmm.variances"] = 0.5 + torch.rand(gmm_k, pca_dims, generator=g)
    D = conf.feature_dim
    d["head.W"] = torch.randn(D, num_classes, generator=g) / D**0.5
    d["head.b"] = 0.01 * torch.randn(num_classes, generator=g)
    d["head.blocks"] = [(s, min(s + HEAD_BLOCK, D)) for s in range(0, D, HEAD_BLOCK)]
    return {
        k: v.to(device=device, dtype=torch.float32) if torch.is_tensor(v) else v
        for k, v in d.items()
    }


def fit_featurizer(conf: ImageNetSiftLcsFVConfig, train_images, device=None) -> Pipeline:
    """Both branches fitted on ``train_images`` and gathered (the
    reference's ``build_featurizer(conf, train_images)``)."""
    conf = resolve_scale(conf)
    fronts = _fronts(conf)
    with on_device(device):
        return Pipeline.gather([
            fit_fisher_featurizer(
                fronts[br], train_images,
                pca_dims=conf.pca_dims, gmm_k=conf.gmm_k, em_iters=conf.gmm_iters,
                sample_size=conf.descriptor_sample, seed=seed, device=device,
            )
            for br, seed in (("sift", conf.seed), ("lcs", conf.seed + 1))
        ])


def fit_head(featurizer: Pipeline, conf: ImageNetSiftLcsFVConfig, train_images,
             train_labels, num_classes: int, device=None) -> Pipeline:
    """``featurizer`` followed by the head fitted on its features of the
    training images: a fitted pipeline from images to (n, num_classes)
    scores. The head's fit is the graph's: ``and_then(solver, images,
    targets)``, forced by ``fit()``."""
    conf = resolve_scale(conf)
    device = resolve_device(device)
    targets = ClassLabelIndicators(num_classes)(torch.as_tensor(train_labels).to(device))
    solver = BlockWeightedLeastSquaresEstimator(
        block_size=conf.block_size,
        num_iters=conf.num_iters,
        lam=conf.lam,
        mixture_weight=conf.mixture_weight,
        checkpoint_dir=conf.checkpoint_dir,
    )
    with on_device(device):
        return featurizer.and_then(solver, train_images, targets).fit()


def fit(conf: ImageNetSiftLcsFVConfig, train: LabeledData, num_classes: int,
        device=None) -> Pipeline:
    """The whole fit: the training images go to ``device`` once, then
    ``fit_featurizer`` and ``fit_head``."""
    device = resolve_device(device)
    images = torch.as_tensor(train.data).to(device)
    mark("copy of the images to the device")
    featurizer = fit_featurizer(conf, images, device)
    return fit_head(featurizer, conf, images, train.labels, num_classes, device)


def _errors(topk: np.ndarray, labels: np.ndarray):
    correct = (topk == labels[:, None]).any(axis=1)
    return float(1.0 - correct.mean()), float((topk[:, 0] != labels).mean())


def evaluate(scored: Pipeline, conf: ImageNetSiftLcsFVConfig, test: LabeledData, device=None):
    """(top-k error, top-1 error) of ``scored`` on ``test``, with the views
    of ``build_tta`` averaged when ``conf.augment``."""
    with torch.inference_mode(), on_device(device):
        if conf.augment:
            patcher, averager = build_tta(conf, test.data.shape[1])
            views = scored(patcher(torch.as_tensor(test.data))).get()
            scores = averager.average_scores(views)
        else:
            scores = scored(test.data).get()
        topk = TopKClassifier(conf.top_k)(scores).cpu().numpy()
    return _errors(topk, test.labels)


def build_tta(conf: ImageNetSiftLcsFVConfig, side: int):
    """The reference's ``_build_tta``: center and four corner crops, each
    also flipped (10 views), of 7/8 of the image side unless
    ``augment_crop``; and the evaluator that averages their scores."""
    patcher = CenterCornerPatcher(crop_size=conf.augment_crop or (side * 7) // 8, with_flips=True)
    return patcher, AugmentedExamplesEvaluator(patcher.num_views)


class ViewAveragedScores(Transformer):
    """images → each image's scores averaged over the patcher's views,
    computed ``images_at_once`` images (their views) at a time so that the
    view tensor stays bounded. Each image's output depends on it alone.
    ``scored`` is a module, or a pipeline, then lowered to its serving
    chain."""

    def __init__(self, scored, patcher: CenterCornerPatcher,
                 averager: AugmentedExamplesEvaluator, images_at_once: int):
        super().__init__()
        self.scored = scored.serving_chain() if isinstance(scored, Pipeline) else scored
        self.patcher = patcher
        self.averager = averager
        self.images_at_once = images_at_once

    def apply_batch(self, X):
        sub = self.images_at_once
        views = torch.cat([self.scored(self.patcher(X[i : i + sub])) for i in range(0, len(X), sub)])
        return self.averager.average_scores(views)


def fit_streamed(conf: ImageNetSiftLcsFVConfig, fit_sample, train_batches, num_classes: int,
                 device=None) -> Pipeline:
    """The reference's streamed fit: the featurizer fitted on
    ``fit_sample`` images, the ``(images, labels)`` batches of
    ``train_batches`` featurized through ``apply_batches`` and kept only as
    host features, assembled in place into one host matrix, and the head
    solved streamed from it (checkpointed in ``conf.checkpoint_dir``).
    Returns images → scores."""
    conf = resolve_scale(conf)
    device = resolve_device(device)
    featurizer = fit_featurizer(conf, fit_sample, device)
    feats, labels = [], []
    with torch.inference_mode(), on_device(device):
        for F, y in featurizer.apply_batches(train_batches):
            if y is None:
                raise ValueError("the training stream must give (images, labels) batches")
            feats.append(F.cpu().numpy())
            labels.append(np.asarray(y))
    if not feats:
        raise ValueError(
            "the training stream produced no batches: check that the data "
            "directory's synsets appear in the label map"
        )
    mark("featurizing the training set")
    # Assembled in place, each batch freed as it lands: the host holds the
    # feature matrix and one batch, not twice the matrix.
    A = np.empty((sum(len(f) for f in feats), feats[0].shape[1]), dtype=np.float32)
    off = 0
    while feats:
        f = feats.pop(0)
        A[off : off + len(f)] = f
        off += len(f)
    mark("assembling the host features")
    targets = ClassLabelIndicators(num_classes)(torch.from_numpy(np.concatenate(labels)).to(device))
    solver = BlockWeightedLeastSquaresEstimator(
        block_size=conf.block_size,
        num_iters=conf.num_iters,
        lam=conf.lam,
        mixture_weight=conf.mixture_weight,
        device=device,
        checkpoint_dir=conf.checkpoint_dir,
        stream=True,
    )
    return featurizer.and_then(solver.fit(A, targets))


def _scoring_engine(model, stream_batch: int, device) -> CompiledPipeline:
    """The classifier head as a serving engine on ``device`` for the
    streamed scorer (the reference's ``:46-66``): one bucket at
    ``stream_batch``, since the stream gives full batches and one trailing
    partial batch, padded up. Its stable name keeps repeated scoring passes
    on the same registry entries."""
    return CompiledPipeline(model, buckets=(stream_batch,), devices=[device],
                            name="imagenet-score-head")


def score_streamed(scored: Pipeline, conf: ImageNetSiftLcsFVConfig, test_batches, side: int,
                   device=None):
    """(scores, labels) of the ``(images, labels)`` batches of
    ``test_batches`` as host arrays. Plainly, the featurizer (every stage of
    ``scored`` but its last) runs through ``apply_batches`` and the head
    through ``_scoring_engine``; with ``conf.augment`` each batch's scores
    are the averages of its images' views (side × side images), scored
    ``max(1, stream_batch // views)`` images at a time."""
    device = resolve_device(device)
    if not conf.augment:
        chain = scored.serving_chain()
        featurizer, head = FusedTransformer(list(chain.stages)[:-1]), chain.stages[-1]
        engine = _scoring_engine(head, conf.stream_batch, device)
        scores, labels = [], []
        with torch.inference_mode():
            feats = featurizer.apply_batches(test_batches, device=device)
            for s, y in head.apply_batches(feats, prefetch_depth=0, engine=engine):
                scores.append(s)
                labels.append(np.asarray(y))
        return np.concatenate(scores), np.concatenate(labels)
    patcher, averager = build_tta(conf, side)
    viewed = ViewAveragedScores(scored, patcher, averager, max(1, conf.stream_batch // patcher.num_views))
    scores, labels = [], []
    with torch.inference_mode():
        for s, y in viewed.apply_batches(test_batches, device=device):
            scores.append(s.cpu().numpy())
            labels.append(np.asarray(y))
    return np.concatenate(scores), np.concatenate(labels)


def _result(conf, top_k_error, top1, seconds, tail="") -> dict:
    return {
        "top_k_error": top_k_error,
        "top_1_error": top1,
        "feature_dim": conf.feature_dim,
        "seconds": seconds,
        "summary": f"top-{conf.top_k} error: {top_k_error:.4f} | top-1 error: {top1:.4f}{tail}",
    }


def _label_map(conf: ImageNetSiftLcsFVConfig) -> dict:
    if not (conf.test_data_path and conf.label_map_path):
        raise ValueError("real data requires test path and label map")
    return ImageNetLoader.load_label_map(conf.label_map_path)


def run_streamed(conf: ImageNetSiftLcsFVConfig, device=None, save_params: Optional[str] = None) -> dict:
    """The reference's ``run_streamed``: ``fit_streamed`` on batches of
    ``stream_batch`` training images, then ``score_streamed`` on the test
    split; its result keys, ``num_views`` with ``augment``. On real data the
    featurizer's sample is ``load_balanced_sample``, the batches come from
    ``stream_batches`` and the classes are the label map's."""
    conf = resolve_scale(conf)
    device = resolve_device(device)
    if conf.data_path:
        label_map = _label_map(conf)
        fit_sample = ImageNetLoader.load_balanced_sample(conf.data_path, label_map, total=conf.fit_sample_images)
        num_classes = max(label_map.values()) + 1
        train_batches = ImageNetLoader.stream_batches(conf.data_path, label_map, batch_size=conf.stream_batch)
        test_batches = ImageNetLoader.stream_batches(conf.test_data_path, label_map, batch_size=conf.stream_batch)
    else:
        train, test = ImageNetLoader.synthetic(n=conf.synthetic_n, num_classes=conf.synthetic_classes)
        fit_sample = train.data[: conf.fit_sample_images]
        num_classes = conf.synthetic_classes
        train_batches = BatchIterator.from_arrays(train.data, train.labels, conf.stream_batch)
        test_batches = BatchIterator.from_arrays(test.data, test.labels, conf.stream_batch)
    mark("loading the featurizer's sample")
    side = fit_sample.shape[1]
    t0 = time.perf_counter()
    scored = fit_streamed(conf, fit_sample, train_batches, num_classes, device)
    scores, labels = score_streamed(scored, conf, test_batches, side, device)
    with torch.inference_mode():
        topk = TopKClassifier(conf.top_k)(torch.from_numpy(scores)).numpy()
    top_k_error, top1 = _errors(topk, labels)
    elapsed = time.perf_counter() - t0
    if save_params:
        np.savez(save_params, **params_to_numpy(scored))
    if not conf.augment:
        return _result(conf, top_k_error, top1, elapsed, " (streamed)")
    views = build_tta(conf, side)[0].num_views
    return {**_result(conf, top_k_error, top1, elapsed, f" (streamed, TTA x{views})"), "num_views": views}


def run(conf: ImageNetSiftLcsFVConfig, device=None, save_params: Optional[str] = None) -> dict:
    """Fit on the training images and score the test split
    (``run_streamed`` when ``conf.stream``); the reference's result keys.
    On real data both splits are loaded whole, and the classes are those
    their labels reach. ``save_params`` writes the fitted parameters as an
    npz that ``--params`` serves."""
    conf = resolve_scale(conf)
    device = resolve_device(device)
    if conf.stream:
        return run_streamed(conf, device, save_params)
    if conf.data_path:
        label_map = _label_map(conf)
        train = ImageNetLoader.load(conf.data_path, label_map)
        test = ImageNetLoader.load(conf.test_data_path, label_map)
        num_classes = int(max(train.labels.max(), test.labels.max())) + 1
    else:
        train, test = ImageNetLoader.synthetic(n=conf.synthetic_n, num_classes=conf.synthetic_classes)
        num_classes = conf.synthetic_classes
    mark("loading the images")
    t0 = time.perf_counter()
    scored = fit(conf, train, num_classes, device)
    top_k_error, top1 = evaluate(scored, conf, test, device)
    elapsed = time.perf_counter() - t0
    if save_params:
        np.savez(save_params, **params_to_numpy(scored))
    return _result(conf, top_k_error, top1, elapsed)


def load_params(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve or fit ImageNetSiftLcsFV (PyTorch/CUDA port)")
    p.add_argument("--fit", action="store_true",
                   help="fit on synthetic images and print the test errors, instead of serving")
    p.add_argument("--data", dest="data_path",
                   help="fit on the real training images here (implies --fit)")
    p.add_argument("--test-data", dest="test_data_path", help="with --data: the test images")
    p.add_argument("--label-map", dest="label_map_path",
                   help="with --data: lines of '<synset> <label>'")
    p.add_argument("--params", help="npz of fitted parameters (keys as in convert.py)")
    p.add_argument("--save-params", help="with --fit: write the fitted parameters to this npz")
    p.add_argument("--device", default="cuda")
    p.add_argument("--gmm-k", type=int, default=None,
                   help="GMM components per branch (default: 256 to serve or to fit on "
                   "real images; 16 to fit on synthetic images)")
    p.add_argument("--pca-dims", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--requests", default="1,3,16", help="comma-separated request sizes")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lam", type=float, default=1e-3)
    p.add_argument("--mixture-weight", type=float, default=0.5)
    p.add_argument("--synthetic-n", type=int, default=512)
    p.add_argument("--synthetic-classes", type=int, default=16)
    p.add_argument("--stream", action="store_true",
                   help="fit out of core: featurize in batches, keep only features, "
                   "stream the head's solve from the host")
    p.add_argument("--stream-batch", type=int, default=256)
    p.add_argument("--fit-sample-images", type=int, default=512)
    p.add_argument("--checkpoint-dir", default=None,
                   help="where the head's solve checkpoints and resumes")
    p.add_argument("--augment", action="store_true",
                   help="score each test image as the mean over its center and corner crops")
    p.add_argument("--augment-crop", type=int, default=0,
                   help="crop side in pixels (0 = 7/8 of the image side)")
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    if a.fit or a.stream or a.augment or a.data_path:
        out = run(
            ImageNetSiftLcsFVConfig(
                data_path=a.data_path, test_data_path=a.test_data_path,
                label_map_path=a.label_map_path, pca_dims=a.pca_dims, gmm_k=a.gmm_k, lam=a.lam,
                mixture_weight=a.mixture_weight, top_k=a.top_k, seed=a.seed,
                synthetic_n=a.synthetic_n, synthetic_classes=a.synthetic_classes,
                augment=a.augment, augment_crop=a.augment_crop, stream=a.stream,
                stream_batch=a.stream_batch, fit_sample_images=a.fit_sample_images,
                checkpoint_dir=a.checkpoint_dir,
            ),
            device,
            save_params=a.save_params,
        )
        print(out["summary"])
        print(f"feature dim {out['feature_dim']} | total {out['seconds']:.2f}s")
        return out

    gmm_k = 256 if a.gmm_k is None else a.gmm_k
    conf = ImageNetSiftLcsFVConfig(gmm_k=gmm_k, pca_dims=a.pca_dims, top_k=a.top_k)
    if a.params:
        raw = load_params(a.params)
    else:
        raw = seeded_params(a.seed, gmm_k, a.pca_dims, a.num_classes, device, conf)
    params = params_from_numpy(raw, device)
    engine = CompiledPipeline(build_serving_pipeline(params, conf), max_batch=a.max_batch,
                              devices=[device])
    engine.warmup((a.image_size, a.image_size, 3))
    sizes = [int(s) for s in a.requests.split(",") if s]
    _, test = ImageNetLoader.synthetic(n=4, size=a.image_size, seed=a.seed)
    rng = np.random.default_rng(a.seed)
    results = []
    for n in sizes:
        X = test.data[rng.integers(0, len(test.data), size=n)]
        t0 = time.perf_counter()
        topk = engine(X)
        ms = 1e3 * (time.perf_counter() - t0)
        results.append(topk)
        print(f"request of {n}: {ms:.3f} ms, top-{a.top_k} of first image {topk[0].tolist()}")
    return results


if __name__ == "__main__":
    main()
