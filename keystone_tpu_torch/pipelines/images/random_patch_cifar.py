"""RandomPatchCifar — the CIFAR pipeline: whitened random-patch filters,
convolution, rectification, pooling and a block least-squares head.

Counterpart of ``keystone_tpu/pipelines/images/random_patch_cifar.py``
(config :44-62, ``build_featurizer`` :65, ``run`` :92, ``main`` :127):

    filters: RandomPatcher(patch_sample, seed) → ZCAWhitenerEstimator(zca_eps)
             → num_filters patches drawn (seed + 1), whitened, unit-normalised
    images (n, 32, 32, 3) → Convolver(filters, ZCA folded) → SymmetricRectifier(alpha)
        → Pooler(sum, pool_size, pool_stride) → ImageVectorizer
        → BlockLeastSquaresEstimator on ±1 class indicators → MaxClassifier

At the reference's widths (256 filters of 6×6, pool 13 at stride 13) a
32×32 image gives 27×27×256 responses, 512 channels rectified, 2×2 pooled
cells: 2,048 features. ``feature_dtype="bfloat16"`` convolves bfloat16
operands into float32 (``nodes/images/convolver.py`` says how on the card);
the rectifier, the pooling and the solve stay float32. The patch sample,
the ZCA fit and the filters run on ``device`` with the images; the patch
and filter indices come from numpy generators, as in the reference.

    python -m keystone_tpu_torch.pipelines.images.random_patch_cifar [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import CifarLoader
from keystone_tpu_torch.nodes.images.convolver import Convolver
from keystone_tpu_torch.nodes.images.patches import RandomPatcher
from keystone_tpu_torch.nodes.images.pixels import ImageVectorizer
from keystone_tpu_torch.nodes.images.pooling import Pooler, SymmetricRectifier
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import Pipeline, on_device


@dataclass
class RandomPatchCifarConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_filters: int = 256
    patch_size: int = 6
    patch_sample: int = 10000
    pool_size: int = 13
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float = 10.0
    block_size: int = 4096
    num_iters: int = 3
    zca_eps: float = 0.1
    num_classes: int = 10
    seed: int = 0
    synthetic_n: int = 2048
    # "bfloat16": bfloat16 operands, float32 accumulation in the convolution.
    feature_dtype: Optional[str] = None


def conv_featurizer(conf: RandomPatchCifarConfig, convolver: Convolver) -> Pipeline:
    """images → features around a fitted ``Convolver`` (the port's, or the
    reference's carried by ``convert.convolver_from_numpy``)."""
    return (
        convolver.and_then(SymmetricRectifier(alpha=conf.alpha))
        .and_then(Pooler(conf.pool_stride, conf.pool_size, mode="sum"))
        .and_then(ImageVectorizer())
    )


def build_featurizer(conf: RandomPatchCifarConfig, train_images, device=None) -> Pipeline:
    """Fit the filters (random whitened patches of ``train_images``) on
    ``device`` and build the convolutional featurizer."""
    device = resolve_device(device)
    images = torch.as_tensor(train_images).to(device)
    patches = RandomPatcher(num_patches=conf.patch_sample, patch_size=conf.patch_size, seed=conf.seed)(images)
    flat = patches.reshape(patches.shape[0], -1)
    mark("patch sample")
    whitener = ZCAWhitenerEstimator(eps=conf.zca_eps).fit(flat)
    mark("ZCA")
    idx = np.random.default_rng(conf.seed + 1).choice(flat.shape[0], size=conf.num_filters, replace=False)
    filt = whitener(flat[torch.from_numpy(idx).to(device)])
    filt = filt / torch.clamp_min(torch.linalg.vector_norm(filt, dim=1, keepdim=True), 1e-8)
    filters = filt.reshape(conf.num_filters, conf.patch_size, conf.patch_size, images.shape[-1])
    convolver = Convolver(filters, whitener=whitener, compute_dtype=conf.feature_dtype, device=device)
    mark("filters")
    return conv_featurizer(conf, convolver)


def fit(conf: RandomPatchCifarConfig, train_images, train_labels, device=None) -> Pipeline:
    """images → int32 class predictions: the training images go to
    ``device`` once, then the filters and the head are fitted there."""
    device = resolve_device(device)
    images = torch.as_tensor(train_images).to(device)
    mark("copy of the images to the device")
    featurizer = build_featurizer(conf, images, device)
    targets = ClassLabelIndicators(conf.num_classes)(torch.as_tensor(train_labels).to(device))
    solver = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam)
    with on_device(device):
        return featurizer.and_then(solver, images, targets).and_then(MaxClassifier()).fit()


def predict(pipeline: Pipeline, images, device=None):
    """``pipeline`` on host images (in batches) on ``device``, as numpy."""
    with torch.inference_mode(), on_device(device):
        return pipeline(images).get().cpu().numpy()


def run(conf: RandomPatchCifarConfig, device=None) -> dict:
    """Fit on the training split and predict the test split; the
    reference's result keys."""
    device = resolve_device(device)
    if conf.train_path:
        if not conf.test_path:
            raise ValueError("--test is required when --train is given")
        train = CifarLoader.load(conf.train_path)
        test = CifarLoader.load(conf.test_path)
    else:
        train, test = CifarLoader.synthetic(n=conf.synthetic_n)
    mark("loading the images")

    t0 = time.perf_counter()
    pipeline = fit(conf, train.data, train.labels, device)
    predictions = predict(pipeline, test.data, device)
    mark("predicting the test images")
    elapsed = time.perf_counter() - t0

    metrics = MulticlassClassifierEvaluator(conf.num_classes).evaluate(predictions, test.labels)
    return {
        "test_accuracy": metrics.total_accuracy,
        "macro_f1": metrics.macro_f1,
        "seconds": elapsed,
        "summary": metrics.summary(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="RandomPatchCifar pipeline (PyTorch/CUDA port)")
    p.add_argument("--train", dest="train_path")
    p.add_argument("--test", dest="test_path")
    p.add_argument("--num-filters", type=int, default=256)
    p.add_argument("--patch-size", type=int, default=6)
    p.add_argument("--lam", type=float, default=10.0)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=2048)
    p.add_argument("--feature-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    conf = RandomPatchCifarConfig(
        train_path=a.train_path,
        test_path=a.test_path,
        num_filters=a.num_filters,
        patch_size=a.patch_size,
        lam=a.lam,
        num_iters=a.num_iters,
        seed=a.seed,
        synthetic_n=a.synthetic_n,
        feature_dtype=a.feature_dtype,
    )
    out = run(conf, a.device)
    print(out["summary"])
    print(f"total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
