"""LinearPixels — the CIFAR sanity pipeline: grayscale pixels, a ridge
solve.

Counterpart of ``keystone_tpu/pipelines/images/linear_pixels.py`` (config
:22, ``run`` :30, ``main`` :58): images → GrayScaler → ImageVectorizer
(1,024 features of a 32×32 image) → ``LinearMapEstimator(lam)`` on ±1
class indicators → MaxClassifier, fitted on ``device``.

    python -m keystone_tpu_torch.pipelines.images.linear_pixels [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import CifarLoader
from keystone_tpu_torch.nodes.images.pixels import GrayScaler, ImageVectorizer
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import on_device


@dataclass
class LinearPixelsConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    lam: float = 1.0
    num_classes: int = 10
    synthetic_n: int = 2048


def fit(conf: LinearPixelsConfig, train_images, train_labels, device=None):
    """images → int32 class predictions, the head fitted on ``device``."""
    device = resolve_device(device)
    images = torch.as_tensor(train_images).to(device)
    targets = ClassLabelIndicators(conf.num_classes)(torch.as_tensor(train_labels).to(device))
    with on_device(device):
        return GrayScaler().and_then(ImageVectorizer()).and_then(
            LinearMapEstimator(lam=conf.lam), images, targets
        ).and_then(MaxClassifier()).fit()


def run(conf: LinearPixelsConfig, device=None) -> dict:
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
    with torch.inference_mode(), on_device(device):
        predictions = pipeline(test.data).get().cpu().numpy()
    mark("predicting the test images")
    elapsed = time.perf_counter() - t0

    metrics = MulticlassClassifierEvaluator(conf.num_classes).evaluate(predictions, test.labels)
    return {
        "test_accuracy": metrics.total_accuracy,
        "seconds": elapsed,
        "summary": metrics.summary(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="LinearPixels CIFAR pipeline (PyTorch/CUDA port)")
    p.add_argument("--train", dest="train_path")
    p.add_argument("--test", dest="test_path")
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--synthetic-n", type=int, default=2048)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    out = run(
        LinearPixelsConfig(train_path=a.train_path, test_path=a.test_path, lam=a.lam,
                           synthetic_n=a.synthetic_n),
        a.device,
    )
    print(out["summary"])
    print(f"total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
