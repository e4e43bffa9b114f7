"""MnistRandomFFT — the MNIST pipeline: random sign flips, FFTs, a ridge
solve.

Counterpart of ``keystone_tpu/pipelines/images/mnist_random_fft.py``
(config :30, ``build_pipeline`` :40, ``run`` :55, ``main`` :91):

    rows (n, 784) ─┬─ RandomSignNode(seed) → PaddedFFT → LinearRectifier ─┐
                   ├─ ... one branch per FFT (num_ffts; seed + i) ...      ├─ gather → LinearMapEstimator → MaxClassifier
                   └─ RandomSignNode(seed + 3) → PaddedFFT → LinearRectifier ┘

Each branch gives 1,026 features (784 zero-padded to 1,024), so 4 FFTs
give 4,104. The head is ridge least squares on ±1 class indicators
(``LinearMapEstimator``, the normal equations), fitted on the training
rows on ``device``. Rows come from IDX or CSV files (``MnistLoader.load``)
or from ``MnistLoader.synthetic``.

The signs are drawn from a ``torch.Generator`` seeded with ``seed + i``,
not by ``jax.random``, so they are not the reference's signs for the same
seed (``nodes/stats/random_signs.py``); ``build_featurizer`` takes the
reference's as arrays.

    python -m keystone_tpu_torch.pipelines.images.mnist_random_fft [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.mnist import MnistLoader
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
from keystone_tpu_torch.nodes.stats.fft import PaddedFFT
from keystone_tpu_torch.nodes.stats.random_signs import RandomSignNode
from keystone_tpu_torch.nodes.stats.rectifier import LinearRectifier
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import Pipeline, on_device


@dataclass
class MnistRandomFFTConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_ffts: int = 4
    lam: float = 0.1
    seed: int = 0
    num_classes: int = 10
    synthetic_n: int = 4096  # used when no data paths are given


def build_featurizer(conf: MnistRandomFFTConfig, dim: int, signs: Optional[Sequence] = None,
                     device=None) -> Pipeline:
    """The gathered branches, rows → (n, num_ffts · 2·(n_fft/2 + 1)). Branch
    i flips by ``signs[i]`` when given, else by
    ``RandomSignNode.create(dim, seed=conf.seed + i)``."""
    device = resolve_device(device)
    nodes = (
        [RandomSignNode(s, device=device) for s in signs] if signs is not None
        else [RandomSignNode.create(dim, seed=conf.seed + i, device=device) for i in range(conf.num_ffts)]
    )
    return Pipeline.gather([node.and_then(PaddedFFT()).and_then(LinearRectifier()) for node in nodes])


def build_pipeline(conf: MnistRandomFFTConfig, train, train_labels, device=None,
                   featurizer: Optional[Pipeline] = None) -> Pipeline:
    """Rows → int32 class predictions, the head fitted on ``train`` (host
    rows or a tensor) through ``featurizer`` (``build_featurizer``'s unless
    given) on ``device``."""
    device = resolve_device(device)
    featurizer = featurizer or build_featurizer(conf, train.shape[1], device=device)
    targets = ClassLabelIndicators(conf.num_classes)(torch.as_tensor(train_labels).to(device))
    with on_device(device):
        return featurizer.and_then(LinearMapEstimator(lam=conf.lam), train, targets).and_then(
            MaxClassifier()
        ).fit()


def predict(pipeline: Pipeline, rows, device=None):
    """``pipeline`` on host rows (in batches) on ``device``, as numpy."""
    with torch.inference_mode(), on_device(device):
        return pipeline(rows).get().cpu().numpy()


def run(conf: MnistRandomFFTConfig, device=None) -> dict:
    """Fit on the training rows, predict the test and the training rows;
    the reference's result keys."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    if conf.train_path:
        if not conf.test_path:
            raise ValueError(
                "--test is required when --train is given (evaluating on the "
                "training set would report memorization as test accuracy)"
            )
        train = MnistLoader.load(conf.train_path)
        test = MnistLoader.load(conf.test_path)
    else:
        train, test = MnistLoader.synthetic(n=conf.synthetic_n, seed=conf.seed)
    t_load = time.perf_counter() - t0
    mark("loading the rows")

    t0 = time.perf_counter()
    rows = torch.as_tensor(train.data).to(device)
    mark("copy of the rows to the device")
    pipeline = build_pipeline(conf, rows, train.labels, device)
    predictions = predict(pipeline, test.data, device)
    mark("predicting the test rows")
    t_fit = time.perf_counter() - t0

    evaluator = MulticlassClassifierEvaluator(conf.num_classes)
    metrics = evaluator.evaluate(predictions, test.labels)
    train_metrics = evaluator.evaluate(predict(pipeline, rows, device), train.labels)
    mark("predicting the training rows")
    return {
        "test_accuracy": metrics.total_accuracy,
        "train_accuracy": train_metrics.total_accuracy,
        "macro_f1": metrics.macro_f1,
        "load_seconds": t_load,
        "fit_predict_seconds": t_fit,
        "summary": metrics.summary(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="MnistRandomFFT pipeline (PyTorch/CUDA port)")
    p.add_argument("--train", dest="train_path")
    p.add_argument("--test", dest="test_path")
    p.add_argument("--num-ffts", type=int, default=4)
    p.add_argument("--lam", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    conf = MnistRandomFFTConfig(
        train_path=a.train_path,
        test_path=a.test_path,
        num_ffts=a.num_ffts,
        lam=a.lam,
        seed=a.seed,
        synthetic_n=a.synthetic_n,
    )
    out = run(conf, a.device)
    print(out["summary"])
    print(
        f"train acc {out['train_accuracy']:.4f} | "
        f"load {out['load_seconds']:.2f}s | fit+predict {out['fit_predict_seconds']:.2f}s"
    )
    return out


if __name__ == "__main__":
    main()
