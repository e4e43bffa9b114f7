"""TimitPipeline — the speech pipeline: frames, random cosine features, a
block least-squares head.

Counterpart of ``keystone_tpu/pipelines/speech/timit.py`` (config :27,
``run`` :44, ``main`` :97):

    frames (n, 440) → StandardScaler → CosineRandomFeatures (γ, seed)
                    → BlockLeastSquaresEstimator (blocks, epochs, λ) → MaxClassifier

The scaler is fitted on the training frames on ``device``; the head on ±1
phone indicators. Frames come from an ``.npz`` or CSV pair
(``TimitFeaturesDataLoader.load``; 147 phone states, the reference's
``NUM_PHONES``) or from ``TimitFeaturesDataLoader.synthetic``. Where the
training features' float32 bytes exceed half the memory budget (6 GiB;
200,000 frames at 16,384 features are 12.2 GiB) the head is solved
streamed from host memory, as the reference's auto rule does.

W and b are drawn from a ``torch.Generator`` seeded with ``seed``, not by
``jax.random`` (``nodes/stats/random_features.py``); ``run`` takes the
reference's as ``random_features``.

    python -m keystone_tpu_torch.pipelines.speech.timit [--device cpu]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional

import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats.random_features import CosineRandomFeatures
from keystone_tpu_torch.nodes.stats.scalers import StandardScaler
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
from keystone_tpu_torch.utils.stages import mark, synced_clock
from keystone_tpu_torch.workflow import on_device


@dataclass
class TimitConfig:
    features_path: Optional[str] = None
    labels_path: Optional[str] = None
    test_features_path: Optional[str] = None
    test_labels_path: Optional[str] = None
    num_features: int = 4096
    gamma: float = 0.055  # the RBF bandwidth scale of the reference setup
    distribution: str = "gaussian"  # or "cauchy"
    lam: float = 0.1
    block_size: int = 2048
    num_iters: int = 3
    num_phones: int = 24
    seed: int = 0
    synthetic_n: int = 4096


def load(conf: TimitConfig):
    """(train, test, number of phones)."""
    if conf.features_path:
        if not conf.test_features_path:
            raise ValueError("test features are required with real data")
        train = TimitFeaturesDataLoader.load(conf.features_path, conf.labels_path)
        test = TimitFeaturesDataLoader.load(conf.test_features_path, conf.test_labels_path)
        return train, test, TimitFeaturesDataLoader.NUM_PHONES
    train, test = TimitFeaturesDataLoader.synthetic(n=conf.synthetic_n, num_phones=conf.num_phones, seed=conf.seed)
    return train, test, conf.num_phones


def run(conf: TimitConfig, device=None, random_features: Optional[CosineRandomFeatures] = None) -> dict:
    """Fit on the training frames and predict the test frames; the
    reference's result keys (``seconds`` on the host clock after loading)
    and the test frames' ``scores``."""
    device = resolve_device(device)
    train, test, num_phones = load(conf)
    mark("loading the frames")

    t0 = synced_clock(device)
    rows = torch.as_tensor(train.data).to(device)
    mark("copy of the frames to the device")
    scaler = StandardScaler(device=device).fit_pipeline(rows)
    mark("scaler")
    rf = random_features or CosineRandomFeatures.create(
        input_dim=rows.shape[1],
        num_features=conf.num_features,
        gamma=conf.gamma,
        distribution=conf.distribution,
        seed=conf.seed,
        device=device,
    )
    targets = ClassLabelIndicators(num_phones)(torch.as_tensor(train.labels).to(device))
    with on_device(device):
        pipeline = scaler.and_then(rf).and_then(
            BlockLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
                                       device=device),
            rows,
            targets,
        ).fit()
    with torch.inference_mode(), on_device(device):
        scores = pipeline(test.data).get()
        predictions = MaxClassifier()(scores).cpu().numpy()
    mark("predicting the test frames")
    elapsed = synced_clock(device) - t0

    metrics = MulticlassClassifierEvaluator(num_phones).evaluate(predictions, test.labels)
    return {
        "test_accuracy": metrics.total_accuracy,
        "phone_error_rate": 1.0 - metrics.total_accuracy,
        "macro_f1": metrics.macro_f1,
        "seconds": elapsed,
        "scores": scores.cpu().numpy(),
        "summary": metrics.summary(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="TIMIT speech pipeline (PyTorch/CUDA port)")
    p.add_argument("--features", dest="features_path")
    p.add_argument("--labels", dest="labels_path")
    p.add_argument("--test-features", dest="test_features_path")
    p.add_argument("--test-labels", dest="test_labels_path")
    p.add_argument("--num-features", type=int, default=4096)
    p.add_argument("--gamma", type=float, default=0.055)
    p.add_argument("--distribution", choices=["gaussian", "cauchy"], default="gaussian")
    p.add_argument("--lam", type=float, default=0.1)
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--num-phones", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    conf = TimitConfig(
        features_path=a.features_path,
        labels_path=a.labels_path,
        test_features_path=a.test_features_path,
        test_labels_path=a.test_labels_path,
        num_features=a.num_features,
        gamma=a.gamma,
        distribution=a.distribution,
        lam=a.lam,
        block_size=a.block_size,
        num_iters=a.num_iters,
        num_phones=a.num_phones,
        seed=a.seed,
        synthetic_n=a.synthetic_n,
    )
    out = run(conf, a.device)
    print(out["summary"])
    print(f"PER {out['phone_error_rate']:.4f} | total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
