"""AmazonReviewsPipeline — binary sentiment over the text front end.

Counterpart of ``keystone_tpu/pipelines/text/amazon_reviews.py`` (config
:30, ``run`` :39, ``main`` :82):

    reviews → the front end (pipelines/text/common.py) → CommonSparseFeatures(20,000)
            → LogisticRegressionEstimator(2, reg) → scores

At its default 20,000 features (at or above ``config.text_sparse_threshold``)
the features are a CSR ``SparseBatch`` and the fit keeps them sparse on
``device``. The prediction is the larger score, the AUC's score the margin
s₁ − s₀. Reviews come from JSON lines or CSV (``AmazonReviewsDataLoader.load``,
stars above 3.5 positive) or from ``AmazonReviewsDataLoader.synthetic``.

    python -m keystone_tpu_torch.pipelines.text.amazon_reviews [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.binary import BinaryClassifierEvaluator
from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader
from keystone_tpu_torch.nodes.learning.logistic_regression import LogisticRegressionEstimator
from keystone_tpu_torch.pipelines.text import common
from keystone_tpu_torch.utils.stages import mark


@dataclass
class AmazonReviewsConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_features: int = 20000
    ngrams: int = 2
    reg: float = 1e-3
    synthetic_n: int = 1000


def load(conf: AmazonReviewsConfig):
    """(train, test)."""
    if conf.train_path:
        if not conf.test_path:
            raise ValueError("--test is required when --train is given")
        return AmazonReviewsDataLoader.load(conf.train_path), AmazonReviewsDataLoader.load(conf.test_path)
    return AmazonReviewsDataLoader.synthetic(n=conf.synthetic_n)


def run(conf: AmazonReviewsConfig, device=None) -> dict:
    """Fit on the training reviews and score the test reviews; the
    reference's result keys (``seconds`` on the host clock after loading),
    with ``stage_seconds``, the L-BFGS ``lbfgs_steps``,
    ``lbfgs_evaluations`` and final ``objective``, the test reviews'
    ``scores``, and the training and test ``features`` and
    ``test_features`` (for a caller that fits another head on them)."""
    device = resolve_device(device)
    train, test = load(conf)
    mark("loading the reviews")
    est = LogisticRegressionEstimator(num_classes=2, reg=conf.reg, device=device)

    t0 = time.perf_counter()
    fitted = common.fit(train.data, train.labels, conf.ngrams, conf.num_features, est, device)
    tested = common.scores(fitted["pipeline"], test.data, device)
    elapsed = time.perf_counter() - t0

    scores = tested["scores"]
    margin = scores[:, 1] - scores[:, 0]
    metrics = BinaryClassifierEvaluator.evaluate(scores.argmax(axis=1), test.labels, scores=margin)
    return {
        "accuracy": metrics.accuracy,
        "auc": metrics.auc,
        "f1": metrics.f1,
        "seconds": elapsed,
        "stage_seconds": {**fitted["seconds"], **tested["seconds"]},
        "lbfgs_steps": len(est.result.values),
        "lbfgs_evaluations": est.result.evaluations,
        "objective": est.result.value,
        "scores": scores,
        "features": fitted["features"],
        "test_features": tested["features"],
        "summary": metrics.summary(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Amazon reviews sentiment pipeline (PyTorch/CUDA port)")
    p.add_argument("--train", dest="train_path")
    p.add_argument("--test", dest="test_path")
    p.add_argument("--num-features", type=int, default=20000)
    p.add_argument("--ngrams", type=int, default=2)
    p.add_argument("--reg", type=float, default=1e-3)
    p.add_argument("--synthetic-n", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    conf = AmazonReviewsConfig(
        train_path=a.train_path,
        test_path=a.test_path,
        num_features=a.num_features,
        ngrams=a.ngrams,
        reg=a.reg,
        synthetic_n=a.synthetic_n,
    )
    out = run(conf, a.device)
    print(out["summary"])
    print(f"total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
