"""NewsgroupsPipeline — text classification over 20 newsgroups.

Counterpart of ``keystone_tpu/pipelines/text/newsgroups.py`` (config :34,
``run`` :45, ``main`` :96):

    texts → Trim → LowerCase → Tokenizer → NGramsFeaturizer(1, n) → TermFrequency(log)
          → CommonSparseFeatures(num_features) → NaiveBayes | LogisticRegression → MaxClassifier

The front end is host code (``pipelines/text/common.py``); the classifier
fits on ``device``. Below ``config.text_sparse_threshold`` (16,384) features
are a dense array, at or above it a CSR ``SparseBatch``. Documents come from
a directory per class (``NewsgroupsDataLoader.load``; the test split is
read with the training split's classes) or from
``NewsgroupsDataLoader.synthetic``.

    python -m keystone_tpu_torch.pipelines.text.newsgroups [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader
from keystone_tpu_torch.nodes.learning.logistic_regression import LogisticRegressionEstimator
from keystone_tpu_torch.nodes.learning.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.pipelines.text import common
from keystone_tpu_torch.utils.stages import mark


@dataclass
class NewsgroupsConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_features: int = 10000
    ngrams: int = 2
    classifier: str = "naive_bayes"  # or "logistic"
    num_classes: int = 5
    synthetic_n: int = 1000


def load(conf: NewsgroupsConfig):
    """(train, test, class names)."""
    if conf.train_path:
        if not conf.test_path:
            raise ValueError("--test is required when --train is given")
        train, classes = NewsgroupsDataLoader.load(conf.train_path)
        test, _ = NewsgroupsDataLoader.load(conf.test_path, classes=classes)
        return train, test, classes
    return NewsgroupsDataLoader.synthetic(n=conf.synthetic_n, num_classes=conf.num_classes)


def estimator(conf: NewsgroupsConfig, num_classes: int, device):
    if conf.classifier == "naive_bayes":
        return NaiveBayesEstimator(num_classes, device=device)
    if conf.classifier == "logistic":
        return LogisticRegressionEstimator(num_classes, device=device)
    raise ValueError(f"unknown classifier {conf.classifier!r}")


def run(conf: NewsgroupsConfig, device=None) -> dict:
    """Fit on the training texts and classify the test texts; the
    reference's result keys (``seconds`` on the host clock after loading),
    with the stages' ``stage_seconds``, the test texts' ``scores`` and, for
    ``logistic``, the L-BFGS
    ``lbfgs_steps``, ``lbfgs_evaluations`` and final ``objective``."""
    device = resolve_device(device)
    train, test, classes = load(conf)
    mark("loading the texts")
    num_classes = len(classes)
    est = estimator(conf, num_classes, device)

    t0 = time.perf_counter()
    fitted = common.fit(train.data, train.labels, conf.ngrams, conf.num_features, est, device)
    tested = common.scores(fitted["pipeline"], test.data, device)
    elapsed = time.perf_counter() - t0

    metrics = MulticlassClassifierEvaluator(num_classes).evaluate(tested["scores"].argmax(axis=1), test.labels)
    out = {
        "test_accuracy": metrics.total_accuracy,
        "macro_f1": metrics.macro_f1,
        "seconds": elapsed,
        "stage_seconds": {**fitted["seconds"], **tested["seconds"]},
        "scores": tested["scores"],
        "classes": classes,
        "summary": metrics.summary(),
    }
    if isinstance(est, LogisticRegressionEstimator):
        out.update(lbfgs_steps=len(est.result.values), lbfgs_evaluations=est.result.evaluations,
                   objective=est.result.value)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Newsgroups text pipeline (PyTorch/CUDA port)")
    p.add_argument("--train", dest="train_path")
    p.add_argument("--test", dest="test_path")
    p.add_argument("--num-features", type=int, default=10000)
    p.add_argument("--ngrams", type=int, default=2)
    p.add_argument("--classifier", choices=["naive_bayes", "logistic"], default="naive_bayes")
    p.add_argument("--synthetic-n", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    conf = NewsgroupsConfig(
        train_path=a.train_path,
        test_path=a.test_path,
        num_features=a.num_features,
        ngrams=a.ngrams,
        classifier=a.classifier,
        synthetic_n=a.synthetic_n,
    )
    out = run(conf, a.device)
    print(out["summary"])
    print(f"total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
