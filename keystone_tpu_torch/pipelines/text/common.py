"""The text pipelines' shared front end (the stages both
``keystone_tpu/pipelines/text/newsgroups.py`` and ``amazon_reviews.py``
build): Trim → LowerCase → Tokenizer → NGramsFeaturizer(1, n) →
TermFrequency("log") → CommonSparseFeatures(num_features), all host
stages; and the fit of a classifier on its features, timed apart."""

from __future__ import annotations

import time

from keystone_tpu_torch.nodes.nlp import (
    CommonSparseFeatures,
    LowerCase,
    NGramsFeaturizer,
    TermFrequency,
    Tokenizer,
    Trim,
)
from keystone_tpu_torch.utils.stages import mark, synced_clock
from keystone_tpu_torch.workflow import FusedTransformer, Pipeline


def front_end(ngrams: int) -> Pipeline:
    """Texts → {term: log(count + 1)} maps of their 1..``ngrams``-grams."""
    return (
        Trim()
        .and_then(LowerCase())
        .and_then(Tokenizer())
        .and_then(NGramsFeaturizer(1, ngrams))
        .and_then(TermFrequency("log"))
    )


def fit(texts, labels, ngrams: int, num_features: int, estimator, device) -> dict:
    """Fits the front end's term index on ``texts``, then ``estimator`` on
    their features, each stage once. Returns the fitted ``pipeline``
    (texts → scores), the ``features`` of ``texts`` (a dense numpy array,
    or a ``SparseBatch`` at or above ``config.text_sparse_threshold``
    columns) and the stages' host-clock ``seconds``: ``front_end`` and
    ``vectorize`` on the host, ``fit`` until the device is done."""
    t0 = time.perf_counter()
    front = front_end(ngrams)
    term_maps = front(texts).get()
    mark("front end, training texts")
    t1 = time.perf_counter()
    vectorizer = CommonSparseFeatures(num_features).fit_pipeline(term_maps)
    features = vectorizer(term_maps).get()
    del term_maps
    mark("term index and vectorizing the training texts")
    t2 = time.perf_counter()
    model = estimator.fit_pipeline(features, labels)
    mark("fit")
    t3 = synced_clock(device)
    return {
        "pipeline": front.and_then(vectorizer).and_then(model),
        "features": features,
        "seconds": {"front_end": t1 - t0, "vectorize": t2 - t1, "fit": t3 - t2},
    }


def scores(pipeline: Pipeline, texts, device) -> dict:
    """``pipeline`` (``fit``'s) on ``texts``: the ``scores`` as numpy, the
    ``features`` the model took, and the host-clock ``seconds`` of the
    front end and of the model."""
    *host, model = pipeline.transformers()
    t0 = time.perf_counter()
    features = FusedTransformer(host)(texts)
    mark("front end and vectorizing, test texts")
    t1 = time.perf_counter()
    out = model(features).cpu().numpy()
    mark("scoring the test texts")
    return {"scores": out, "features": features,
            "seconds": {"front_end_test": t1 - t0, "predict": synced_clock(device) - t1}}
