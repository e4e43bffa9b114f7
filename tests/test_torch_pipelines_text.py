"""The text pipelines (Newsgroups, Amazon reviews) and their parts in the
port, held against the JAX package on the CPU.

- Loaders (the fixtures under ``tests/fixtures/data/{newsgroups,amazon}``,
  CSV, synthetic with and without label noise): the same texts and labels.
- The nlp nodes are host code run the same way: tokens, n-grams, term
  weights and term indices equal (the indices as dicts, so ties rank in
  the same first-seen order), dense and sparse rows equal bit for bit.
- The pipeline core's host stages: ``and_then(estimator, data, labels)``
  over a host prefix and ``with_data``.
- Naive Bayes on dense features: the log prior, log likelihood and scores
  within rtol 1e-5, atol 1e-5 (float32 sums in another order).
- Logistic regression on dense features against optax's L-BFGS, 100 steps
  from zero on a strictly convex problem (reg > 0): both near the optimum,
  so the objectives within a relative 1e-5, the predictions equal on at
  least 99% of rows, and W within 1e-3 of the largest |W| where both
  gradients are below 1e-4 in norm.
- Carried parameters (``convert.py``): the same scores as the reference's
  fitted models, rtol 1e-5, atol 1e-5.
- ``run``: on the reference's synthetic data and on the fixtures, the same
  accuracy and macro-F1 (Newsgroups) or accuracy, F1 and AUC (Amazon)
  within one document's worth (0.01, or 1/n on a fixture of n texts).

torch runs on two threads here, restored after the module.
"""

import json

import numpy as np
import pytest
import torch

from keystone_tpu.loaders import synthetic as j_synthetic
from keystone_tpu.loaders.amazon import AmazonReviewsDataLoader as JAmazonReviewsDataLoader
from keystone_tpu.loaders.newsgroups import NewsgroupsDataLoader as JNewsgroupsDataLoader
from keystone_tpu.nodes.learning import LogisticRegressionEstimator as JLogisticRegressionEstimator
from keystone_tpu.nodes.learning import NaiveBayesEstimator as JNaiveBayesEstimator
from keystone_tpu.nodes.nlp import CommonSparseFeatures as JCommonSparseFeatures
from keystone_tpu.nodes.nlp import LowerCase as JLowerCase
from keystone_tpu.nodes.nlp import NGramsFeaturizer as JNGramsFeaturizer
from keystone_tpu.nodes.nlp import TermFrequency as JTermFrequency
from keystone_tpu.nodes.nlp import Tokenizer as JTokenizer
from keystone_tpu.nodes.nlp import Trim as JTrim
from keystone_tpu.nodes.nlp import WordFrequencyEncoder as JWordFrequencyEncoder
from keystone_tpu.nodes.util import misc as j_misc
from keystone_tpu.pipelines.text import amazon_reviews as j_amazon
from keystone_tpu.pipelines.text import newsgroups as j_newsgroups
from keystone_tpu_torch.config import config
from keystone_tpu_torch.convert import (
    logistic_regression_from_numpy,
    naive_bayes_from_numpy,
    vectorizer_from_index,
)
from keystone_tpu_torch.linalg import lbfgs
from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader
from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader
from keystone_tpu_torch.nodes.learning.logistic_regression import (
    LogisticRegressionEstimator,
    softmax_objective,
)
from keystone_tpu_torch.nodes.learning.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.nodes.nlp import (
    CommonSparseFeatures,
    LowerCase,
    NGramsFeaturizer,
    TermFrequency,
    Tokenizer,
    Trim,
    WordFrequencyEncoder,
)
from keystone_tpu_torch.nodes.util import misc
from keystone_tpu_torch.pipelines.text import amazon_reviews, common, newsgroups
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.workflow import Estimator, LabelEstimator, Pipeline, Transformer

NEWSGROUPS_FIXTURE = "tests/fixtures/data/newsgroups/train"
AMAZON_FIXTURE = "tests/fixtures/data/amazon/reviews.jsonl"
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
LR_OBJECTIVE_RTOL = 1e-5
LR_AGREEMENT = 0.99
LR_CONVERGED = 1e-4  # gradient norm under which W is compared
LR_W_RTOL = 1e-3
METRIC_TOL = 0.01
TEXTS = [
    "  Hello, World!  ",
    "A-B c",
    "don't STOP   me now",
    "naïve café — über_cool x2\tTabs\nnewlines",
    "",
    "the the the cat the",
]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ref(node, X):
    out = node(X)
    return out.get() if hasattr(out, "get") else out


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _corpus(n=300, seed=0):
    """Synthetic Newsgroups texts: few word types, so term ranks tie often."""
    return NewsgroupsDataLoader.synthetic(n=n, seed=seed)[0]


# --- loaders ---------------------------------------------------------------


def test_newsgroups_fixture_loads_equal():
    (got, got_classes), (want, want_classes) = (
        NewsgroupsDataLoader.load(NEWSGROUPS_FIXTURE), JNewsgroupsDataLoader.load(NEWSGROUPS_FIXTURE))
    assert got.data == want.data and got_classes == want_classes
    _equal(got.labels, want.labels)


def test_newsgroups_test_split_aligns_classes(tmp_path):
    for split, groups in [("train", ["alt", "hockey"]), ("test", ["hockey"])]:
        for g in groups:
            d = tmp_path / split / g
            d.mkdir(parents=True)
            (d / "1.txt").write_text(f"{g} words here")
    train, classes = NewsgroupsDataLoader.load(str(tmp_path / "train"))
    test, _ = NewsgroupsDataLoader.load(str(tmp_path / "test"), classes=classes)
    assert test.labels.tolist() == [classes.index("hockey")]
    (tmp_path / "test" / "zzz").mkdir()
    (tmp_path / "test" / "zzz" / "1.txt").write_text("x")
    for loader in (NewsgroupsDataLoader, JNewsgroupsDataLoader):
        with pytest.raises(ValueError, match="not present in the training"):
            loader.load(str(tmp_path / "test"), classes=classes)


@pytest.mark.parametrize("noise", ["", "0.2"])
def test_synthetic_corpora_equal(monkeypatch, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    got, want = NewsgroupsDataLoader.synthetic(n=200, num_classes=4, seed=3), JNewsgroupsDataLoader.synthetic(
        n=200, num_classes=4, seed=3)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.data == w.data
        _equal(g.labels, w.labels)
    for g, w in zip(AmazonReviewsDataLoader.synthetic(n=150, seed=2), JAmazonReviewsDataLoader.synthetic(n=150, seed=2)):
        assert g.data == w.data
        _equal(g.labels, w.labels)
    assert j_synthetic.label_noise_rate() == (0.2 if noise else 0.0)


def test_amazon_loads_equal(tmp_path):
    got, want = AmazonReviewsDataLoader.load(AMAZON_FIXTURE), JAmazonReviewsDataLoader.load(AMAZON_FIXTURE)
    assert got.data == want.data
    _equal(got.labels, want.labels)
    path = tmp_path / "r.csv"
    path.write_text('"good, really",5\nbad,1\nskip\nmeh,3.5\nok,3.6\n')
    got, want = AmazonReviewsDataLoader.load(str(path)), JAmazonReviewsDataLoader.load(str(path))
    assert got.data == want.data
    _equal(got.labels, want.labels)
    assert got.labels.tolist() == [1, 0, 0, 1]
    with open(AMAZON_FIXTURE) as f:
        stars = [float(json.loads(line)["overall"]) for line in f if line.strip()]
    assert AmazonReviewsDataLoader.load(AMAZON_FIXTURE).labels.tolist() == [int(s > 3.5) for s in stars]


# --- nlp nodes -------------------------------------------------------------


def test_tokenize_chain():
    chain = Trim().and_then(LowerCase()).and_then(Tokenizer())
    assert isinstance(chain, Pipeline) and all(t.host_stage for t in chain.transformers())
    got = chain(TEXTS).get()
    assert got == _ref(JTrim().and_then(JLowerCase()).and_then(JTokenizer()), TEXTS)
    assert got[:2] == [["hello", "world"], ["a", "b", "c"]]
    assert Tokenizer(r"\s+").apply("a b,c") == JTokenizer(r"\s+").apply("a b,c") == ["a", "b,c"]


@pytest.mark.parametrize("lo, hi", [(1, 1), (1, 2), (2, 3), (3, 3)])
def test_ngrams(lo, hi):
    tokens = ["a", "b", "c", "d"]
    assert NGramsFeaturizer(lo, hi).apply(tokens) == JNGramsFeaturizer(lo, hi).apply(tokens)
    assert NGramsFeaturizer(1, 2, joiner="_").apply(tokens[:2]) == ["a", "b", "a_b"]
    for bad in ((2, 1), (0, 2)):
        with pytest.raises(ValueError):
            NGramsFeaturizer(*bad)


@pytest.mark.parametrize("fn", ["identity", "log"])
def test_term_frequency(fn):
    tokens = ["x", "y", "x", "z", "x", "y"]
    got, want = TermFrequency(fn).apply(tokens), JTermFrequency(fn).apply(tokens)
    assert got == want and list(got) == list(want)
    assert TermFrequency(lambda c: 2 * c).apply(["a", "a"]) == {"a": 4}
    with pytest.raises(ValueError):
        TermFrequency("sqrt")


@pytest.mark.parametrize("num_features", [5, 40, 10_000])
def test_common_sparse_features_index_equal(num_features):
    texts = _corpus().data
    front = common.front_end(2)
    jfront = JTrim().and_then(JLowerCase()).and_then(JTokenizer()).and_then(JNGramsFeaturizer(1, 2)).and_then(
        JTermFrequency("log"))
    maps = front(texts).get()
    assert maps == _ref(jfront, texts)
    got, want = CommonSparseFeatures(num_features).fit(maps), JCommonSparseFeatures(num_features).fit(maps)
    assert got.index == want.index and got.dim == want.dim
    _equal(got(maps), np.asarray(want.apply_batch(maps)))
    carried = vectorizer_from_index(want.index, sparse=True)
    sb, jsb = carried(maps), JCommonSparseFeatures(num_features, sparse=True).fit(maps).apply_batch(maps)
    for name in ("indptr", "indices", "values"):
        _equal(getattr(sb, name), getattr(jsb, name))


def test_word_frequency_encoder_equal():
    tokens = [t.split() for t in _corpus(n=100).data]
    got, want = WordFrequencyEncoder(12).fit(tokens), JWordFrequencyEncoder(12).fit(tokens)
    assert got.index == want.index and got.vocabulary == want.vocabulary
    _equal(got(tokens), np.asarray(want.apply_batch(tokens)))


# --- the pipeline core's host stages ---------------------------------------


class _Count(Transformer):
    host_stage = True

    def apply(self, x):
        return len(x)


class _Shift(Transformer):
    host_stage = True

    def __init__(self, by):
        super().__init__()
        self.by = by

    def apply(self, x):
        return x - self.by


class _Mean(Estimator):
    def fit(self, data):
        return _Shift(float(np.mean(data)))


class _Majority(LabelEstimator):
    def fit(self, data, labels):
        self.seen = (list(data), labels)
        return misc.Identity()


def test_host_prefix_fits_on_the_whole_of_the_data():
    texts = ["a", "bb", "cccc"]
    pipe = Trim().and_then(_Count()).and_then(_Mean(), [" a", "bb", "cccc "])
    assert all(t.host_stage for t in pipe.fit().transformers()) and pipe(["dddddd"]).get() == [6 - 7 / 3]
    est = _Majority()
    labels = np.array([0, 1, 1])
    fitted = Trim().and_then(_Count()).and_then(est, texts, labels).fit()
    assert est.seen[0] == [1, 2, 4] and est.seen[1] is labels
    assert not all(t.host_stage for t in fitted.transformers()) and fitted(["xy"]).get() == [2]
    with pytest.raises(TypeError):
        Trim().and_then(_Mean())
    with pytest.raises(NotImplementedError):
        Transformer().apply_batch([1])


def test_with_data():
    got = _Mean().with_data([1, 2, 3])
    assert isinstance(got, Pipeline) and got([5]).get() == [3.0]
    assert all(t.host_stage for t in got.fit().transformers())
    est = _Majority()
    assert isinstance(est.with_data(["a"], [1]).fit().transformers()[0], misc.Identity)


# --- misc nodes --------------------------------------------------------------


def test_misc_nodes(rng):
    X = rng.normal(size=(4, 10)).astype(np.float32)
    X[X < 0] = 0.0
    Xt = torch.from_numpy(X)
    assert misc.Identity()(Xt) is Xt
    assert misc.Cast("float64")(Xt).dtype == torch.float64
    assert misc.Cast(torch.bfloat16)(Xt).dtype == torch.bfloat16
    blocks = misc.VectorSplitter(4)(Xt)
    want = _ref(j_misc.VectorSplitter(4), X)
    assert [tuple(b.shape) for b in blocks] == [tuple(w.shape) for w in want]
    _equal(misc.VectorCombiner()(blocks).numpy(), np.asarray(_ref(j_misc.VectorCombiner(), want)))
    maps = misc.Sparsify()(Xt)
    assert maps == _ref(j_misc.Sparsify(), X)
    _equal(misc.Densify(10)(maps), _ref(j_misc.Densify(10), maps))
    pairs = [[(1, 2.0), (3, 1.0)], []]
    _equal(misc.Densify(5)(pairs), _ref(j_misc.Densify(5), pairs))
    with pytest.raises(ValueError, match="out of range"):
        misc.Densify(3)([{7: 1.0}])


# --- classifiers -------------------------------------------------------------


def _dense_text(num_features=200):
    train = _corpus(n=400)
    front = common.front_end(2)
    vec = CommonSparseFeatures(num_features).fit(front(train.data).get())
    return vec(front(train.data)).get(), train.labels


def test_naive_bayes_dense_and_carried():
    X, y = _dense_text()
    model = NaiveBayesEstimator(5, device="cpu").fit(X, y)
    jmodel = JNaiveBayesEstimator(5).fit(X, y)
    np.testing.assert_allclose(model.log_prior.numpy(), np.asarray(jmodel.log_prior), **SCORE_TOL)
    np.testing.assert_allclose(model.log_likelihood.numpy(), np.asarray(jmodel.log_likelihood), **SCORE_TOL)
    want = np.asarray(jmodel.apply_batch(X))
    np.testing.assert_allclose(model(X).numpy(), want, **SCORE_TOL)
    carried = naive_bayes_from_numpy(jmodel.log_prior, jmodel.log_likelihood, device="cpu")
    np.testing.assert_allclose(carried(torch.from_numpy(X)).numpy(), want, **SCORE_TOL)
    # The fit on a tensor stays on its device and gives the same model.
    again = NaiveBayesEstimator(5, device="cpu").fit(torch.from_numpy(X), torch.from_numpy(y))
    _equal(again.log_likelihood.numpy(), model.log_likelihood.numpy())


@pytest.mark.parametrize("labels", [[0, 1, 5], [-1, 0, 1]])
def test_naive_bayes_refuses_labels_out_of_range(labels):
    X = np.ones((3, 4), dtype=np.float32)
    for est in (NaiveBayesEstimator(3, device="cpu"), JNaiveBayesEstimator(3)):
        with pytest.raises(ValueError, match="labels must lie in"):
            est.fit(X, np.array(labels))


def test_logistic_regression_dense_against_optax():
    X, y = _dense_text(num_features=120)
    reg = 1e-2
    est = LogisticRegressionEstimator(5, reg=reg, max_iters=100, device="cpu")
    model = est.fit(X, y)
    jmodel = JLogisticRegressionEstimator(5, reg=reg, max_iters=100).fit(X, y)
    Xt = torch.from_numpy(X)
    fn = softmax_objective(Xt, Xt.T, torch.from_numpy(y.astype(np.int64)), 5, reg)
    jW, jb = np.array(jmodel.W), np.array(jmodel.b)
    want, jgrad = fn(torch.cat([torch.from_numpy(jW).reshape(-1), torch.from_numpy(jb)]))
    got, grad = fn(torch.cat([model.W.reshape(-1), model.b]))
    assert abs(float(got) - float(want)) <= LR_OBJECTIVE_RTOL * abs(float(want))
    assert est.result.value == pytest.approx(float(got), rel=1e-6)
    assert len(est.result.values) == 100 and est.result.evaluations > 100
    scores = model(X).numpy()
    assert (scores.argmax(1) == np.asarray(jmodel.apply_batch(X)).argmax(1)).mean() >= LR_AGREEMENT
    assert float(grad.norm()) < LR_CONVERGED and float(jgrad.norm()) < LR_CONVERGED
    np.testing.assert_allclose(model.W.numpy(), jW, rtol=0, atol=LR_W_RTOL * np.abs(jW).max())
    carried = logistic_regression_from_numpy(jW, jb, device="cpu")
    np.testing.assert_allclose(carried(X).numpy(), np.asarray(jmodel.apply_batch(X)), **SCORE_TOL)


def test_lbfgs_on_a_quadratic():
    """A strictly convex quadratic reaches its minimiser, and every step
    taken decreases the value."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(30, 30, generator=g)
    H = A @ A.T / 30 + torch.eye(30)
    c = torch.randn(30, generator=g)

    def fg(x):
        return 0.5 * x @ H @ x - c @ x, H @ x - c

    res = lbfgs.minimize(fg, torch.zeros(30), max_iters=40)
    assert len(res.values) == 40
    # Decreasing, but for the approximate decrease condition's slack.
    assert all(b <= a + lbfgs.APPROX_DEC_RTOL * abs(a) for a, b in zip(res.values, res.values[1:]))
    np.testing.assert_allclose(res.x.numpy(), torch.linalg.solve(H, c).numpy(), rtol=1e-4, atol=1e-4)
    # The first trial step (1) meets the strong Wolfe conditions here.
    x0 = torch.zeros(30)
    v0, g0 = fg(x0)
    t, v, gt, evals = lbfgs.zoom_linesearch(fg, x0, -g0 / g0.norm(), float(v0), g0)
    assert t == 1.0 and evals == 1 and v < float(v0)


# --- pipelines ---------------------------------------------------------------


@pytest.mark.parametrize("classifier, n, num_features", [("naive_bayes", 600, 500), ("logistic", 400, 300)])
def test_newsgroups_run_synthetic(classifier, n, num_features):
    kw = dict(synthetic_n=n, num_features=num_features, classifier=classifier)
    got = newsgroups.run(newsgroups.NewsgroupsConfig(**kw), device="cpu")
    want = j_newsgroups.run(j_newsgroups.NewsgroupsConfig(**kw))
    assert got["classes"] == want["classes"]
    for key in ("test_accuracy", "macro_f1"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert got["test_accuracy"] > 0.9, got["summary"]
    assert set(got["stage_seconds"]) == {"front_end", "vectorize", "fit", "front_end_test", "predict"}
    if classifier == "logistic":
        assert got["lbfgs_steps"] == 100 and got["objective"] > 0


@pytest.mark.parametrize("classifier", ["naive_bayes", "logistic"])
def test_newsgroups_run_fixture(classifier):
    kw = dict(train_path=NEWSGROUPS_FIXTURE, test_path=NEWSGROUPS_FIXTURE, classifier=classifier)
    got = newsgroups.run(newsgroups.NewsgroupsConfig(**kw), device="cpu")
    want = j_newsgroups.run(j_newsgroups.NewsgroupsConfig(**kw))
    assert got["classes"] == want["classes"] == ["rec.sport.hockey", "sci.space"]
    for key in ("test_accuracy", "macro_f1"):
        assert abs(got[key] - want[key]) <= 1 / 3, (key, got[key], want[key])
    with pytest.raises(ValueError, match="--test is required"):
        newsgroups.run(newsgroups.NewsgroupsConfig(train_path=NEWSGROUPS_FIXTURE), device="cpu")
    with pytest.raises(ValueError, match="unknown classifier"):
        newsgroups.run(newsgroups.NewsgroupsConfig(synthetic_n=100, classifier="svm"), device="cpu")


def test_amazon_run_synthetic():
    kw = dict(synthetic_n=600, num_features=500)
    got = amazon_reviews.run(amazon_reviews.AmazonReviewsConfig(**kw), device="cpu")
    want = j_amazon.run(j_amazon.AmazonReviewsConfig(**kw))
    for key in ("accuracy", "f1", "auc"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert got["accuracy"] > 0.9 and got["auc"] > 0.95, got["summary"]
    assert got["lbfgs_steps"] == 100


def test_amazon_run_fixture_and_main(capsys):
    kw = dict(train_path=AMAZON_FIXTURE, test_path=AMAZON_FIXTURE)
    got = amazon_reviews.run(amazon_reviews.AmazonReviewsConfig(**kw), device="cpu")
    want = j_amazon.run(j_amazon.AmazonReviewsConfig(**kw))
    for key in ("accuracy", "f1", "auc"):
        assert abs(got[key] - want[key]) <= 1 / 4, (key, got[key], want[key])
    out = amazon_reviews.main(["--train", AMAZON_FIXTURE, "--test", AMAZON_FIXTURE, "--device", "cpu"])
    assert out["accuracy"] == got["accuracy"] and "total" in capsys.readouterr().out


def test_amazon_sparse_path(monkeypatch):
    """Over the threshold (lowered for the test), Amazon's features are a
    ``SparseBatch`` and the scores are the dense path's function."""
    conf = amazon_reviews.AmazonReviewsConfig(synthetic_n=300, num_features=400)
    dense = amazon_reviews.run(conf, device="cpu")
    monkeypatch.setattr(config, "text_sparse_threshold", 10)
    sparse = amazon_reviews.run(conf, device="cpu")
    assert isinstance(sparse["features"], SparseBatch) and isinstance(dense["features"], np.ndarray)
    assert abs(sparse["objective"] - dense["objective"]) <= 1e-5 * dense["objective"]
    assert abs(sparse["auc"] - dense["auc"]) <= METRIC_TOL


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for module, conf in ((newsgroups, newsgroups.NewsgroupsConfig(synthetic_n=100)),
                         (amazon_reviews, amazon_reviews.AmazonReviewsConfig(synthetic_n=100))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.run(conf)
