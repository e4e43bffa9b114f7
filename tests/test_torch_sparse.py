"""The CSR ``SparseBatch`` and the sparse branches of the classifiers and the
block solver in the port, held against the JAX package on the CPU.

- ``SparseBatch``, case for case with ``tests/test_sparse_text.py::
  TestSparseBatch``: the same numpy operations on the same arrays, so its
  structure, dense views, block products and reductions are equal bit for
  bit. ``to_torch`` (the port's device view in place of ``to_bcoo``) times a
  dense matrix within rtol 1e-5, atol 1e-6 of float64 (float32 sums of at
  most 8 products a row).
- Vectorizers: the same term index, equal dense and sparse rows, and the
  ``auto`` switch at ``config.text_sparse_threshold``.
- Naive Bayes on a ``SparseBatch``: the same host counts; scores through a
  CSR tensor within rtol 1e-5, atol 1e-5 of the reference's host block
  products.
- Logistic regression on a ``SparseBatch`` (30 L-BFGS steps, as the
  reference's own sparse test): the final objective within a relative
  1e-4 of optax's fit and the same predictions on at least 99% of rows.
- ``BlockLeastSquaresEstimator`` on a ``SparseBatch``, with the intercept as
  a ones column and without one: the same updates in the same order as the
  reference's streamed solve, predictions within rtol 1e-3, atol 1e-3.
- At or above the threshold the features stay CSR from
  ``CommonSparseFeatures`` through naive Bayes, logistic regression and the
  block solver: no dense (n, vocab) view is taken, and the solver densifies
  one column block at a time.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.config import config as j_config
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBlockLeastSquaresEstimator
from keystone_tpu.nodes.learning import LogisticRegressionEstimator as JLogisticRegressionEstimator
from keystone_tpu.nodes.learning import NaiveBayesEstimator as JNaiveBayesEstimator
from keystone_tpu.nodes.nlp import CommonSparseFeatures as JCommonSparseFeatures
from keystone_tpu.nodes.nlp import WordFrequencyEncoder as JWordFrequencyEncoder
from keystone_tpu.utils.sparse import SparseBatch as JSparseBatch
from keystone_tpu_torch.config import config
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.logistic_regression import (
    LogisticRegressionEstimator,
    softmax_objective,
)
from keystone_tpu_torch.nodes.learning.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.nodes.nlp import CommonSparseFeatures, WordFrequencyEncoder
from keystone_tpu_torch.utils.sparse import SparseBatch

CSR_TOL = dict(rtol=1e-5, atol=1e-6)
NB_TOL = dict(rtol=1e-5, atol=1e-5)
LR_OBJECTIVE_RTOL = 1e-4
LR_AGREEMENT = 0.99
BLS_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _random_sparse(rng, n=64, d=512, nnz_per_row=8, centered=False):
    """tests/test_sparse_text.py's generator."""
    X = np.zeros((n, d), dtype=np.float32)
    for i in range(n):
        cols = rng.choice(d, size=nnz_per_row, replace=False)
        if centered:
            X[i, cols] = rng.normal(size=nnz_per_row)
        else:
            X[i, cols] = rng.uniform(0.5, 2.0, size=nnz_per_row)
    return X


def _pair(X):
    return SparseBatch.from_dense(X), JSparseBatch.from_dense(X)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_structure(got, want):
    for name in ("indptr", "indices", "values"):
        _equal(getattr(got, name), getattr(want, name))
    assert got.shape == want.shape and got.nnz == want.nnz and got.nbytes == want.nbytes


# --- SparseBatch -----------------------------------------------------------


def test_from_dense_and_densify(rng):
    X = _random_sparse(rng)
    sb, jsb = _pair(X)
    _same_structure(sb, jsb)
    _equal(sb.toarray(), jsb.toarray())
    _equal(sb.densify(100, 300), jsb.densify(100, 300))
    _equal(sb.densify(100, 300, dtype=np.float64), jsb.densify(100, 300, dtype=np.float64))
    _equal(sb.toarray(), X)
    assert len(sb) == 64 and repr(sb) == repr(jsb)


def test_matmul_blocks(rng):
    X = _random_sparse(rng)
    M = rng.normal(size=(512, 7)).astype(np.float32)
    sb, jsb = _pair(X)
    _equal(sb.matmul(M, block=100), jsb.matmul(M, block=100))
    _equal(sb.matmul(M), jsb.matmul(M))


def test_reductions(rng):
    X = _random_sparse(rng)
    sb, jsb = _pair(X)
    _equal(sb.column_sums(), jsb.column_sums())
    y = rng.integers(0, 3, size=len(X))
    _equal(sb.grouped_column_sums(y, 3), jsb.grouped_column_sums(y, 3))
    for i in (0, 17, 63):
        assert sb.row_sum(i) == jsb.row_sum(i)


def test_append_ones(rng):
    sb, jsb = _pair(_random_sparse(rng, n=16, d=32))
    _same_structure(sb.append_ones(), jsb.append_ones())
    dense = sb.append_ones().toarray()
    np.testing.assert_array_equal(dense[:, 32], np.ones(16, dtype=np.float32))


def test_from_term_maps_and_counts():
    docs = [{"b": 2.0, "a": 1.0, "zz": 9.0}, {}, {"c": 4.0, "b": 3.0}]
    index = {"a": 0, "b": 1, "c": 2}
    _same_structure(SparseBatch.from_term_maps(docs, index, 3), JSparseBatch.from_term_maps(docs, index, 3))
    tokens = [["b", "a", "b", "q"], [], ["c"]]
    _same_structure(SparseBatch.from_counts(tokens, index, 3), JSparseBatch.from_counts(tokens, index, 3))


@pytest.mark.parametrize("transpose", [False, True])
def test_to_torch_is_csr_and_multiplies(rng, transpose):
    X = _random_sparse(rng, n=48, d=200)
    X[5] = 0.0  # an empty row
    sb = SparseBatch.from_dense(X)
    csr = sb.to_torch("cpu", transpose=transpose)
    assert csr.layout == torch.sparse_csr and csr.dtype == torch.float32
    A = X.T if transpose else X
    assert tuple(csr.shape) == A.shape
    M = rng.normal(size=(A.shape[1], 5)).astype(np.float32)
    np.testing.assert_allclose((csr @ torch.from_numpy(M)).numpy(), A.astype(np.float64) @ M, **CSR_TOL)
    # Each row's columns in order, as cuSPARSE wants them.
    crow, col = csr.crow_indices().numpy(), csr.col_indices().numpy()
    for i in range(len(crow) - 1):
        assert np.all(np.diff(col[crow[i]:crow[i + 1]]) > 0)


# --- vectorizers -----------------------------------------------------------


def test_sparse_output_parity():
    docs = [{"a": 1.0, "b": 2.0}, {"b": 3.0, "c": 4.0}, {"a": 5.0}]
    for sparse in (False, True):
        got, want = CommonSparseFeatures(3, sparse=sparse).fit(docs), JCommonSparseFeatures(3, sparse=sparse).fit(docs)
        assert got.index == want.index and got.vocabulary == want.vocabulary
    sb = CommonSparseFeatures(3, sparse=True).fit(docs)(docs)
    assert isinstance(sb, SparseBatch)
    _same_structure(sb, JCommonSparseFeatures(3, sparse=True).fit(docs).apply_batch(docs))
    _equal(sb.toarray(), CommonSparseFeatures(3, sparse=False).fit(docs)(docs))


def test_count_vectorizer_parity():
    docs = [["a", "b", "a"], ["c"], ["b", "b", "b"]]
    for sparse in (False, True):
        got, want = WordFrequencyEncoder(3, sparse=sparse).fit(docs), JWordFrequencyEncoder(3, sparse=sparse).fit(docs)
        assert got.index == want.index
    dense = WordFrequencyEncoder(3, sparse=False).fit(docs)(docs)
    _equal(dense, np.asarray(JWordFrequencyEncoder(3, sparse=False).fit(docs).apply_batch(docs)))
    sb = WordFrequencyEncoder(3, sparse=True).fit(docs)(docs)
    _same_structure(sb, JWordFrequencyEncoder(3, sparse=True).fit(docs).apply_batch(docs))
    _equal(sb.toarray(), dense)


@pytest.mark.parametrize("threshold, sparse", [(2, True), (3, False), (100, False)])
def test_auto_switches_on_threshold(monkeypatch, threshold, sparse):
    docs = [{"a": 1.0}, {"b": 2.0}]
    monkeypatch.setattr(config, "text_sparse_threshold", threshold)
    monkeypatch.setattr(j_config, "text_sparse_threshold", threshold)
    got = CommonSparseFeatures(2).fit(docs)(docs)
    want = JCommonSparseFeatures(2).fit(docs).apply_batch(docs)
    assert isinstance(got, SparseBatch) == sparse == isinstance(want, JSparseBatch)
    assert config.text_sparse_threshold == threshold


def test_threshold_default_is_the_reference_s():
    assert config.text_sparse_threshold == j_config.text_sparse_threshold == 16384


# --- classifiers and the block solver --------------------------------------


def test_naive_bayes_sparse(rng):
    X = _random_sparse(rng, n=128, d=256)
    y = rng.integers(0, 4, size=128)
    sb, jsb = _pair(X)
    model = NaiveBayesEstimator(4, device="cpu").fit(sb, y)
    jmodel = JNaiveBayesEstimator(4).fit(jsb, y)
    np.testing.assert_allclose(model.log_prior.numpy(), np.asarray(jmodel.log_prior), **NB_TOL)
    np.testing.assert_allclose(model.log_likelihood.numpy(), np.asarray(jmodel.log_likelihood), **NB_TOL)
    np.testing.assert_allclose(model(sb).numpy(), np.asarray(jmodel.apply_batch(jsb)), **NB_TOL)
    # The sparse fit is the dense fit's function.
    dense = NaiveBayesEstimator(4, device="cpu").fit(X, y)
    np.testing.assert_allclose(model(sb).numpy(), dense(torch.from_numpy(X)).numpy(), **NB_TOL)


def test_logistic_sparse(rng):
    X = _random_sparse(rng, n=96, d=64, centered=True)
    y = rng.integers(0, 3, size=96)
    sb, jsb = _pair(X)
    est = LogisticRegressionEstimator(3, max_iters=30, device="cpu")
    model = est.fit(sb, y)
    jmodel = JLogisticRegressionEstimator(3, max_iters=30).fit(jsb, y)
    Xt = torch.from_numpy(X)
    fn = softmax_objective(Xt, Xt.T, torch.from_numpy(y), 3, 1e-4)
    jx = torch.cat([torch.from_numpy(np.array(jmodel.W)).reshape(-1), torch.from_numpy(np.array(jmodel.b))])
    want = float(fn(jx)[0])
    assert abs(est.result.value - want) <= LR_OBJECTIVE_RTOL * abs(want)
    scores = model(sb).numpy()
    np.testing.assert_allclose(scores, model(Xt).numpy(), rtol=1e-5, atol=1e-5)
    agree = (scores.argmax(1) == np.asarray(jmodel.apply_batch(jsb)).argmax(1)).mean()
    assert agree >= LR_AGREEMENT


@pytest.mark.parametrize("fit_intercept, block_size, centered, lam", [
    (True, 32, True, 0.0),  # the ones column its own block
    (True, 40, True, 0.5),  # the ones column in a ragged last block
    (False, 64, False, 1e-6),
])
def test_block_least_squares_sparse(rng, fit_intercept, block_size, centered, lam):
    X = _random_sparse(rng, n=256, d=96, centered=centered)
    W = rng.normal(size=(96, 3)).astype(np.float32)
    Y = (X @ W + (0.5 if fit_intercept else 0.0)).astype(np.float32)
    kw = dict(block_size=block_size, num_iters=4, lam=lam, fit_intercept=fit_intercept)
    sb, jsb = _pair(X)
    model = BlockLeastSquaresEstimator(**kw, device="cpu").fit(sb, Y)
    jmodel = JBlockLeastSquaresEstimator(**kw).fit(jsb, Y)
    assert model.blocks == [tuple(b) for b in jmodel.blocks]
    assert (model.b is None) == (jmodel.b is None)
    np.testing.assert_allclose(model(sb).numpy(), np.asarray(jmodel.apply_batch(jsb)), **BLS_TOL)
    np.testing.assert_allclose(model(sb).numpy(), model(torch.from_numpy(X)).numpy(), rtol=1e-5, atol=1e-5)


def test_features_stay_sparse_above_the_threshold(monkeypatch, rng):
    """Texts through ``CommonSparseFeatures`` at or above the threshold:
    naive Bayes, logistic regression and the block solver fit and score
    without any dense (n, vocab) view; the solver's densified blocks are at
    most ``block_size`` wide."""
    monkeypatch.setattr(config, "text_sparse_threshold", 300)
    docs = [{f"w{int(j)}": 1.0 for j in rng.integers(0, 2000, size=30)} for _ in range(120)]
    y = rng.integers(0, 3, size=120)
    sb = CommonSparseFeatures(1000).fit(docs)(docs)
    assert isinstance(sb, SparseBatch) and sb.dim >= 300

    def refuse(*_a, **_k):
        raise AssertionError("a dense (n, vocab) view of the features")

    widths = []
    block_entries = SparseBatch.block_entries

    def record(self, start, stop):
        widths.append(stop - start)
        return block_entries(self, start, stop)

    for name in ("densify", "toarray", "matmul"):
        monkeypatch.setattr(SparseBatch, name, refuse)
    monkeypatch.setattr(SparseBatch, "block_entries", record)
    NaiveBayesEstimator(3, device="cpu").fit(sb, y)(sb)
    LogisticRegressionEstimator(3, max_iters=5, device="cpu").fit(sb, y)(sb)
    assert widths == []
    targets = 2.0 * np.eye(3, dtype=np.float32)[y] - 1.0
    BlockLeastSquaresEstimator(block_size=128, num_iters=2, lam=0.1, device="cpu").fit(sb, targets)(sb)
    assert widths and max(widths) <= 128
