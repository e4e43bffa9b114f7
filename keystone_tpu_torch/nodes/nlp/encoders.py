"""Vocabulary encoders, host stages (counterpart of
``keystone_tpu/nodes/nlp/encoders.py``): a fitted term index → feature rows.

- ``SparseFeatureVectorizer`` encodes {term: weight} maps, ``CountVectorizer``
  token lists (counts), against a fixed index;
- ``CommonSparseFeatures.fit`` keeps the ``num_features`` terms found in the
  most documents, ``WordFrequencyEncoder.fit`` the ``num_words`` most
  frequent tokens. Both rank with ``Counter.most_common``, so ties keep
  first-seen order and the index is the reference's for the same documents
  in the same order.

The rows come as a dense float32 (n, K) numpy array below
``config.text_sparse_threshold`` columns and as a ``SparseBatch`` (CSR) at
or above it (``sparse="auto"``); ``sparse=True`` or ``False`` forces one.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Mapping, Sequence, Union

import numpy as np

from keystone_tpu_torch.config import config
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.workflow import Estimator, Transformer


def _want_sparse(sparse: Union[bool, str], dim: int) -> bool:
    if sparse == "auto":
        return dim >= config.text_sparse_threshold
    return bool(sparse)


class SparseFeatureVectorizer(Transformer):
    """Encodes (term → weight) maps against a fixed term index."""

    host_stage = True

    def __init__(self, index: Mapping[str, int], sparse: Union[bool, str] = "auto"):
        super().__init__()
        self.index = dict(index)
        self.dim = len(self.index)
        self.sparse = sparse

    def apply_batch(self, docs: Sequence[Mapping[str, float]]):
        if _want_sparse(self.sparse, self.dim):
            return SparseBatch.from_term_maps(docs, self.index, self.dim)
        out = np.zeros((len(docs), self.dim), dtype=np.float32)
        index = self.index
        for i, doc in enumerate(docs):
            for term, weight in doc.items():
                j = index.get(term)
                if j is not None:
                    out[i, j] = weight
        return out

    @property
    def vocabulary(self) -> List[str]:
        inv = [""] * self.dim
        for term, j in self.index.items():
            inv[j] = term
        return inv


class CountVectorizer(SparseFeatureVectorizer):
    """Encodes token lists as count vectors against a fixed index."""

    def apply_batch(self, docs: Sequence[Sequence[str]]):
        if _want_sparse(self.sparse, self.dim):
            return SparseBatch.from_counts(docs, self.index, self.dim)
        out = np.zeros((len(docs), self.dim), dtype=np.float32)
        index = self.index
        for i, tokens in enumerate(docs):
            for t in tokens:
                j = index.get(t)
                if j is not None:
                    out[i, j] += 1.0
        return out


class CommonSparseFeatures(Estimator):
    """Fit: keep the ``num_features`` terms appearing in the most documents."""

    def __init__(self, num_features: int, sparse: Union[bool, str] = "auto"):
        self.num_features = num_features
        self.sparse = sparse

    def fit(self, docs: Sequence[Mapping[str, float]]) -> SparseFeatureVectorizer:
        doc_freq: Counter = Counter()
        for doc in docs:
            doc_freq.update(doc.keys())
        top = [t for t, _c in doc_freq.most_common(self.num_features)]
        return SparseFeatureVectorizer({t: i for i, t in enumerate(top)}, sparse=self.sparse)


class WordFrequencyEncoder(Estimator):
    """Fit over token lists: the most frequent words → index; encodes
    documents as count vectors."""

    def __init__(self, num_words: int, sparse: Union[bool, str] = "auto"):
        self.num_words = num_words
        self.sparse = sparse

    def fit(self, token_docs: Sequence[Sequence[str]]) -> CountVectorizer:
        freq: Counter = Counter()
        for tokens in token_docs:
            freq.update(tokens)
        top = [w for w, _c in freq.most_common(self.num_words)]
        return CountVectorizer({w: i for i, w in enumerate(top)}, sparse=self.sparse)
