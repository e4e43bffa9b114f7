"""Host-side CSR batch: sparse features without (n × vocab) dense arrays.

Counterpart of ``keystone_tpu/utils/sparse.py`` (``SparseBatch``,
``:23-206``): the text path from ``CommonSparseFeatures`` on keeps its
features as CSR in host memory. A consumer either densifies one column
block at a time (``densify``, the streamed solver's blocks; ``matmul``) or
takes the whole batch to the device as a ``torch.sparse_csr_tensor``
(``to_torch``, in place of the reference's ``to_bcoo``), whose products
with dense matrices are cuSPARSE's on the card. An (n, vocab) dense array
is never built.

Indices are unique within each row (the vectorizers build rows from
dicts); ``densify`` and ``to_torch`` rely on that.
"""

from __future__ import annotations

import warnings
from collections import Counter
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.config import resolve_device


class SparseBatch:
    """CSR: ``values[indptr[i]:indptr[i+1]]`` at ``indices[...]`` is row i."""

    __slots__ = ("indptr", "indices", "values", "dim", "_rows", "_csc")

    def __init__(self, indptr, indices, values, dim: int):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float32)
        self.dim = int(dim)
        self._rows: Optional[np.ndarray] = None
        self._csc: Optional[tuple] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_term_maps(
        cls, docs: Sequence[Mapping[str, float]], index: Mapping[str, int], dim: int
    ) -> "SparseBatch":
        indptr = [0]
        indices: list = []
        values: list = []
        for doc in docs:
            for term, weight in doc.items():
                j = index.get(term)
                if j is not None:
                    indices.append(j)
                    values.append(weight)
            indptr.append(len(indices))
        return cls(indptr, indices, values, dim)

    @classmethod
    def from_counts(
        cls, docs: Sequence[Sequence[str]], index: Mapping[str, int], dim: int
    ) -> "SparseBatch":
        indptr = [0]
        indices: list = []
        values: list = []
        for tokens in docs:
            for term, c in Counter(tokens).items():
                j = index.get(term)
                if j is not None:
                    indices.append(j)
                    values.append(float(c))
            indptr.append(len(indices))
        return cls(indptr, indices, values, dim)

    @classmethod
    def from_dense(cls, X) -> "SparseBatch":
        X = np.asarray(X)
        indptr = [0]
        indices: list = []
        values: list = []
        for row in X:
            nz = np.nonzero(row)[0]
            indices.extend(nz.tolist())
            values.extend(row[nz].tolist())
            indptr.append(len(indices))
        return cls(indptr, indices, values, X.shape[1])

    # -- properties --------------------------------------------------------

    @property
    def shape(self):
        return (len(self.indptr) - 1, self.dim)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes + self.values.nbytes

    def __len__(self) -> int:
        return self.shape[0]

    def _row_ids(self) -> np.ndarray:
        if self._rows is None:
            self._rows = np.repeat(np.arange(len(self), dtype=np.int64), np.diff(self.indptr))
        return self._rows

    def _col_sorted(self) -> tuple:
        """(rows, cols, vals) sorted by column: one O(nnz log nnz) sort,
        after which a column block's entries are one searchsorted range."""
        if self._csc is None:
            order = np.argsort(self.indices, kind="stable")
            self._csc = (self._row_ids()[order], self.indices[order], self.values[order])
        return self._csc

    def block_entries(self, start: int, stop: int) -> tuple:
        """(rows, cols - start, vals) of the entries in columns [start, stop)."""
        rows, cols, vals = self._col_sorted()
        lo, hi = np.searchsorted(cols, (start, stop))
        return rows[lo:hi], cols[lo:hi] - start, vals[lo:hi]

    # -- dense views -------------------------------------------------------

    def densify(self, start: int = 0, stop: Optional[int] = None, dtype=np.float32) -> np.ndarray:
        """Dense (n, stop-start) slice of columns [start, stop)."""
        stop = self.dim if stop is None else stop
        out = np.zeros((len(self), stop - start), dtype=dtype)
        rows, cols, vals = self.block_entries(start, stop)
        out[rows, cols] = vals
        return out

    def toarray(self, dtype=np.float32) -> np.ndarray:
        return self.densify(0, self.dim, dtype)

    def matmul(self, M, block: int = 8192) -> np.ndarray:
        """self @ M for a dense (dim, k) M, densifying one column block at a
        time: the extra memory is (n, block), never (n, dim)."""
        M = np.asarray(M)
        out = np.zeros((len(self), M.shape[1]), dtype=np.float32)
        for s in range(0, self.dim, block):
            e = min(s + block, self.dim)
            out += self.densify(s, e) @ M[s:e]
        return out

    # -- reductions --------------------------------------------------------

    def column_sums(self) -> np.ndarray:
        return np.bincount(self.indices, weights=self.values, minlength=self.dim).astype(np.float32)

    def grouped_column_sums(self, groups, num_groups: int) -> np.ndarray:
        """(num_groups, dim) per-group column sums: one bincount over
        group-offset keys (naive Bayes' per-class counts)."""
        groups = np.asarray(groups, dtype=np.int64).ravel()
        keys = groups[self._row_ids()] * self.dim + self.indices
        flat = np.bincount(keys, weights=self.values, minlength=num_groups * self.dim)
        return flat.reshape(num_groups, self.dim).astype(np.float32)

    def row_sum(self, i: int) -> float:
        s, e = int(self.indptr[i]), int(self.indptr[i + 1])
        return float(self.values[s:e].sum())

    # -- the device view ---------------------------------------------------

    def to_torch(self, device=None, dtype=torch.float32, transpose: bool = False) -> torch.Tensor:
        """This batch (or its transpose) as a ``torch.sparse_csr_tensor`` on
        ``device`` (``cuda`` unless named). The entries go to the device as
        coordinates and are sorted there (``coalesce``, which would sum
        duplicates; the class invariant says there are none), so each
        row's columns come out in order, as cuSPARSE wants them."""
        device = resolve_device(device)
        coords = [self._row_ids(), self.indices.astype(np.int64)]
        shape = self.shape
        if transpose:
            coords, shape = coords[::-1], shape[::-1]
        index = torch.from_numpy(np.stack(coords)).to(device)
        values = torch.from_numpy(self.values).to(device, dtype)
        with warnings.catch_warnings():
            # Both are notices of PyTorch's sparse support, not of this data.
            warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
            coo = torch.sparse_coo_tensor(index, values, shape, check_invariants=False)
            return coo.coalesce().to_sparse_csr()

    # -- structure edits ---------------------------------------------------

    def append_ones(self) -> "SparseBatch":
        """A copy with one extra all-ones column at index ``dim``: the
        intercept column of a solver that learns b as a weight."""
        n = len(self)
        indptr = self.indptr + np.arange(n + 1, dtype=np.int64)
        at = np.asarray(self.indptr[1:])
        indices = np.insert(self.indices, at, np.int32(self.dim))
        values = np.insert(self.values, at, np.float32(1.0))
        return SparseBatch(indptr, indices, values, self.dim + 1)

    def __repr__(self) -> str:
        n, d = self.shape
        return f"SparseBatch({n}x{d}, nnz={self.nnz})"
