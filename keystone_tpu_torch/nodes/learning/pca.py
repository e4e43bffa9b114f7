"""PCA (counterpart of keystone_tpu/nodes/learning/pca.py): the projection
``PCATransformer`` and the local SVD fit ``PCAEstimator``. The reference's
``DistributedPCAEstimator`` (TSQR over a mesh) is not ported."""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import as_input, default_dtype, resolve_device
from keystone_tpu_torch.workflow import Estimator, Transformer


class PCATransformer(Transformer):
    def __init__(self, components, mean=None, device=None):
        super().__init__()
        device = resolve_device(device)
        # components: (d, dims) — columns are principal directions.
        self.register_buffer(
            "components", torch.as_tensor(components, dtype=default_dtype, device=device)
        )
        self.register_buffer(
            "mean",
            None if mean is None
            else torch.as_tensor(mean, dtype=default_dtype, device=device),
        )

    def signature(self):
        # Content-stable from the fitted parameters, so prefixes through a
        # fitted PCA stay persistable; fingerprinted once (memoized on the
        # buffers, re-read only if one is written in place).
        from keystone_tpu_torch.workflow.fingerprint import array_fingerprint

        return self.stable_signature(
            array_fingerprint(self.components),
            None if self.mean is None else array_fingerprint(self.mean),
        )

    def apply_batch(self, X):
        if self.mean is not None:
            X = X - self.mean
        return X @ self.components


class PCAEstimator(Estimator):
    """The top ``dims`` right singular vectors of the centered data, from
    one ``torch.linalg.svd``. Their signs are the solver's choice, as in the
    reference. ``fit`` runs on the device of a tensor it is given; a host
    array goes to ``device`` (``cuda`` unless named)."""

    def __init__(self, dims: int, device=None):
        self.dims = dims
        self.device = device

    def fit(self, data) -> PCATransformer:
        X = as_input(data, self.device)
        mean = X.mean(dim=0)
        _u, _s, vt = torch.linalg.svd(X - mean, full_matrices=False)
        return PCATransformer(vt[: self.dims].T.contiguous(), mean, device=X.device)
