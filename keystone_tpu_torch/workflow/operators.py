"""Graph operators — the node payloads of the pipeline DAG.

Counterpart of ``keystone_tpu/workflow/operators.py``: ``DatasetOperator``,
``DatumOperator``, ``TransformerOperator``, ``EstimatorOperator``,
``DelegatingOperator`` and ``GatherOperator``. A value is a batch (a
tensor, a numpy array or a host sequence), a datum, or a fitted
transformer.

Where the port departs:

- ``DatasetOperator`` places nothing (one device, no mesh). Its identity
  in the in-process hash is its data object (and a tensor's ``_version``),
  pinned by every cache entry keyed through it, not the data's content:
  a request's batch is never hashed on the host. Its content fingerprint
  (``content_signature``, memoized) feeds only ``prefix_digest``, the
  cross-process key the disk cache and the optimizer's shape memo read.
- ``TransformerOperator`` and ``DelegatingOperator`` run a transformer
  through ``Transformer.batch_call``, in row batches on the env's device.
- ``EstimatorOperator`` gives a fit on a tensor its numeric label arrays
  as tensors on the data's device.
- ``GatherOperator`` is ``torch.cat`` on the last axis.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


class Operator:
    """Base operator. ``execute`` consumes evaluated dependency values."""

    def execute(self, deps: Sequence[Any]) -> Any:
        raise NotImplementedError

    def signature(self) -> Any:
        """Identity key used for structural prefix hashing. The id fallback
        carries the UNSTABLE poison so heap addresses can never leak into a
        cross-process digest (a recycled id must not produce a disk hit)."""
        from keystone_tpu_torch.workflow.fingerprint import UNSTABLE

        return ("op", id(self), UNSTABLE)

    def prefix_hash(self, dep_hashes) -> int:
        """Structural hash of this node given its dependency prefix hashes."""
        return hash((self.signature(), tuple(dep_hashes)))

    def prefix_digest(self, dep_digests):
        """Content-stable digest of this node's prefix (the cross-process
        analog of ``prefix_hash``), or None when any part is id-based."""
        from keystone_tpu_torch.workflow.fingerprint import digest_tree

        if any(d is None for d in dep_digests):
            return None
        return digest_tree((self.signature(), tuple(dep_digests)))

    def pinned_objects(self):
        """Objects whose id() feeds this operator's signature. Cache entries
        keyed on prefixes through this node hold strong references to these so
        CPython id reuse can never alias a stale cache entry."""
        return ()

    def label(self) -> str:
        return type(self).__name__


class DatasetOperator(Operator):
    """A constant batch of data spliced into the graph (the RDD analog)."""

    def __init__(self, data: Any):
        self.data = data

    def execute(self, deps):
        return self.data

    def signature(self):
        from keystone_tpu_torch.workflow.fingerprint import UNSTABLE, tensor_version

        data = self.data
        version = tensor_version(data) if isinstance(data, torch.Tensor) else None
        return ("dataset", id(data), version, UNSTABLE)

    def content_signature(self):
        """Content fingerprint of numeric arrays and tensors (sampled past
        ``config.fingerprint_max_bytes``) and of text corpora, else None;
        computed once per operator."""
        if hasattr(self, "_content_sig"):
            return self._content_sig
        from keystone_tpu_torch.workflow.fingerprint import array_fingerprint, text_fingerprint

        data = self.data
        sig = None
        if isinstance(data, torch.Tensor) and data.layout == torch.strided:
            sig = ("dataset", array_fingerprint(data))
        elif isinstance(data, np.ndarray) and data.dtype.kind in "biufc":
            sig = ("dataset", array_fingerprint(data))
        elif isinstance(data, (list, tuple)) and data:
            fp = text_fingerprint(data)
            sig = None if fp is None else ("dataset", fp)
        self._content_sig = sig
        return sig

    def prefix_digest(self, dep_digests):
        from keystone_tpu_torch.workflow.fingerprint import digest_tree

        sig = self.content_signature()
        return None if sig is None else digest_tree((sig, ()))

    def pinned_objects(self):
        return (self.data,)

    def label(self):
        return "Dataset"


class DatumOperator(Operator):
    """A single constant datum."""

    def __init__(self, datum: Any):
        self.datum = datum

    def execute(self, deps):
        return self.datum

    def signature(self):
        from keystone_tpu_torch.workflow.fingerprint import UNSTABLE

        return ("datum", id(self.datum), UNSTABLE)

    def pinned_objects(self):
        return (self.datum,)

    def label(self):
        return "Datum"


def describe_transformer(t) -> str:
    """A transformer's name in labels: a fused chain names its stages and
    a gathered one its branches."""
    stages = getattr(t, "stages", None)
    if stages is not None and len(stages):
        return "Fused(" + "|".join(describe_transformer(s) for s in stages) + ")"
    branches = getattr(t, "branches", None)
    if branches is not None:
        return "Gather[" + ", ".join(describe_transformer(b) for b in branches) + "]"
    return type(t).__name__


class TransformerOperator(Operator):
    """Applies a Transformer to its single input batch."""

    def __init__(self, transformer):
        self.transformer = transformer

    def execute(self, deps):
        return self.transformer.batch_call(deps[0])

    def signature(self):
        return ("transformer", self.transformer.signature())

    def prefix_hash(self, dep_hashes):
        # Delegated so that a fused chain hashes identically to the unfused
        # chain it replaced (FusedTransformer folds stage-by-stage).
        return self.transformer.chain_hash(dep_hashes[0])

    def prefix_digest(self, dep_digests):
        if dep_digests[0] is None:
            return None
        return self.transformer.chain_digest(dep_digests[0])

    def pinned_objects(self):
        return (self.transformer,)

    def label(self):
        return describe_transformer(self.transformer)


def _as_label_input(value, device: torch.device):
    """A numeric label array or host tensor moved to the data's device."""
    if isinstance(value, torch.Tensor) or (isinstance(value, np.ndarray) and value.dtype.kind in "biufc"):
        return torch.as_tensor(value).to(device)
    return value


class EstimatorOperator(Operator):
    """Fits an Estimator/LabelEstimator on its input(s); the value produced is
    the fitted Transformer (a TransformerExpression in reference terms)."""

    def __init__(self, estimator):
        self.estimator = estimator

    def execute(self, deps):
        data, *rest = deps
        if isinstance(data, torch.Tensor):
            rest = [_as_label_input(r, data.device) for r in rest]
        return self.estimator.fit(data, *rest)

    def signature(self):
        """Content-stable when the estimator's signature is (class +
        hyperparams, see pipeline.Estimator.signature); id-keyed otherwise.
        Memoized at first use so an estimator that mutates its own fields
        while fitting keeps one identity for this node."""
        sig = getattr(self, "_sig_cache", None)
        if sig is None:
            sig_fn = getattr(self.estimator, "signature", None)
            if sig_fn is not None:
                sig = ("estimator", sig_fn())
            else:
                from keystone_tpu_torch.workflow.fingerprint import UNSTABLE

                sig = ("estimator", id(self.estimator), UNSTABLE)
            self._sig_cache = sig
        return sig

    def pinned_objects(self):
        return (self.estimator,)

    def label(self):
        return type(self.estimator).__name__ + ".fit"


class DelegatingOperator(Operator):
    """Applies the fitted transformer produced by an estimator node.

    deps = [fitted_transformer, input_batch].
    """

    def execute(self, deps):
        fitted, x = deps
        return fitted.batch_call(x)

    def signature(self):
        # The behaviour is fully determined by the estimator dep's hash, so a
        # shared constant signature keeps structurally-equal graphs equal.
        return ("delegating",)

    def label(self):
        return "Delegating"


class GatherOperator(Operator):
    """Concatenates branch outputs along the feature (last) axis."""

    def execute(self, deps: Sequence[Any]):
        return torch.cat([torch.as_tensor(d) for d in deps], dim=-1)

    def signature(self):
        return ("gather",)

    def label(self):
        return "Gather"
