"""Carries fitted pipelines' parameters into (and the ImageNet pipeline's
out of) the port.

``params_from_numpy`` takes a dict of arrays (numpy or tensors) under these
keys and builds the port's fitted modules on ``device``; ``params_to_numpy``
is its inverse, from a pipeline the port fitted:

- ``sift.pca.components`` (128, p), ``sift.pca.mean`` (128,);
- ``sift.gmm.weights`` (k,), ``sift.gmm.means`` (k, p), ``sift.gmm.variances`` (k, p);
- the same keys under ``lcs.*``, with input width 96;
- ``head.W`` (2·2·k·p, C), ``head.blocks`` ((start, end) pairs), ``head.b`` (C,).

With the JAX package, the arrays are its fitted ``PCATransformer``
(``components``, ``mean``), ``FisherVector`` (``weights``, ``means``,
``variances``) and ``BlockLinearMapper`` (``W``, ``blocks``, ``b``).

The other image pipelines' parameters, each function taking numpy arrays
(or tensors) as the JAX package's fitted nodes hold them:

- ``random_sign_nodes``: MnistRandomFFT's ``RandomSignNode.signs``, one
  (dim,) ±1 vector a branch;
- ``convolver_from_numpy``: RandomPatchCifar's ``Convolver`` with the ZCA
  folded in, its ``filters`` (nf, fh, fw, c) and ``bias`` (nf,);
- ``zca_from_numpy``: a ``ZCAWhitener``'s ``whitener`` (d, d) and ``mean``;
- ``linear_mapper_from_numpy``: a ``LinearMapper``'s ``W`` (d, k) and ``b``;
- ``voc_params_from_numpy``: VOCSIFTFisher's one branch and head, under
  the ImageNet keys ``sift.pca.*``, ``sift.gmm.*`` and ``head.*``.

The speech and text pipelines' fitted nodes, from the arrays of the JAX
package's nodes of the same names:

- ``standard_scaler_from_numpy``: a ``StandardScalerModel``'s ``mean`` and
  ``std`` (None when fitted without it);
- ``random_features_from_numpy``: a ``CosineRandomFeatures``' ``W`` (d, D),
  γ already applied, and ``b`` (D,);
- ``naive_bayes_from_numpy``: a ``NaiveBayesModel``'s ``log_prior`` (k,)
  and ``log_likelihood`` (k, d);
- ``logistic_regression_from_numpy``: a ``LogisticRegressionModel``'s ``W``
  (d, k) and ``b`` (k,);
- ``vectorizer_from_index``: a ``SparseFeatureVectorizer``'s term ``index``
  ({term: column}).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.nodes.images.convolver import Convolver
from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLinearMapper
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapper
from keystone_tpu_torch.nodes.learning.logistic_regression import LogisticRegressionModel
from keystone_tpu_torch.nodes.learning.naive_bayes import NaiveBayesModel
from keystone_tpu_torch.nodes.learning.pca import PCATransformer
from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener
from keystone_tpu_torch.nodes.nlp.encoders import SparseFeatureVectorizer
from keystone_tpu_torch.nodes.stats.random_features import CosineRandomFeatures
from keystone_tpu_torch.nodes.stats.random_signs import RandomSignNode
from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel

BRANCHES = ("sift", "lcs")


@dataclass
class ServingParams:
    """The fitted modules of the served chain, one PCA and one GMM per
    descriptor branch and the linear head."""

    sift_pca: PCATransformer
    sift_fv: FisherVector
    lcs_pca: PCATransformer
    lcs_fv: FisherVector
    head: BlockLinearMapper


def _branch(d: dict, br: str, device):
    pca = PCATransformer(d[f"{br}.pca.components"], d.get(f"{br}.pca.mean"), device=device)
    fv = FisherVector(d[f"{br}.gmm.weights"], d[f"{br}.gmm.means"], d[f"{br}.gmm.variances"],
                      device=device)
    return pca, fv


def _head(d: dict, device) -> BlockLinearMapper:
    blocks = [tuple(int(v) for v in se) for se in np.array(d["head.blocks"])]
    return BlockLinearMapper(d["head.W"], blocks, d.get("head.b"), device=device)


def params_from_numpy(d: dict, device=None) -> ServingParams:
    device = resolve_device(device)
    mods = {}
    for br in BRANCHES:
        mods[f"{br}_pca"], mods[f"{br}_fv"] = _branch(d, br, device)
    return ServingParams(**mods, head=_head(d, device))


def voc_params_from_numpy(d: dict, device=None):
    """(PCATransformer, FisherVector, BlockLinearMapper) of a fitted
    VOCSIFTFisher from the ``sift.*`` and ``head.*`` keys."""
    device = resolve_device(device)
    return (*_branch(d, "sift", device), _head(d, device))


def random_sign_nodes(signs: Sequence, device=None) -> list:
    """One ``RandomSignNode`` per (dim,) sign vector."""
    return [RandomSignNode(np.array(s), device=device) for s in signs]


def convolver_from_numpy(filters, bias=None, stride: int = 1,
                         compute_dtype: Optional[str] = None, device=None) -> Convolver:
    """A ``Convolver`` of filters with the whitener already folded in."""
    return Convolver(np.array(filters), stride=stride, compute_dtype=compute_dtype,
                     device=device, bias=None if bias is None else np.array(bias))


def zca_from_numpy(whitener, mean, device=None) -> ZCAWhitener:
    return ZCAWhitener(np.array(whitener), np.array(mean), device=device)


def linear_mapper_from_numpy(W, b=None, device=None) -> LinearMapper:
    return LinearMapper(np.array(W), None if b is None else np.array(b), device=device)


def standard_scaler_from_numpy(mean, std=None, device=None) -> StandardScalerModel:
    return StandardScalerModel(np.array(mean), None if std is None else np.array(std), device=device)


def random_features_from_numpy(W, b, device=None) -> CosineRandomFeatures:
    return CosineRandomFeatures(np.array(W), np.array(b), device=device)


def naive_bayes_from_numpy(log_prior, log_likelihood, device=None) -> NaiveBayesModel:
    return NaiveBayesModel(np.array(log_prior), np.array(log_likelihood), device=device)


def logistic_regression_from_numpy(W, b, device=None) -> LogisticRegressionModel:
    return LogisticRegressionModel(np.array(W), np.array(b), device=device)


def vectorizer_from_index(index, sparse="auto") -> SparseFeatureVectorizer:
    return SparseFeatureVectorizer(index, sparse=sparse)


def params_to_numpy(pipeline) -> dict:
    """The keys above, as numpy arrays, from a fitted pipeline of the
    gathered branches (``sift`` then ``lcs``, each holding one
    ``PCATransformer`` and one ``FisherVector``) and the head: what
    ``fit_head`` returns, or a serving pipeline. A ``Pipeline`` is read
    through its serving chain; a ``FusedTransformer`` of those stages is
    read as it is."""
    from keystone_tpu_torch.workflow.pipeline import GatherTransformer, Pipeline

    chain = pipeline.serving_chain() if isinstance(pipeline, Pipeline) else pipeline
    stages = list(getattr(chain, "stages", [chain]))
    if len(stages) < 2 or not isinstance(stages[0], GatherTransformer) or not isinstance(
        stages[1], BlockLinearMapper
    ) or len(stages[0].branches) != len(BRANCHES):
        raise ValueError("want a pipeline of [gather of the two branches, BlockLinearMapper, ...]")
    gather, head = stages[0], stages[1]
    d = {}
    for br, branch in zip(BRANCHES, gather.branches):
        parts = list(getattr(branch, "stages", [branch]))
        (pca,) = [s for s in parts if isinstance(s, PCATransformer)]
        (fv,) = [s for s in parts if isinstance(s, FisherVector)]
        d[f"{br}.pca.components"] = pca.components
        if pca.mean is not None:
            d[f"{br}.pca.mean"] = pca.mean
        d[f"{br}.gmm.weights"] = fv.weights
        d[f"{br}.gmm.means"] = fv.means
        d[f"{br}.gmm.variances"] = fv.variances
    d["head.W"] = head.W
    if head.b is not None:
        d["head.b"] = head.b
    d = {k: v.detach().cpu().numpy() for k, v in d.items()}
    d["head.blocks"] = np.array(head.blocks, dtype=np.int64)
    return d
