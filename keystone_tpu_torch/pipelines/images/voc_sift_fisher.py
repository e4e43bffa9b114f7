"""VOCSIFTFisher — the VOC multi-label pipeline: SIFT and Fisher vectors.

Counterpart of ``keystone_tpu/pipelines/images/voc_sift_fisher.py``
(config :32-51, ``build_featurizer`` :53, ``run`` :71, ``main`` :114):

    images (n, 128, 128, 3) → GrayScaler → dense SIFT (128-d) → PCA → FisherVector
        → SignedHellinger → L2 → BlockLeastSquaresEstimator on ±1 class targets → scores → mAP

PCA and the GMM are fitted on a sample of ``descriptor_sample`` training
descriptors (``fit_fisher_featurizer``), the head by block coordinate
descent in blocks of ``block_size`` features. At the reference's widths
(``pca_dims=64``, ``gmm_k=16``) an image has 2·16·64 = 2,048 features, and
the Fisher vector runs the port's Hopper kernel at k = 16 on the card.
Results are the mean average precision (VOC's eleven-point AP) and each
class's AP, through ``evaluation/mean_average_precision.py``.

The images are synthetic (``VOCLoader.synthetic``, ``synthetic_n``
training images of ``synthetic_classes`` classes), or with ``image_dir``
VOC's JPEGs and XML annotations (``VOCLoader.load``, 20 classes, 128×128).

The port's default SIFT backend is ``xla``, dense SIFT on the device. The
reference's default, ``native``, is the host C++ kernel, which the port
builds from its own copy (``native.py``); the port keeps ``xla`` so that
the serving engine can capture the whole chain in CUDA graphs (ROADMAP,
departures by design). ``fv_backend`` takes the reference's ``tpu`` and
``pallas`` (both the port's kernel) and ``native`` (the host encoder).

    python -m keystone_tpu_torch.pipelines.images.voc_sift_fisher [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.config import resolve_device
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.voc import VOCLoader
from keystone_tpu_torch.nodes.images.external.fisher_vector import fit_fisher_featurizer
from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor
from keystone_tpu_torch.nodes.images.pixels import GrayScaler
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats.hellinger import SignedHellingerMapper
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.utils.stages import mark
from keystone_tpu_torch.workflow import Pipeline, on_device


@dataclass
class VOCSIFTFisherConfig:
    image_dir: Optional[str] = None
    annotation_dir: Optional[str] = None
    test_image_dir: Optional[str] = None
    test_annotation_dir: Optional[str] = None
    sift_step: int = 4
    sift_bin: int = 4
    sift_backend: str = "xla"
    pca_dims: int = 64
    gmm_k: int = 16
    gmm_iters: int = 20
    descriptor_sample: int = 100_000
    lam: float = 1e-3
    block_size: int = 4096
    num_iters: int = 2
    fv_backend: str = "tpu"
    seed: int = 0
    synthetic_n: int = 192
    synthetic_classes: int = 6

    @property
    def feature_dim(self) -> int:
        return 2 * self.gmm_k * self.pca_dims


def _front(conf: VOCSIFTFisherConfig) -> Pipeline:
    return GrayScaler().and_then(
        SIFTExtractor(step=conf.sift_step, bin_size=conf.sift_bin, backend=conf.sift_backend)
    )


def build_featurizer(conf: VOCSIFTFisherConfig, train_images, device=None) -> Pipeline:
    """PCA and the GMM fitted on training descriptors; the whole featurizer,
    images → (n, feature_dim)."""
    return fit_fisher_featurizer(
        _front(conf),
        train_images,
        pca_dims=conf.pca_dims,
        gmm_k=conf.gmm_k,
        em_iters=conf.gmm_iters,
        sample_size=conf.descriptor_sample,
        seed=conf.seed,
        device=device,
        backend=conf.fv_backend,
    )


def featurizer_from_params(conf: VOCSIFTFisherConfig, pca, fv) -> Pipeline:
    """The featurizer around a fitted ``PCATransformer`` and ``FisherVector``
    (the reference's, carried by ``convert.voc_params_from_numpy``)."""
    return (
        _front(conf).and_then(pca).and_then(fv)
        .and_then(SignedHellingerMapper()).and_then(L2Normalizer())
    )


def fit(conf: VOCSIFTFisherConfig, train: LabeledData, device=None) -> Pipeline:
    """images → (n, C) scores: the training images go to ``device`` once,
    the featurizer is fitted on them, then the head on their features and
    the ±1 class targets ``2·labels − 1``."""
    device = resolve_device(device)
    images = torch.as_tensor(train.data).to(device)
    mark("copy of the images to the device")
    featurizer = build_featurizer(conf, images, device)
    targets = 2.0 * torch.as_tensor(train.labels, dtype=torch.float32, device=device) - 1.0
    solver = BlockLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam)
    with on_device(device):
        return featurizer.and_then(solver, images, targets).fit()


def scores(scored: Pipeline, images, device=None) -> np.ndarray:
    """``scored`` applied to host images (in batches) on ``device``."""
    with torch.inference_mode(), on_device(device):
        return scored(images).get().cpu().numpy()


def load(conf: VOCSIFTFisherConfig):
    """(train, test, num_classes): VOC's files when ``image_dir`` is set,
    else the synthetic images."""
    if conf.image_dir:
        if not (conf.annotation_dir and conf.test_image_dir and conf.test_annotation_dir):
            raise ValueError("real data requires train+test image and annotation dirs")
        train = VOCLoader.load(conf.image_dir, conf.annotation_dir)
        test = VOCLoader.load(conf.test_image_dir, conf.test_annotation_dir)
        return train, test, train.labels.shape[1]
    train, test = VOCLoader.synthetic(n=conf.synthetic_n, num_classes=conf.synthetic_classes)
    return train, test, conf.synthetic_classes


def evaluate(test_scores: np.ndarray, labels: np.ndarray, num_classes: int, seconds: float) -> dict:
    result = MeanAveragePrecisionEvaluator(num_classes).evaluate(test_scores, labels)
    return {
        "map": result["map"],
        "per_class_ap": result["per_class_ap"].tolist(),
        "seconds": seconds,
        "summary": f"mAP: {result['map']:.4f}",
    }


def run(conf: VOCSIFTFisherConfig, device=None) -> dict:
    """Fit on the training split and score the test split; the reference's
    result keys (``map``, ``per_class_ap``, ``seconds``, ``summary``)."""
    device = resolve_device(device)
    train, test, num_classes = load(conf)
    mark("loading the images")
    t0 = time.perf_counter()
    scored = fit(conf, train, device)
    test_scores = scores(scored, test.data, device)
    mark("scoring the test set")
    return evaluate(test_scores, test.labels, num_classes, time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description="VOC SIFT+FisherVector pipeline (PyTorch/CUDA port)")
    p.add_argument("--images", dest="image_dir")
    p.add_argument("--annotations", dest="annotation_dir")
    p.add_argument("--test-images", dest="test_image_dir")
    p.add_argument("--test-annotations", dest="test_annotation_dir")
    p.add_argument("--pca-dims", type=int, default=64)
    p.add_argument("--gmm-k", type=int, default=16)
    p.add_argument("--lam", type=float, default=1e-3)
    p.add_argument("--fv-backend", choices=["tpu", "pallas", "native"], default="tpu")
    p.add_argument("--sift-backend", choices=["native", "xla"], default="xla",
                   help="xla runs dense SIFT on the device; native on the host (C++)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=192)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    out = run(
        VOCSIFTFisherConfig(
            image_dir=a.image_dir,
            annotation_dir=a.annotation_dir,
            test_image_dir=a.test_image_dir,
            test_annotation_dir=a.test_annotation_dir,
            pca_dims=a.pca_dims,
            gmm_k=a.gmm_k,
            lam=a.lam,
            fv_backend=a.fv_backend,
            sift_backend=a.sift_backend,
            seed=a.seed,
            synthetic_n=a.synthetic_n,
        ),
        a.device,
    )
    print(out["summary"])
    print(f"total {out['seconds']:.2f}s")
    return out


if __name__ == "__main__":
    main()
