"""TIMIT frame features (counterpart of ``keystone_tpu/loaders/timit.py``).

``load`` reads an ``.npz`` with arrays ``features`` (n, d) and ``labels``
(n,), or a features CSV with a labels file; ``synthetic`` makes Gaussian
phone clusters with ±``context`` frames spliced around each frame (dim =
frame_dim · (2·context + 1), 440 for the canonical 40 × 11 MFCC setup),
with the reference's numpy generators, so the same seed gives the same
frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.synthetic import with_label_noise


class TimitFeaturesDataLoader:
    NUM_PHONES = 147  # the reference's phone-state label count

    @staticmethod
    def load(features_path: str, labels_path: str | None = None) -> LabeledData:
        if features_path.endswith(".npz"):
            data = np.load(features_path)
            return LabeledData(data["features"].astype(np.float32), data["labels"].astype(np.int32))
        X = np.loadtxt(features_path, delimiter=",", dtype=np.float32)
        if labels_path is None:
            raise ValueError("labels_path required for CSV features")
        y = np.loadtxt(labels_path, dtype=np.int64).astype(np.int32)
        return LabeledData(X, y)

    @staticmethod
    def synthetic(n: int = 4096, num_phones: int = 24, frame_dim: int = 40, context: int = 5,
                  seed: int = 0) -> Tuple[LabeledData, LabeledData]:
        """(train of n frames, test of max(n // 4, 256))."""
        rng = np.random.default_rng(seed)
        protos = rng.normal(scale=1.0, size=(num_phones, frame_dim))
        dim = frame_dim * (2 * context + 1)

        def make(count, off):
            r = np.random.default_rng(seed + off)
            y = r.integers(0, num_phones, size=count)
            center = protos[y] + 0.6 * r.normal(size=(count, frame_dim))
            # Neighbour frames: the same phone, more noise (coarticulation).
            frames = [center]
            for _k in range(2 * context):
                frames.append(protos[y] + 1.2 * r.normal(size=(count, frame_dim)))
            X = np.concatenate(frames, axis=1)
            assert X.shape[1] == dim
            y = with_label_noise(y, num_phones, r)
            return LabeledData(X.astype(np.float32), y.astype(np.int32))

        return make(n, 1), make(max(n // 4, 256), 2)
