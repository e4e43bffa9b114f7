"""CIFAR-10: the binary format, or synthetic colour images.

Counterpart of ``keystone_tpu/loaders/cifar.py`` (``CifarLoader.load`` :25
and ``.synthetic`` :37), numpy only: the same file and the same seed give
the same arrays. Images are NHWC float32 in [0, 1]; ``synthetic`` gives
``n`` training and ``max(n // 4, 256)`` test images.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.synthetic import with_label_noise

_REC = 1 + 3 * 32 * 32  # one label byte, then 3,072 channel-major pixels


class CifarLoader:
    @staticmethod
    def load(path: str) -> LabeledData:
        raw = np.fromfile(path, dtype=np.uint8)
        if raw.size % _REC != 0:
            raise ValueError(f"{path}: not CIFAR-10 binary (size {raw.size})")
        raw = raw.reshape(-1, _REC)
        labels = raw[:, 0].astype(np.int32)
        imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return LabeledData(imgs.astype(np.float32) / 255.0, labels)

    @staticmethod
    def synthetic(n: int = 2048, num_classes: int = 10, seed: int = 0) -> Tuple[LabeledData, LabeledData]:
        """(train, test) of class-distinct smooth colour patterns plus noise."""
        rng = np.random.default_rng(seed)
        freq = rng.normal(size=(num_classes, 3, 4, 4))
        protos = np.zeros((num_classes, 32, 32, 3))
        for c in range(num_classes):
            for ch in range(3):
                f = np.zeros((32, 32))
                f[:4, :4] = freq[c, ch]
                protos[c, :, :, ch] = np.fft.ifft2(f).real
        protos -= protos.min(axis=(1, 2, 3), keepdims=True)
        protos /= protos.max(axis=(1, 2, 3), keepdims=True)

        def make(count, off):
            r = np.random.default_rng(seed + off)
            y = r.integers(0, num_classes, size=count)
            X = protos[y] + 0.25 * r.normal(size=(count, 32, 32, 3))
            y = with_label_noise(y, num_classes, r)
            return LabeledData(np.clip(X, 0, 1).astype(np.float32), y.astype(np.int32))

        return make(n, 1), make(max(n // 4, 256), 2)
