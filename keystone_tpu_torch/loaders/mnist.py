"""MNIST: IDX or CSV files, or synthetic digits.

Counterpart of ``keystone_tpu/loaders/mnist.py`` (``_read_idx`` :23,
``MnistLoader.load`` :34 and ``.synthetic`` :45), numpy only: the same
files and the same seed give the same arrays. ``synthetic`` makes smooth
per-class prototypes plus noise, ``n`` training and ``max(n // 4, 256)``
test rows.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from keystone_tpu_torch.loaders.csv_loader import CsvDataLoader
from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.synthetic import with_label_noise


def _read_idx(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        _, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MnistLoader:
    @staticmethod
    def load(path: str) -> LabeledData:
        """A CSV (label first), or the IDX pair ``path + '-images-idx3-ubyte'``
        and ``path + '-labels-idx1-ubyte'``: (n, 784) pixels in [0, 1]."""
        if path.endswith(".csv"):
            return CsvDataLoader.load_labeled(path)
        imgs = _read_idx(path + "-images-idx3-ubyte")
        labels = _read_idx(path + "-labels-idx1-ubyte")
        X = imgs.reshape(imgs.shape[0], -1).astype(np.float32) / 255.0
        return LabeledData(X, labels.astype(np.int32))

    @staticmethod
    def synthetic(
        n: int = 4096, num_classes: int = 10, dim: int = 784, seed: int = 0
    ) -> Tuple[LabeledData, LabeledData]:
        """(train, test) of MNIST-like rows: low-frequency class prototypes
        plus Gaussian noise of standard deviation 0.35."""
        rng = np.random.default_rng(seed)
        freq = rng.normal(size=(num_classes, 8, 8))
        protos = np.zeros((num_classes, 28, 28), dtype=np.float64)
        for c in range(num_classes):
            f = np.zeros((28, 28))
            f[:8, :8] = freq[c]
            protos[c] = np.abs(np.fft.ifft2(f).real)
        protos = protos.reshape(num_classes, -1)
        protos /= protos.max(axis=1, keepdims=True)

        def make(count, seed_off):
            r = np.random.default_rng(seed + seed_off)
            y = r.integers(0, num_classes, size=count)
            X = protos[y][:, :dim] if dim <= 784 else np.pad(protos[y], ((0, 0), (0, dim - 784)))
            X = X + 0.35 * r.normal(size=X.shape)
            y = with_label_noise(y, num_classes, r)
            return LabeledData(X.astype(np.float32), y.astype(np.int32))

        return make(n, 1), make(max(n // 4, 256), 2)
