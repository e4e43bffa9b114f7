"""CSV files as arrays (counterpart of ``keystone_tpu/loaders/csv_loader.py``,
:16-27): parsed on the host with numpy, float32 unless asked otherwise."""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData


class CsvDataLoader:
    @staticmethod
    def load(path: str, dtype=None) -> np.ndarray:
        return np.loadtxt(path, delimiter=",", dtype=dtype or np.float32)

    @staticmethod
    def load_labeled(path: str, label_col: int = 0) -> LabeledData:
        """A CSV with a label column (the first by default, as MNIST's CSV)."""
        raw = np.loadtxt(path, delimiter=",", dtype=np.float64)
        labels = raw[:, label_col].astype(np.int32)
        data = np.delete(raw, label_col, axis=1).astype(np.float32)
        return LabeledData(data, labels)
