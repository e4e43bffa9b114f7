"""VOC-style mean average precision.

A numpy copy of ``keystone_tpu/evaluation/mean_average_precision.py``, for the serving
engine's precision quality gate (``workflow/serving.py``).
"""

from __future__ import annotations

import numpy as np


class MeanAveragePrecisionEvaluator:
    def __init__(self, num_classes: int, eleven_point: bool = True):
        self.num_classes = num_classes
        self.eleven_point = eleven_point

    def evaluate(self, scores, actual) -> dict:
        """scores: (n, C) real-valued; actual: (n, C) binary multilabels."""
        scores = np.asarray(scores, dtype=np.float64)
        actual = np.asarray(actual).astype(bool)
        if scores.shape != actual.shape:
            raise ValueError(f"shape mismatch {scores.shape} vs {actual.shape}")
        aps = np.array(
            [
                self.average_precision(scores[:, c], actual[:, c])
                for c in range(self.num_classes)
            ]
        )
        return {"per_class_ap": aps, "map": float(np.nanmean(aps))}

    def average_precision(self, scores, positives) -> float:
        positives = np.asarray(positives).astype(bool)
        n_pos = int(positives.sum())
        if n_pos == 0:
            return float("nan")
        order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="mergesort")
        hits = positives[order]
        tp = np.cumsum(hits)
        precision = tp / np.arange(1, len(hits) + 1)
        recall = tp / n_pos
        if self.eleven_point:
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                mask = recall >= t
                ap += precision[mask].max() if mask.any() else 0.0
            return float(ap / 11.0)
        # Exact AP: sum of precision at each positive rank.
        return float(precision[hits].sum() / n_pos)
