"""Multiclass classification metrics.

A numpy copy of ``keystone_tpu/evaluation/multiclass.py``, for the serving
engine's precision quality gate (``workflow/serving.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MulticlassMetrics:
    confusion: np.ndarray  # (classes, classes); rows = actual, cols = predicted
    total_accuracy: float
    per_class_accuracy: np.ndarray
    macro_f1: float

    def summary(self) -> str:
        lines = [
            f"total accuracy: {self.total_accuracy:.4f}",
            f"macro F1:       {self.macro_f1:.4f}",
            "per-class accuracy: "
            + " ".join(f"{a:.3f}" for a in self.per_class_accuracy),
        ]
        return "\n".join(lines)


class MulticlassClassifierEvaluator:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predicted, actual) -> MulticlassMetrics:
        pred = np.asarray(predicted).astype(np.int64).ravel()
        act = np.asarray(actual).astype(np.int64).ravel()
        if pred.shape != act.shape:
            raise ValueError(f"shape mismatch {pred.shape} vs {act.shape}")
        c = self.num_classes
        confusion = np.zeros((c, c), dtype=np.int64)
        np.add.at(confusion, (act, pred), 1)
        total = confusion.sum()
        correct = np.trace(confusion)
        actual_counts = confusion.sum(axis=1)
        pred_counts = confusion.sum(axis=0)
        tp = np.diag(confusion).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_class_acc = np.where(actual_counts > 0, tp / actual_counts, 0.0)
            precision = np.where(pred_counts > 0, tp / pred_counts, 0.0)
            recall = per_class_acc
            f1 = np.where(
                precision + recall > 0,
                2 * precision * recall / (precision + recall),
                0.0,
            )
        return MulticlassMetrics(
            confusion=confusion,
            total_accuracy=float(correct / total) if total else 0.0,
            per_class_accuracy=per_class_acc,
            macro_f1=float(f1.mean()),
        )
