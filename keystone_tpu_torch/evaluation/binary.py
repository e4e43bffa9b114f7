"""Binary classification metrics.

A numpy copy of ``keystone_tpu/evaluation/binary.py``, for the serving
engine's precision quality gate (``workflow/serving.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BinaryMetrics:
    tp: int
    fp: int
    tn: int
    fn: int
    accuracy: float
    precision: float
    recall: float
    f1: float
    auc: float | None = None

    def summary(self) -> str:
        lines = [
            f"accuracy:  {self.accuracy:.4f}",
            f"precision: {self.precision:.4f}",
            f"recall:    {self.recall:.4f}",
            f"F1:        {self.f1:.4f}",
        ]
        if self.auc is not None:
            lines.append(f"AUC:       {self.auc:.4f}")
        return "\n".join(lines)


class BinaryClassifierEvaluator:
    @staticmethod
    def evaluate(predicted, actual, scores=None) -> BinaryMetrics:
        pred = np.asarray(predicted).astype(bool).ravel()
        act = np.asarray(actual).astype(bool).ravel()
        if pred.shape != act.shape:
            raise ValueError(f"shape mismatch {pred.shape} vs {act.shape}")
        tp = int(np.sum(pred & act))
        fp = int(np.sum(pred & ~act))
        tn = int(np.sum(~pred & ~act))
        fn = int(np.sum(~pred & act))
        n = len(pred)
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall
            else 0.0
        )
        auc = None
        if scores is not None:
            auc = BinaryClassifierEvaluator.auc(scores, act)
        return BinaryMetrics(
            tp, fp, tn, fn, (tp + tn) / n if n else 0.0, precision, recall, f1, auc
        )

    @staticmethod
    def auc(scores, actual) -> float:
        """Mann-Whitney rank estimator of ROC AUC (ties get average rank)."""
        s = np.asarray(scores, dtype=np.float64).ravel()
        a = np.asarray(actual).astype(bool).ravel()
        n_pos = int(a.sum())
        n_neg = len(a) - n_pos
        if n_pos == 0 or n_neg == 0:
            return 0.5
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty(len(s), dtype=np.float64)
        sorted_s = s[order]
        i = 0
        while i < len(s):
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        rank_sum = ranks[a].sum()
        return float(
            (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
        )
