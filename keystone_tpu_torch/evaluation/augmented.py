"""Evaluation over augmented views (test-time augmentation).

Counterpart of ``keystone_tpu/evaluation/augmented.py``
(``AugmentedExamplesEvaluator``, ``:13-34``), on tensors.
"""

from __future__ import annotations

import torch


class AugmentedExamplesEvaluator:
    """Scores (n·views, C) with all views of image i contiguous; labels (n,)."""

    def __init__(self, num_views: int):
        self.num_views = num_views

    def average_scores(self, scores) -> torch.Tensor:
        """(n, C): each image's scores averaged over its views."""
        scores = torch.as_tensor(scores)
        n = scores.shape[0] // self.num_views
        if scores.shape[0] != n * self.num_views:
            raise ValueError(f"{scores.shape[0]} rows not divisible by {self.num_views} views")
        return scores.reshape(n, self.num_views, -1).mean(dim=1)

    def top_k_error(self, scores, labels, k: int = 5) -> float:
        avg = self.average_scores(scores)
        labels = torch.as_tensor(labels, device=avg.device).reshape(-1)
        topk = torch.topk(avg, k, dim=1).indices
        return float(1.0 - (topk == labels[:, None]).any(dim=1).double().mean())
