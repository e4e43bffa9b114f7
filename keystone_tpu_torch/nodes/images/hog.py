"""Histogram-of-oriented-gradients descriptors (counterpart of
keystone_tpu/nodes/images/hog.py).

Per-pixel unsigned gradient orientation soft-binned into ``num_bins``
channels (``utils/image.py::orientation_maps``), summed over ``cell_size``
cells, then 2×2-cell blocks normalised L2-hys (L2, clip, L2). The
reference's VALID ``reduce_window`` drops a partial last cell, so the maps
are cropped to whole cells before the sums.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.utils.image import grayscale, orientation_maps
from keystone_tpu_torch.workflow import Transformer


class HogExtractor(Transformer):
    def __init__(self, cell_size: int = 8, num_bins: int = 9, clip: float = 0.2, eps: float = 1e-6):
        super().__init__()
        self.cell_size = cell_size
        self.num_bins = num_bins
        self.clip = clip
        self.eps = eps

    def apply_batch(self, X):
        if X.shape[-1] != 1:
            X = grayscale(X)
        n, h, w = X.shape[:3]
        cs = self.cell_size
        ch, cw = h // cs, w // cs
        if ch < 2 or cw < 2:
            raise ValueError(
                f"image too small for HOG: {h}x{w} gives a "
                f"{ch}x{cw} cell grid (need >= 2x2 at cell_size="
                f"{self.cell_size})"
            )
        # Unsigned orientations ([0, π)), edge-clamped gradients.
        channels = orientation_maps(X[..., 0], self.num_bins, signed=False)
        cells = (
            channels[:, : ch * cs, : cw * cs]
            .reshape(n, ch, cs, cw, cs, self.num_bins)
            .sum(dim=(2, 4))
        )  # (n, ch, cw, bins)
        blocks = torch.cat(
            [cells[:, :-1, :-1], cells[:, :-1, 1:], cells[:, 1:, :-1], cells[:, 1:, 1:]],
            dim=-1,
        )  # (n, ch-1, cw-1, 4*bins)
        norm = torch.linalg.vector_norm(blocks, dim=-1, keepdim=True)
        blocks = blocks / torch.clamp_min(norm, self.eps)
        blocks = torch.clamp_max(blocks, self.clip)
        norm2 = torch.linalg.vector_norm(blocks, dim=-1, keepdim=True)
        blocks = blocks / torch.clamp_min(norm2, self.eps)
        return blocks.reshape(n, -1)
