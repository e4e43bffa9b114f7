"""Patch extraction for test-time augmentation.

Counterpart of ``keystone_tpu/nodes/images/patches.py::CenterCornerPatcher``
(``:98-129``). ``RandomPatcher``, ``Windower`` and ``Cropper`` are not
ported yet: no ported pipeline uses them.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow import Transformer


class CenterCornerPatcher(Transformer):
    """The four corner crops and the center crop of side ``crop_size``, each
    also flipped left to right when ``with_flips``: (n, h, w, c) images →
    (n·views, s, s, c), each image's views contiguous."""

    row_independent = False  # n images emit n·views rows

    def __init__(self, crop_size: int, with_flips: bool = True):
        super().__init__()
        self.crop_size = crop_size
        self.with_flips = with_flips

    @property
    def num_views(self) -> int:
        return 10 if self.with_flips else 5

    def apply_batch(self, X):
        n, h, w, c = X.shape
        s = self.crop_size
        if s > h or s > w:
            raise ValueError(f"crop {s} exceeds image {h}x{w}")
        ct, cl = (h - s) // 2, (w - s) // 2
        crops = [
            X[:, :s, :s, :],
            X[:, :s, w - s :, :],
            X[:, h - s :, :s, :],
            X[:, h - s :, w - s :, :],
            X[:, ct : ct + s, cl : cl + s, :],
        ]
        if self.with_flips:
            crops += [crop.flip(2) for crop in crops]
        return torch.stack(crops, dim=1).reshape(-1, s, s, c)
