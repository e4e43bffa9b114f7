"""Patch extraction.

Counterpart of ``keystone_tpu/nodes/images/patches.py``:

- ``RandomPatcher`` (:15-41): ``num_patches`` random square patches of a
  batch, the filter sampler of RandomPatchCifar. Its image, top and left
  indices come from ``np.random.default_rng(seed)`` in the reference's
  order, so the same batch and seed give the same patches, bit for bit;
- ``Windower``: every window at a stride, the im2col view;
- ``Cropper``: one fixed crop;
- ``CenterCornerPatcher`` (:98-129): the views of test-time augmentation.

Batches are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.workflow import Transformer


class RandomPatcher(Transformer):
    """(n, h, w, c) → (num_patches, size, size, c), each patch from an image
    and position drawn from ``seed``."""

    row_independent = False  # its rows are drawn across the whole batch

    def __init__(self, num_patches: int, patch_size: int, seed: int = 0):
        super().__init__()
        self.num_patches = num_patches
        self.patch_size = patch_size
        self.seed = seed

    def apply_batch(self, X):
        X = torch.as_tensor(X)
        n, h, w, _c = X.shape
        p = self.patch_size
        rng = np.random.default_rng(self.seed)
        img_idx = rng.integers(0, n, size=self.num_patches)
        tops = rng.integers(0, h - p + 1, size=self.num_patches)
        lefts = rng.integers(0, w - p + 1, size=self.num_patches)
        rows = tops[:, None] + np.arange(p)[None, :]  # (num_patches, p)
        cols = lefts[:, None] + np.arange(p)[None, :]
        idx = [torch.from_numpy(a).to(X.device) for a in (img_idx[:, None, None], rows[:, :, None], cols[:, None, :])]
        return X[idx[0], idx[1], idx[2], :]


class Windower(Transformer):
    """Every ``window_size`` × ``window_size`` window at ``stride``:
    (n, h, w, c) → (n·out_h·out_w, p, p, c), each image's windows row by
    row."""

    row_independent = False  # n images give n·windows rows

    def __init__(self, stride: int, window_size: int):
        super().__init__()
        self.stride = stride
        self.window_size = window_size

    def apply_batch(self, X):
        p, s, c = self.window_size, self.stride, X.shape[-1]
        wins = X.unfold(1, p, s).unfold(2, p, s)  # (n, out_h, out_w, c, p, p)
        return wins.permute(0, 1, 2, 4, 5, 3).reshape(-1, p, p, c)


class Cropper(Transformer):
    """The crop of ``height`` × ``width`` at (``top``, ``left``)."""

    def __init__(self, top: int, left: int, height: int, width: int):
        super().__init__()
        if min(top, left) < 0 or min(height, width) <= 0:
            raise ValueError(f"invalid crop (top={top}, left={left}, h={height}, w={width})")
        self.top = top
        self.left = left
        self.height = height
        self.width = width

    def apply_batch(self, X):
        if self.top + self.height > X.shape[1] or self.left + self.width > X.shape[2]:
            raise ValueError(
                f"crop {self.top}+{self.height} x {self.left}+{self.width} "
                f"exceeds image {X.shape[1]}x{X.shape[2]}"
            )
        return X[:, self.top : self.top + self.height, self.left : self.left + self.width, :]


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
