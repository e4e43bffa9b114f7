"""Local color statistics (LCS) descriptors.

Counterpart of ``keystone_tpu/nodes/images/lcs.py::LCSExtractor``: per
keypoint, per 4×4 sub-cell, the mean and standard deviation of each colour
channel → 96-dim descriptors for RGB. The per-cell sums are box sums of x
and x² (``avg_pool2d`` with ``divisor_override=1``, i.e. plain window sums,
stride 1), gathered at the dense keypoint grid by index tensors — the same
grid geometry as SIFT, so the two branches stay keypoint-aligned.

On a bfloat16 batch (the serving engine's ``bf16`` precision) every step
stays in bfloat16, as in the reference: its ``reduce_window`` adds the
window's values one at a time in row-major order, each sum rounded to
bfloat16 (and x² is rounded before it is summed), so the box sums here are
the same sequence of bfloat16 adds of shifted slices rather than
``avg_pool2d``'s float accumulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from keystone_tpu_torch.workflow import Transformer

_CELLS = 4  # 4x4 sub-cells, matching the SIFT spatial grid


def _box_sums(x, bs: int):
    """Sums over every bs × bs window, stride 1, of NCHW ``x``."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, bs, stride=1, divisor_override=1)
    h, w = x.shape[2] - bs + 1, x.shape[3] - bs + 1
    acc = torch.zeros_like(x[:, :, :h, :w])
    for dy in range(bs):
        for dx in range(bs):
            acc = acc + x[:, :, dy : dy + h, dx : dx + w]
    return acc


class LCSExtractor(Transformer):
    def __init__(self, step: int = 4, bin_size: int = 4, eps: float = 1e-8):
        super().__init__()
        self.step = step
        self.bin_size = bin_size
        self.eps = eps

    def signature(self):
        return self.stable_signature(self.step, self.bin_size, self.eps)

    def num_keypoints(self, h: int, w: int) -> int:
        span = _CELLS * self.bin_size
        nx = (w - span) // self.step + 1 if w >= span else 0
        ny = (h - span) // self.step + 1 if h >= span else 0
        return nx * ny

    def apply_batch(self, X):
        n, h, w, c = X.shape
        bs = self.bin_size
        span = _CELLS * bs
        if h < span or w < span:
            raise ValueError(
                f"image ({h}x{w}) smaller than the {span}px descriptor "
                f"support (bin_size={bs} x {_CELLS} cells)"
            )
        ny = (h - span) // self.step + 1
        nx = (w - span) // self.step + 1
        x = X.permute(0, 3, 1, 2)  # NCHW for the pooling
        s1 = _box_sums(x, bs)
        s2 = _box_sums(x * x, bs)
        area = bs * bs
        # Cell top-left corners for every keypoint and sub-cell.
        dev = X.device
        ky = torch.arange(ny, device=dev) * self.step
        kx = torch.arange(nx, device=dev) * self.step
        cell = torch.arange(_CELLS, device=dev) * bs
        rows = (ky[:, None] + cell[None, :]).reshape(-1)  # (ny*4,)
        cols = (kx[:, None] + cell[None, :]).reshape(-1)  # (nx*4,)
        # Gather → (n, ny*4, nx*4, c), channels last again.
        g1 = s1[:, :, rows][:, :, :, cols].permute(0, 2, 3, 1)
        g2 = s2[:, :, rows][:, :, :, cols].permute(0, 2, 3, 1)
        mean = g1 / area
        var = torch.clamp_min(g2 / area - mean * mean, 0.0)
        std = torch.sqrt(var + self.eps)
        stats = torch.cat([mean, std], dim=-1)  # (n, ny*4, nx*4, 2c)
        # Regroup into per-keypoint descriptors: (n, ny, nx, 4, 4, 2c).
        stats = stats.reshape(n, ny, _CELLS, nx, _CELLS, 2 * c)
        stats = stats.permute(0, 1, 3, 2, 4, 5)
        return stats.reshape(n, ny * nx, _CELLS * _CELLS * 2 * c)
