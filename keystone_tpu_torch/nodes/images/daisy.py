"""DAISY-style dense descriptors (counterpart of
keystone_tpu/nodes/images/daisy.py).

Signed orientation maps (``utils/image.py::orientation_maps``) smoothed at
one scale per ring by three passes of a (2r+1)² mean (``_box_smooth``: the
window's own count at the borders, as the reference's SAME ``reduce_window``
sum over its count), then sampled at each keypoint's centre and on
``rings`` rings of ``ring_points`` points, each sample an L2-normalised
orientation histogram. The sample offsets are computed in numpy exactly as
the reference computes them (``np.round`` rounds half to even), since they
decide which pixel each sample reads. Output (n, K, descriptor_dim).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.utils.image import grayscale, orientation_maps
from keystone_tpu_torch.workflow import Transformer


def _box_smooth(x: torch.Tensor, radius: int, passes: int = 3) -> torch.Tensor:
    """(n, c, h, w) maps through ``passes`` SAME (2r+1)² means."""
    if radius <= 0:
        return x
    size = 2 * radius + 1
    for _ in range(passes):
        x = F.avg_pool2d(x, size, stride=1, padding=radius, count_include_pad=False)
    return x


class DaisyExtractor(Transformer):
    def __init__(self, step: int = 8, radius: int = 12, rings: int = 2, ring_points: int = 8,
                 num_bins: int = 8, eps: float = 1e-8):
        super().__init__()
        self.step = step
        self.radius = radius
        self.rings = rings
        self.ring_points = ring_points
        self.num_bins = num_bins
        self.eps = eps

    @property
    def descriptor_dim(self) -> int:
        return (1 + self.rings * self.ring_points) * self.num_bins

    def _sample_points(self, h: int, w: int):
        """Per scale, the (rows, cols) index arrays it is sampled at, each
        (K,) for the centre or (ring_points·K,) for a ring, as the
        reference computes them."""
        ys = np.arange(self.radius, h - self.radius, self.step)
        xs = np.arange(self.radius, w - self.radius, self.step)
        if len(ys) == 0 or len(xs) == 0:
            raise ValueError(f"image ({h}x{w}) smaller than the DAISY radius {self.radius}")
        ky, kx = np.meshgrid(ys, xs, indexing="ij")
        ky = ky.reshape(-1)
        kx = kx.reshape(-1)
        points = [(ky, kx)]
        for r in range(1, self.rings + 1):
            rad = self.radius * r / self.rings
            oys, oxs = [], []
            for p in range(self.ring_points):
                ang = 2 * np.pi * p / self.ring_points
                oys.append(np.clip(np.round(ky + rad * np.sin(ang)).astype(int), 0, h - 1))
                oxs.append(np.clip(np.round(kx + rad * np.cos(ang)).astype(int), 0, w - 1))
            points.append((np.concatenate(oys), np.concatenate(oxs)))
        return points

    def apply_batch(self, X):
        if X.shape[-1] != 1:
            X = grayscale(X)
        g = X[..., 0]
        n, h, w = g.shape
        points = self._sample_points(h, w)
        K = len(points[0][0])
        # Signed orientations ([0, 2π)), edge-clamped gradients; smoothed
        # channel-first.
        maps = orientation_maps(g, self.num_bins, signed=True).permute(0, 3, 1, 2).contiguous()
        samples = []
        for r, (oy, ox) in enumerate(points):
            # One smoothing scale per ring (the centre uses the finest).
            scale = _box_smooth(maps, max(1, self.radius * (r + 1) // (2 * self.rings)))
            flat = torch.as_tensor(oy * w + ox, device=g.device)
            got = scale.reshape(n, self.num_bins, h * w)[:, :, flat]  # (n, bins, P·K)
            samples.append(got.reshape(n, self.num_bins, -1, K).permute(0, 3, 2, 1))
        desc = torch.cat(samples, dim=2)  # (n, K, points, bins)
        norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
        desc = desc / torch.clamp_min(norm, self.eps)
        return desc.reshape(n, K, self.descriptor_dim)
