"""Dense SIFT as two grouped 1-D convolutions, on the device.

Counterpart of ``keystone_tpu/ops/sift_xla.py::dense_sift_xla``, with the
same math: every per-pixel weight of the descriptor sum factorises into a
Gaussian times bilinear cell weights along y and along x, so extraction is

  1. edge-clamped central-difference gradients,
  2. soft binning of the gradient magnitude into 8 orientation channels,
  3. a stride-``step`` grouped 1-D convolution along y with 4 filters per
     channel, then the same along x,
  4. the native kernel's ``(cy, cx, b)`` channel order, and L2 → 0.2 clamp
     → re-L2 normalisation with a norm guard.

Layouts at the boundary match the reference ((n, h, w) in, (n, nkp, 128)
out); inside, the orientation channels are NCHW for ``F.conv2d``. The
convolutions run with cuDNN TF32 off (``config.cudnn_tf32(False)``): cuDNN
runs float32 convolutions in TF32 by default, which keeps about three
decimal digits, and the descriptor convolutions must stay float32, as the
JAX reference's ``Precision.HIGHEST`` asks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.config import cudnn_tf32

ORI_BINS = 8
SPATIAL_BINS = 4
DESC_DIM = SPATIAL_BINS * SPATIAL_BINS * ORI_BINS  # 128


def _cell_kernels(bin_size: int) -> np.ndarray:
    """(SPATIAL_BINS, span) separable 1-D weights: Gaussian × bilinear.
    Row c gives, for each offset within the span, the weight of spatial
    cell c along that axis."""
    span = SPATIAL_BINS * bin_size
    center = 0.5 * (span - 1)
    sigma = 0.5 * span
    off = np.arange(span)
    gauss = np.exp(-((off - center) ** 2) / (2.0 * sigma * sigma))
    pos = (off + 0.5) / bin_size - 0.5
    cells = np.arange(SPATIAL_BINS)[:, None]
    w = np.maximum(0.0, 1.0 - np.abs(pos[None, :] - cells))
    return (w * gauss[None, :]).astype(np.float32)  # (4, span)


def _native_permutation() -> np.ndarray:
    """Index that reorders conv channels ``(b, cy, cx)`` into the native
    layout ``(cy, cx, b)``."""
    b_i, cy_i, cx_i = np.meshgrid(
        np.arange(ORI_BINS),
        np.arange(SPATIAL_BINS),
        np.arange(SPATIAL_BINS),
        indexing="ij",
    )
    native_index = (cy_i * SPATIAL_BINS + cx_i) * ORI_BINS + b_i
    perm = np.empty(DESC_DIM, dtype=np.int64)
    perm[native_index.ravel()] = np.arange(DESC_DIM)
    return perm


# The filters and the channel permutation go to the device once: a
# host-to-card copy cannot be captured into a CUDA graph.
@functools.lru_cache(maxsize=None)
def _device_constants(bin_size: int, device: torch.device):
    k1d = torch.from_numpy(_cell_kernels(bin_size)).to(device)
    span = SPATIAL_BINS * bin_size
    fy = k1d.repeat(ORI_BINS, 1).reshape(ORI_BINS * SPATIAL_BINS, 1, span, 1)
    fx = k1d.repeat(ORI_BINS * SPATIAL_BINS, 1).reshape(DESC_DIM, 1, 1, span)
    return fy, fx, torch.from_numpy(_native_permutation()).to(device)


def _gradients(im: torch.Tensor):
    """Edge-clamped central differences: at the borders the clamped index
    makes the difference one-sided (still ×0.5)."""
    padx = torch.cat([im[:, :, :1], im, im[:, :, -1:]], dim=2)
    pady = torch.cat([im[:, :1], im, im[:, -1:]], dim=1)
    gx = 0.5 * (padx[:, :, 2:] - padx[:, :, :-2])
    gy = 0.5 * (pady[:, 2:] - pady[:, :-2])
    return gx, gy


def _orientation_channels(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(n, h, w) gradients → (n, 8, h, w) soft-assigned magnitude channels
    (linear interpolation between the two adjacent orientation bins)."""
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)
    theta = torch.where(theta < 0, theta + 2.0 * np.pi, theta)
    fbin = theta * (ORI_BINS / (2.0 * np.pi))
    bins = torch.arange(ORI_BINS, dtype=fbin.dtype, device=fbin.device)
    dist = torch.abs(fbin[:, None] - bins[None, :, None, None])
    circ = torch.minimum(dist, ORI_BINS - dist)
    return mag[:, None] * torch.clamp_min(1.0 - circ, 0.0)


def dense_sift(images: torch.Tensor, step: int = 4, bin_size: int = 4) -> torch.Tensor:
    """(n, h, w) grayscale → (n, nkp, 128) dense SIFT, on the tensor's device."""
    images = images.to(torch.float32)
    n, h, w = images.shape
    span = SPATIAL_BINS * bin_size
    if h < span or w < span:
        raise ValueError(
            f"image ({h}x{w}) smaller than the {span}px descriptor support"
        )
    ori = _orientation_channels(*_gradients(images))  # (n, 8, h, w)
    # y-pass: each orientation channel b gives 4 cell-y responses, output
    # channels ordered (b, cy). x-pass: each (b, cy) gives 4 cell-x
    # responses, channels ordered (b, cy, cx).
    fy, fx, perm = _device_constants(bin_size, images.device)
    with cudnn_tf32(False):
        out = F.conv2d(ori, fy, stride=(step, 1), groups=ORI_BINS)
        out = F.conv2d(out, fx, stride=(1, step), groups=ORI_BINS * SPATIAL_BINS)
    ny, nx = out.shape[2], out.shape[3]
    desc = out.permute(0, 2, 3, 1).reshape(n, ny * nx, DESC_DIM)[..., perm]

    # L2 → 0.2 clamp → re-L2, with the native kernel's norm guard: a
    # descriptor whose norm is at or below the floor stays exactly zero.
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = torch.clamp_max(desc / torch.clamp_min(norm, 1e-12), 0.2)
    norm2 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return torch.where(
        norm > 1e-12, desc / torch.clamp_min(norm2, 1e-12), torch.zeros_like(desc)
    )
