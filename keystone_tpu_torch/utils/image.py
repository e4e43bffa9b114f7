"""Image conventions: batches are NHWC float tensors (as in keystone_tpu)."""

from __future__ import annotations

import functools
import math

import torch

# ITU-R BT.601 luma weights, the standard grayscale conversion.
_LUMA = (0.299, 0.587, 0.114)


# Made once per (dtype, device): a host-to-card copy cannot be captured
# into a CUDA graph.
@functools.lru_cache(maxsize=None)
def _luma(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(_LUMA, dtype=dtype, device=device)


def grayscale(batch: torch.Tensor) -> torch.Tensor:
    """NHWC → NHW1 luminance, in the batch's dtype (the weights are cast to
    it, as the reference's ``jnp.asarray(_LUMA, dtype=batch.dtype)``)."""
    if batch.shape[-1] == 1:
        return batch
    w = _luma(batch.dtype, batch.device)
    return torch.tensordot(batch, w, dims=([-1], [0]))[..., None]


def clamped_gradients(g: torch.Tensor):
    """Central differences with edge-clamped borders for (n, h, w) images
    (counterpart of keystone_tpu/utils/image.py::clamped_gradients, :90-96):
    no wrap-around mixing opposite edges into border gradients."""
    gp = torch.nn.functional.pad(g[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = 0.5 * (gp[:, 1:-1, 2:] - gp[:, 1:-1, :-2])
    gy = 0.5 * (gp[:, 2:, 1:-1] - gp[:, :-2, 1:-1])
    return gx, gy


def orientation_maps(g: torch.Tensor, num_bins: int, signed: bool) -> torch.Tensor:
    """Soft-binned gradient-orientation channel maps for (n, h, w) images
    (counterpart of keystone_tpu/utils/image.py::orientation_maps, :99-117).

    Returns (n, h, w, num_bins): per pixel, the gradient magnitude split
    linearly between the two orientation bins bracketing its angle,
    unsigned ([0, π), HOG) or signed ([0, 2π), DAISY). ``torch.remainder``
    gives its result the divisor's sign, as ``jnp.mod`` does.
    """
    gx, gy = clamped_gradients(g)
    mag = torch.sqrt(gx * gx + gy * gy)
    period = 2 * math.pi if signed else math.pi
    theta = torch.remainder(torch.atan2(gy, gx), period)
    fbin = theta * num_bins / period
    floor = torch.floor(fbin)
    b0 = floor.to(torch.int32) % num_bins
    w1 = fbin - floor
    bins = torch.arange(num_bins, device=g.device)
    return (b0[..., None] == bins) * (mag * (1.0 - w1))[..., None] + (
        ((b0 + 1) % num_bins)[..., None] == bins
    ) * (mag * w1)[..., None]
