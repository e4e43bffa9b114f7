"""Image conventions: batches are NHWC float tensors (as in keystone_tpu)."""

from __future__ import annotations

import functools

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
