"""Numeric defaults and device resolution for the port.

Precision follows the JAX reference on the CPU, which is float32 throughout.
On the card both of PyTorch's TF32 switches matter:

- ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default),
  set again by ``resolve_device`` whenever it hands out a CUDA device;
- ``torch.backends.cudnn.allow_tf32`` defaults to True, so the SIFT
  convolutions turn it off around their own calls (``ops/sift.py``) — the
  JAX code asks for ``Precision.HIGHEST`` there on purpose.
"""

from __future__ import annotations

import torch

default_dtype = torch.float32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    absent — nothing falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def as_input(data, device=None) -> torch.Tensor:
    """``data`` as a float32 tensor for a fit: a tensor stays on its device;
    anything else (a host array) goes to ``resolve_device(device)``, so
    ``cuda`` unless the caller names another."""
    if isinstance(data, torch.Tensor):
        resolve_device(data.device)
        return data.to(default_dtype)
    return torch.as_tensor(data, dtype=default_dtype, device=resolve_device(device))
