"""Numeric defaults, the solver's modes and device resolution for the port.

Precision follows the JAX reference on the CPU, which is float32 throughout.
On the card both of PyTorch's TF32 switches matter:

- ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default),
  set again by ``resolve_device`` whenever it hands out a CUDA device; the
  solver turns it on around its own products only, and only at the
  ``high`` and ``default`` precisions (``linalg/row_matrix.py``);
- ``torch.backends.cudnn.allow_tf32`` defaults to True, so the SIFT
  convolutions turn it off around their own calls (``ops/sift.py``) — the
  JAX code asks for ``Precision.HIGHEST`` there on purpose.

The solver's modes are the reference's ``config.solver_precision`` and
``config.solver_storage_dtype`` (``keystone_tpu/config.py:95-126``). Here
they are arguments of a solve; ``solver_precision`` and
``solver_storage_dtype`` resolve an argument left at None from the
reference's environment variables, with its choices, and refuse a value
outside them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

default_dtype = torch.float32

SOLVER_PRECISIONS = ("highest", "high", "default")
SOLVER_STORAGE_DTYPES = ("float32", "bfloat16")


def _choice(name: str, value: Optional[str], choices: tuple, default: str) -> str:
    """``value``, or else the environment variable ``name`` (case and
    surrounding blanks ignored; unset or empty gives ``default``)."""
    if value is None:
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return default
        val = raw.strip().lower()
        if val not in choices:
            raise ValueError(f"{name}={raw!r}: expected one of {choices}")
        return val
    if value not in choices:
        raise ValueError(f"{value!r}: expected one of {choices}")
    return value


def solver_precision(precision: Optional[str] = None) -> str:
    """The precision of the solver's float32 products: ``highest`` (float32,
    TF32 off), ``high`` or ``default`` (TF32 on the card). None reads
    ``KEYSTONE_SOLVER_PRECISION``, ``highest`` when unset."""
    return _choice("KEYSTONE_SOLVER_PRECISION", precision, SOLVER_PRECISIONS, "highest")


def solver_storage_dtype(dtype: Optional[str] = None) -> str:
    """The dtype the solver stores its feature matrix A in: ``float32``, or
    ``bfloat16`` (half the bytes; every product that touches A multiplies
    bfloat16 operands into float32). None reads ``KEYSTONE_SOLVER_DTYPE``,
    ``float32`` when unset."""
    return _choice("KEYSTONE_SOLVER_DTYPE", dtype, SOLVER_STORAGE_DTYPES, "float32")


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
