"""Dense patch convolution with an optional ZCA whitener folded in.

Counterpart of ``keystone_tpu/nodes/images/convolver.py::Convolver``
(:25-80): VALID convolution of an NHWC batch with OHWI filters at
``stride``, NHWO out. A fitted whitener ``(x − μ)M`` is folded into the
filters once: ``((p − μ)M)fᵀ = p(Mf)ᵀ − μMf``, so the filters become
``Mf`` and each output channel gains the bias ``−μMf``.

On the card the convolution is cuDNN's (``F.conv2d``), as the reference
leaves it to XLA outside any Pallas kernel; layouts are permuted at the
boundary (NHWC as channels-last NCHW, OHWI as OIHW). Which arithmetic is
in force:

- ``compute_dtype`` None or ``"float32"``: float32, cuDNN's TF32 off
  around the call (``config.cudnn_tf32``);
- ``"bfloat16"``: the reference's bfloat16 operands with float32
  accumulation and a float32 output. The batch and filters are rounded to
  bfloat16 and held as float32 again; cuDNN then runs with TF32 on, which
  holds every bfloat16 value exactly (8 of TF32's 10 mantissa bits) and
  accumulates in float32. So the products are the reference's exact
  bfloat16 products, at the tensor cores' TF32 rate rather than their
  bfloat16 rate. On the CPU the same rounded operands convolve in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from keystone_tpu_torch.config import cudnn_tf32, default_dtype, resolve_device
from keystone_tpu_torch.workflow import Transformer

COMPUTE_DTYPES = (None, "float32", "bfloat16")


class Convolver(Transformer):
    """``filters``: (num_filters, fh, fw, c); ``whitener``: a fitted
    ``ZCAWhitener`` to fold in, or else ``bias``: the (num_filters,) bias of
    filters already folded (a fitted Convolver's ``filters`` and ``bias``,
    the reference's or the port's)."""

    def __init__(self, filters, stride: int = 1, whitener=None,
                 compute_dtype: Optional[str] = None, device=None, bias=None):
        super().__init__()
        device = resolve_device(device)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: expected one of {COMPUTE_DTYPES}")
        if whitener is not None and bias is not None:
            raise ValueError("give a whitener to fold or the bias of folded filters, not both")
        filters = torch.as_tensor(filters, dtype=default_dtype, device=device)
        if whitener is not None:
            nf = filters.shape[0]
            flat = filters.reshape(nf, -1)  # (nf, fh·fw·c)
            M, mu = whitener.whitener.to(device), whitener.mean.to(device)
            bias = -(mu @ M.T) @ flat.T  # (nf,)
            filters = (flat @ M.T).reshape(filters.shape)
        elif bias is not None:
            bias = torch.as_tensor(bias, dtype=default_dtype, device=device)
        self.register_buffer("filters", filters.contiguous())
        self.register_buffer("bias", bias)
        self.stride = stride
        self.bf16 = compute_dtype == "bfloat16"
        weight = self.filters.permute(0, 3, 1, 2)  # OHWI → OIHW
        if self.bf16:
            weight = weight.to(torch.bfloat16).to(default_dtype)
        self.register_buffer("weight", weight.contiguous(), persistent=False)

    @property
    def compute_dtype(self) -> Optional[str]:
        return "bfloat16" if self.bf16 else None

    def apply_batch(self, X):
        x = X.permute(0, 3, 1, 2)  # NHWC as channels-last NCHW
        if self.bf16:
            x = x.to(torch.bfloat16).to(default_dtype)
        with cudnn_tf32(self.bf16):
            out = F.conv2d(x, self.weight, stride=self.stride).permute(0, 2, 3, 1)
        if self.bias is not None:
            out = out + self.bias
        return out
