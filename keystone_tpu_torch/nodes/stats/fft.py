"""Zero-padded FFT features (counterpart of
``keystone_tpu/nodes/stats/fft.py::PaddedFFT``, :24): each row zero-padded
to the next power of two n, its real FFT divided by √n, laid out as
``[real | imag]``: 2·(n/2 + 1) features (1,026 for MNIST's 784 pixels).
On the card the FFT is cuFFT's, as the reference leaves it to XLA."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from keystone_tpu_torch.workflow import Transformer


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class PaddedFFT(Transformer):
    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        n = _next_pow2(X.shape[-1])
        spec = torch.fft.rfft(F.pad(X, (0, n - X.shape[-1])), dim=-1) / math.sqrt(n)
        return torch.cat([spec.real, spec.imag], dim=-1).to(X.dtype)
