"""Pixel-level nodes (counterpart of keystone_tpu/nodes/images/pixels.py:
``GrayScaler``, ``PixelScaler`` :21, ``ImageVectorizer`` :34)."""

from __future__ import annotations

from keystone_tpu_torch.utils.image import grayscale
from keystone_tpu_torch.workflow import Transformer


class GrayScaler(Transformer):
    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        return grayscale(X)


class PixelScaler(Transformer):
    """uint8 pixel range → [0, 1]: ``X / scale``."""

    def __init__(self, scale: float = 255.0):
        super().__init__()
        self.scale = scale

    def signature(self):
        return self.stable_signature(self.scale)

    def apply_batch(self, X):
        return X / self.scale


class ImageVectorizer(Transformer):
    """NHWC → (N, H·W·C) rows."""

    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        return X.reshape(X.shape[0], -1)
