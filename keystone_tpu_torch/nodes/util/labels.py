"""Label encoding (counterpart of keystone_tpu/nodes/util/labels.py):
integer labels → ±1 indicators (+1 at the class, −1 elsewhere), the
regression targets of the least-squares classifiers."""

from __future__ import annotations

import torch

from keystone_tpu_torch.config import default_dtype
from keystone_tpu_torch.workflow import Transformer


class ClassLabelIndicators(Transformer):
    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes

    def signature(self):
        return self.stable_signature(self.num_classes)

    def apply_batch(self, y):
        y = y.to(torch.int64)
        onehot = torch.nn.functional.one_hot(y, self.num_classes).to(default_dtype)
        return 2.0 * onehot - 1.0
