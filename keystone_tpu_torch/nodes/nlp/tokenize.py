"""Text cleanup and tokenization, host stages (counterpart of
``keystone_tpu/nodes/nlp/tokenize.py``: ``Trim``, ``LowerCase`` and
``Tokenizer``, which splits on the reference's pattern ``[^\\w']+`` and
drops empty tokens)."""

from __future__ import annotations

import re
from typing import List

from keystone_tpu_torch.workflow import Transformer


class Trim(Transformer):
    host_stage = True

    def apply(self, x: str) -> str:
        return x.strip()


class LowerCase(Transformer):
    host_stage = True

    def apply(self, x: str) -> str:
        return x.lower()


class Tokenizer(Transformer):
    """Split on a regex (default: runs of non-word characters)."""

    host_stage = True

    def __init__(self, pattern: str = r"[^\w']+"):
        super().__init__()
        self.pattern = re.compile(pattern)

    def apply(self, x: str) -> List[str]:
        return [t for t in self.pattern.split(x) if t]
