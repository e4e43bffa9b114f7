"""N-grams of a token sequence, a host stage (counterpart of
``keystone_tpu/nodes/nlp/ngrams.py``): every n-gram for n in [min_n, max_n],
shorter n first, each in document order, joined by ``joiner``."""

from __future__ import annotations

from typing import List, Sequence

from keystone_tpu_torch.workflow import Transformer


class NGramsFeaturizer(Transformer):
    host_stage = True

    def __init__(self, min_n: int = 1, max_n: int = 2, joiner: str = " "):
        super().__init__()
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.min_n = min_n
        self.max_n = max_n
        self.joiner = joiner

    def apply(self, tokens: Sequence[str]) -> List[str]:
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(tokens) - n + 1):
                out.append(self.joiner.join(tokens[i : i + n]))
        return out
