"""Term-frequency weighting, a host stage (counterpart of
``keystone_tpu/nodes/nlp/term_frequency.py``): a document's terms →
{term: fn(count)}, terms in first-seen order (``Counter``'s), with the
named weightings ``identity`` (c) and ``log`` (log(c + 1)) or a callable."""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, Sequence

from keystone_tpu_torch.workflow import Transformer


def _identity(c: float) -> float:
    return c


def _log1p(c: float) -> float:
    return math.log(c + 1.0)


WEIGHTINGS: Dict[str, Callable[[float], float]] = {"identity": _identity, "log": _log1p}


class TermFrequency(Transformer):
    host_stage = True

    def __init__(self, fn: str | Callable[[float], float] = "identity"):
        super().__init__()
        if isinstance(fn, str) and fn in WEIGHTINGS:
            self.fn = WEIGHTINGS[fn]
        elif callable(fn):
            self.fn = fn
        else:
            raise ValueError(f"unknown weighting {fn!r}")

    def apply(self, tokens: Sequence[str]) -> Dict[str, float]:
        return {t: self.fn(c) for t, c in Counter(tokens).items()}
