"""Amazon reviews (counterpart of ``keystone_tpu/loaders/amazon.py``):
``load`` reads JSON lines (``reviewText``, ``overall``) or CSV rows (text,
stars), a review positive when its stars exceed 3.5; ``synthetic`` makes
the reference's polarity corpus with its numpy generators, so the same
seed gives the same reviews."""

from __future__ import annotations

import csv
import json
from typing import Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.synthetic import with_label_noise

_POS = ["great", "excellent", "love", "perfect", "best", "amazing", "works"]
_NEG = ["terrible", "broke", "waste", "refund", "awful", "disappointed", "poor"]
_FILLER = ["the", "product", "i", "it", "this", "was", "and", "my", "to", "use"]


class AmazonReviewsDataLoader:
    THRESHOLD = 3.5

    @staticmethod
    def load(path: str) -> LabeledData:
        """JSON lines (``.json``/``.jsonl``) or CSV (text, stars)."""
        texts, stars = [], []
        with open(path, errors="replace") as f:
            if path.endswith(".json") or path.endswith(".jsonl"):
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    texts.append(rec["reviewText"])
                    stars.append(float(rec["overall"]))
            else:
                for row in csv.reader(f):
                    if len(row) < 2:
                        continue
                    texts.append(row[0])
                    stars.append(float(row[1]))
        labels = [1 if s > AmazonReviewsDataLoader.THRESHOLD else 0 for s in stars]
        return LabeledData(texts, np.asarray(labels, dtype=np.int32))

    @staticmethod
    def synthetic(n: int = 1000, seed: int = 0) -> Tuple[LabeledData, LabeledData]:
        """(train of n reviews, test of max(n // 4, 100))."""

        def make(count, off):
            r = np.random.default_rng(seed + off)
            texts, labels = [], []
            for _ in range(count):
                pos = bool(r.integers(0, 2))
                vocab = _POS if pos else _NEG
                words = list(r.choice(vocab, size=r.integers(3, 8))) + list(
                    r.choice(_FILLER, size=r.integers(8, 16))
                )
                # A little label noise through cross-polarity words.
                if r.uniform() < 0.3:
                    words += list(r.choice(_NEG if pos else _POS, size=1))
                r.shuffle(words)
                texts.append(" ".join(words))
                labels.append(1 if pos else 0)
            labels = with_label_noise(np.asarray(labels, dtype=np.int32), 2, r)
            return LabeledData(texts, labels)

        return make(n, 1), make(max(n // 4, 100), 2)
