"""20 Newsgroups (counterpart of ``keystone_tpu/loaders/newsgroups.py``):
``load`` reads a directory per class of text files; ``synthetic`` makes
the reference's topic-mixture corpus with its numpy generators, so the
same seed gives the same documents."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData
from keystone_tpu_torch.loaders.synthetic import with_label_noise

# Class-specific vocabulary of the synthetic corpus.
_TOPICS = [
    ["space", "orbit", "rocket", "nasa", "launch", "moon", "satellite"],
    ["hockey", "goal", "puck", "team", "season", "playoff", "skate"],
    ["windows", "driver", "file", "disk", "program", "install", "boot"],
    ["car", "engine", "dealer", "mileage", "brake", "tire", "drive"],
    ["god", "faith", "church", "belief", "scripture", "moral", "prayer"],
]
_COMMON = ["the", "a", "of", "to", "and", "in", "is", "that", "it", "for"]


class NewsgroupsDataLoader:
    @staticmethod
    def load(path: str, classes: List[str] | None = None) -> Tuple[LabeledData, List[str]]:
        """``path/<group>/<files>`` → (LabeledData(texts, int32 labels),
        class names). Pass the training split's ``classes`` when loading a
        test split so that the label indices align; a subdirectory not in
        them raises."""
        found = sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))
        if classes is None:
            classes = found
        else:
            unknown = set(found) - set(classes)
            if unknown:
                raise ValueError(
                    f"{path} has classes {sorted(unknown)} not present in the "
                    f"training class list {classes}"
                )
        index = {c: i for i, c in enumerate(classes)}
        texts: List[str] = []
        labels: List[int] = []
        for cls in found:
            cdir = os.path.join(path, cls)
            for fname in sorted(os.listdir(cdir)):
                fpath = os.path.join(cdir, fname)
                if os.path.isfile(fpath):
                    with open(fpath, errors="replace") as f:
                        texts.append(f.read())
                    labels.append(index[cls])
        return LabeledData(texts, np.asarray(labels, dtype=np.int32)), list(classes)

    @staticmethod
    def synthetic(n: int = 1000, num_classes: int = 5, seed: int = 0
                  ) -> Tuple[LabeledData, LabeledData, List[str]]:
        """(train of n documents, test of max(n // 4, 100), class names)."""
        num_classes = min(num_classes, len(_TOPICS))

        def make(count, off):
            r = np.random.default_rng(seed + off)
            texts, labels = [], []
            for _ in range(count):
                c = int(r.integers(0, num_classes))
                words = list(r.choice(_TOPICS[c], size=r.integers(8, 20))) + list(
                    r.choice(_COMMON, size=r.integers(10, 25))
                )
                r.shuffle(words)
                texts.append(" ".join(words))
                labels.append(c)
            labels = with_label_noise(np.asarray(labels, dtype=np.int32), num_classes, r)
            return LabeledData(texts, labels)

        names = [t[0] for t in _TOPICS[:num_classes]]
        return make(n, 1), make(max(n // 4, 100), 2), names
