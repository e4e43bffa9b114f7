"""Pascal VOC: JPEG images with multi-label XML annotations, or synthetic
multi-label images.

Counterpart of ``keystone_tpu/loaders/voc.py`` (``_decode_resize`` :29,
``VOCLoader.load`` :39, ``.synthetic`` :76), numpy and PIL only: the same
files and the same seed give the same arrays.

- ``load``: the sorted ``*.xml`` of ``annotation_dir``; each names its
  objects, and an object of a class in ``classes`` sets that class's
  entry of the image's (C,) 0/1 label row. The image is
  ``image_dir/<name>.jpg``, decoded to RGB, resized to ``size`` × ``size``
  with PIL's default filter and divided by 255 in float32, on a pool of
  ``decode_pool_workers(workers)`` threads.
- ``synthetic``: each image shows one or two of ``num_classes`` textured
  squares (an oriented grating per class) on faint noise; ``n`` training
  and ``max(n // 4, 64)`` test images.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled_data import LabeledData, decode_pool_workers
from keystone_tpu_torch.loaders.synthetic import with_label_noise

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _decode_resize(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size))
        return np.asarray(im, dtype=np.float32) / 255.0


class VOCLoader:
    # Present classes per synthetic image: one or two, uniformly.
    SYNTH_PRESENT_CLASSES_MEAN = 1.5

    @staticmethod
    def load(
        image_dir: str,
        annotation_dir: str,
        size: int = 128,
        workers: int = 16,
        classes: Sequence[str] = tuple(VOC_CLASSES),
    ) -> LabeledData:
        """LabeledData(NHWC images, (n, C) int32 0/1 labels)."""
        workers = decode_pool_workers(workers)
        index = {c: i for i, c in enumerate(classes)}
        names = sorted(f[:-4] for f in os.listdir(annotation_dir) if f.endswith(".xml"))
        labels = np.zeros((len(names), len(classes)), dtype=np.int32)
        paths: List[str] = []
        for i, name in enumerate(names):
            tree = ET.parse(os.path.join(annotation_dir, name + ".xml"))
            for obj in tree.findall(".//object/name"):
                ci = index.get(obj.text or "")
                if ci is not None:
                    labels[i, ci] = 1
            paths.append(os.path.join(image_dir, name + ".jpg"))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            images = list(pool.map(lambda p: _decode_resize(p, size), paths))
        return LabeledData(np.stack(images).astype(np.float32), labels)

    @staticmethod
    def synthetic(
        n: int = 256, num_classes: int = 6, size: int = 64, seed: int = 0
    ) -> Tuple[LabeledData, LabeledData]:
        yy, xx = np.mgrid[0:size, 0:size]
        textures = [
            0.5 + 0.5 * np.sin(2 * np.pi * ((c + 2) / 16.0) * (xx * np.cos(a) + yy * np.sin(a)))
            for c, a in zip(range(num_classes), np.linspace(0, np.pi, num_classes, endpoint=False))
        ]

        def make(count, off):
            r = np.random.default_rng(seed + off)
            X = 0.1 * r.uniform(size=(count, size, size, 3))
            Y = np.zeros((count, num_classes), dtype=np.int32)
            for i in range(count):
                present = r.choice(num_classes, size=r.integers(1, 3), replace=False)
                for c in present:
                    Y[i, c] = 1
                    s = size // 2
                    top = int(r.integers(0, size - s))
                    left = int(r.integers(0, size - s))
                    X[i, top : top + s, left : left + s, c % 3] += textures[c][top : top + s, left : left + s]
            Y = with_label_noise(Y, num_classes, r)
            return LabeledData(np.clip(X, 0, 1).astype(np.float32), Y)

        return make(n, 1), make(max(n // 4, 64), 2)
