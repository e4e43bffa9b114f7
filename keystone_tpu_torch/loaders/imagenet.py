"""ImageNet images: per-synset tars or directories of JPEGs with a label
map, and synthetic class-textured images.

Counterpart of ``keystone_tpu/loaders/imagenet.py``:

- ``load_label_map`` (``:62-71``): lines of ``<synset> <label>``;
- ``iter_jobs`` (``:73-122``): (JPEG bytes, label) in walk order. The
  sorted entries of ``data_path`` are ``<synset>.tar`` archives, read
  member by member as the archive streams, or ``<synset>/`` directories,
  read in sorted file order; a synset missing from the label map is
  skipped. ``limit`` stops after that many images, and ``shard=(h, H)``
  walks entries h, h+H, h+2H, ... only;
- ``load`` (``:124-144``), the whole walk decoded; ``load_balanced_sample``
  (``:146-178``), a few images from each synset, or from ``total`` synsets
  spread over the sorted list when there are fewer samples than synsets;
  ``stream_batches`` (``:180-275``), the walk decoded in batches on a
  producer thread, up to ``prefetch`` batches ahead;
- ``synthetic``: a numpy-only copy of the reference's, without its
  optional label noise (an environment variable its acceptance harness
  sets); with it off, as by default, the two give the same arrays.

Decoding is the reference's ``_decode`` (``:27-32``) exactly: RGB, resized
to ``size`` × ``size`` with PIL's default filter, divided by 255 in
float32, one image per task of a pool of ``decode_pool_workers`` threads.
``KEYSTONE_JPEG_BACKEND`` is read at each batch, with the reference's
meaning (``:35-55``): ``pil`` decodes with PIL; ``native`` in the port's
libjpeg pool (``native.decode_jpeg_batch``: DCT-scaled decode and a
bilinear resize, so other pixels than PIL's), or raises where the pool is
not built; ``auto`` (the default) in the pool where it is built, else with
PIL. ``auto`` hands a batch to PIL only when the pool fails on one of its
images (libjpeg does not convert CMYK, for one), and counts each such batch
in ``utils/metrics.py::ingest_counters`` (``pil_fallback_batches``). Any
other value raises.

``stream_batches`` runs its producer on a ``loaders/stream.py``
``PrefetchIterator``: a decode error is raised again at the consumer, and
a consumer that closes or drops the generator stops the producer thread
and shuts the decode pool down.
"""

from __future__ import annotations

import io
import os
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from keystone_tpu_torch import native
from keystone_tpu_torch.loaders.labeled_data import LabeledData, decode_pool_workers
from keystone_tpu_torch.loaders.stream import PrefetchIterator
from keystone_tpu_torch.utils.metrics import ingest_counters

__all__ = ["ImageNetLoader", "LabeledData"]


def _decode(buf: bytes, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(buf)) as im:
        im = im.convert("RGB").resize((size, size))
        return np.asarray(im, dtype=np.float32) / 255.0


def _decode_batch(bufs, size: int, pool) -> np.ndarray:
    """(n, size, size, 3) float32 images of the JPEG buffers ``bufs``."""
    backend = os.environ.get("KEYSTONE_JPEG_BACKEND", "auto")
    if backend not in ("auto", "pil", "native"):
        raise ValueError(f"KEYSTONE_JPEG_BACKEND={backend!r}: expected auto, pil or native")
    if backend != "pil":
        if native.jpeg_available():
            try:
                images = native.decode_jpeg_batch(list(bufs), size)
            except ValueError:
                if backend == "native":
                    raise
                ingest_counters.bump("pil_fallback_batches")
            else:
                ingest_counters.bump("native_batches")
                return images
        elif backend == "native":
            raise RuntimeError(
                "KEYSTONE_JPEG_BACKEND=native: the native jpeg pool is unavailable: "
                f"{native.build_error() or 'the library was built without libjpeg'}"
            )
    ingest_counters.bump("pil_batches")
    return np.stack(list(pool.map(lambda b: _decode(b, size), bufs)))


def _pool(workers: Optional[int]) -> ThreadPoolExecutor:
    return ThreadPoolExecutor(
        max_workers=decode_pool_workers(workers), thread_name_prefix="keystone-decode"
    )


def _synset(entry: str) -> str:
    return entry[:-4] if entry.endswith(".tar") else entry


def _jobs(data_path: str, entries: List[str], label_map: Dict[str, int],
          limit: Optional[int]) -> Iterator[Tuple[bytes, int]]:
    """(JPEG bytes, label) of ``entries`` of ``data_path``, in order."""
    count = 0
    for entry in entries:
        label = label_map.get(_synset(entry))
        if label is None:
            continue
        full = os.path.join(data_path, entry)
        if entry.endswith(".tar"):
            with tarfile.open(full) as tf:
                # The TarFile itself, not getmembers(): members come as the
                # archive is read, so a consumer with a limit does not wait
                # for a scan of the whole archive.
                for member in tf:
                    if member.isfile():
                        f = tf.extractfile(member)
                        if f is not None:
                            yield f.read(), label
                            count += 1
                            if limit is not None and count >= limit:
                                return
        elif os.path.isdir(full):
            for fname in sorted(os.listdir(full)):
                with open(os.path.join(full, fname), "rb") as f:
                    yield f.read(), label
                count += 1
                if limit is not None and count >= limit:
                    return


class ImageNetLoader:
    @staticmethod
    def load_label_map(path: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    out[parts[0]] = int(parts[1])
        return out

    @staticmethod
    def iter_jobs(
        data_path: str,
        label_map: Dict[str, int],
        limit: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
    ) -> Iterator[Tuple[bytes, int]]:
        entries = sorted(os.listdir(data_path))
        if shard is not None:
            h, num_hosts = shard
            if not 0 <= h < num_hosts:
                raise ValueError(f"shard index {h} not in [0, {num_hosts})")
            entries = entries[h::num_hosts]
        yield from _jobs(data_path, entries, label_map, limit)

    @staticmethod
    def load(
        data_path: str,
        label_map: Dict[str, int],
        size: int = 256,
        workers: Optional[int] = None,
        limit: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
    ) -> LabeledData:
        jobs: List[Tuple[bytes, int]] = list(ImageNetLoader.iter_jobs(data_path, label_map, limit, shard))
        with _pool(workers) as pool:
            images = _decode_batch([b for b, _ in jobs], size, pool)
        return LabeledData(images, np.asarray([label for _, label in jobs], dtype=np.int32))

    @staticmethod
    def load_balanced_sample(
        data_path: str,
        label_map: Dict[str, int],
        total: int,
        size: int = 256,
        workers: Optional[int] = None,
    ) -> np.ndarray:
        # One listing of data_path, its entries grouped by synset: the walk
        # of iter_jobs(data_path, {synset: label}, limit=per) for each
        # synset, without listing the directory again for every synset.
        listing = sorted(os.listdir(data_path))
        groups: Dict[str, List[str]] = {}
        for e in listing:
            groups.setdefault(_synset(e), []).append(e)
        entries = [e for e in listing if _synset(e) in label_map]
        if len(entries) > total > 0:
            # Fewer samples than synsets: spread over the whole sorted list
            # rather than stop at a prefix of it.
            stride = len(entries) / total
            entries = [entries[int(i * stride)] for i in range(total)]
        per = max(1, -(-total // max(len(entries), 1)))
        bufs: List[bytes] = []
        for entry in entries:
            synset = _synset(entry)
            for buf, _ in _jobs(data_path, groups[synset], {synset: label_map[synset]}, per):
                bufs.append(buf)
            if len(bufs) >= total:
                break
        with _pool(workers) as pool:
            return _decode_batch(bufs[:total], size, pool)

    @staticmethod
    def stream_batches(
        data_path: str,
        label_map: Dict[str, int],
        batch_size: int = 256,
        size: int = 256,
        workers: Optional[int] = None,
        limit: Optional[int] = None,
        prefetch: int = 2,
        shard: Optional[Tuple[int, int]] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images, int32 labels) batches of ``batch_size`` (the last one
        shorter) in walk order, the same arrays as ``load``'s."""

        def decoded():
            with _pool(workers) as pool:
                bufs: List[bytes] = []
                labels: List[int] = []
                for buf, label in ImageNetLoader.iter_jobs(data_path, label_map, limit, shard):
                    bufs.append(buf)
                    labels.append(label)
                    if len(bufs) == batch_size:
                        yield _decode_batch(bufs, size, pool), np.asarray(labels, dtype=np.int32)
                        bufs, labels = [], []
                if bufs:
                    yield _decode_batch(bufs, size, pool), np.asarray(labels, dtype=np.int32)

        with PrefetchIterator(decoded(), max(prefetch, 1)) as batches:
            yield from batches

    @staticmethod
    def synthetic(
        n: int = 512, num_classes: int = 16, size: int = 64, seed: int = 0
    ) -> Tuple[LabeledData, LabeledData]:
        yy, xx = np.mgrid[0:size, 0:size]
        angles = np.linspace(0, np.pi, num_classes, endpoint=False)
        freqs = 2 + (np.arange(num_classes) % 8)
        textures = np.stack(
            [
                0.5
                + 0.5
                * np.sin(
                    2 * np.pi * freqs[c] / size
                    * (xx * np.cos(angles[c]) + yy * np.sin(angles[c]))
                )
                for c in range(num_classes)
            ]
        )

        def make(count, off):
            r = np.random.default_rng(seed + off)
            y = r.integers(0, num_classes, size=count)
            base = textures[y][..., None]  # (count, size, size, 1)
            tint = 0.5 + 0.5 * r.uniform(size=(count, 1, 1, 3))
            X = base * tint + 0.15 * r.normal(size=(count, size, size, 3))
            return LabeledData(
                np.clip(X, 0, 1).astype(np.float32), y.astype(np.int32)
            )

        return make(n, 1), make(max(n // 4, 128), 2)
