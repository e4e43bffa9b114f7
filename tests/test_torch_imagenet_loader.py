"""The port's ImageNet loader held against the JAX package's, on the
committed fixtures (one synset as a ``.tar``, one as a directory, and the
label map), with PIL decode (``KEYSTONE_JPEG_BACKEND=pil``) unless a test
names another backend.

Everything is exact: the same bytes, labels and order from ``iter_jobs``,
and the same float32 arrays, bit for bit, from ``load``,
``load_balanced_sample`` and ``stream_batches``. A stream that its
consumer abandons, directly or through ``Transformer.apply_batches``,
leaves no thread of the port alive; a JPEG that does not decode raises in
the consumer. The backends, against the reference under the same
environment: ``native`` decodes in the port's libjpeg pool as the
reference's ``native`` does, bit for bit, and ``auto`` likewise where the
pool is built; ``auto`` hands a batch the pool fails on (a CMYK JPEG) to
PIL, as the reference's does, and counts it; with the port's build forced
to fail (and the reference's pool reported missing), ``native`` raises and
``auto`` decodes with PIL; an unknown backend raises.
"""

import gc
import os
import shutil
import threading
import time

import numpy as np
import pytest

from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.utils.metrics import ingest_counters
from keystone_tpu_torch.workflow import FusedTransformer

ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "data", "imagenet")
DATA = os.path.join(ROOT, "train")
SIZE = 32


@pytest.fixture(autouse=True)
def pil(monkeypatch):
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", "pil")


@pytest.fixture(scope="module")
def label_map():
    return ImageNetLoader.load_label_map(os.path.join(ROOT, "labels.txt"))


# Threads alive when the test started: another test file run by the same
# worker may have left its own.
_EARLIER: set = set()


@pytest.fixture(autouse=True)
def earlier_threads():
    _EARLIER.clear()
    _EARLIER.update(threading.enumerate())


def _port_threads():
    return [t.name for t in threading.enumerate() if "keystone" in t.name and t not in _EARLIER]


def _no_port_threads(timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while _port_threads() and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    return _port_threads() == []


def test_the_label_map_matches_the_reference(label_map):
    want = JImageNetLoader.load_label_map(os.path.join(ROOT, "labels.txt"))
    assert label_map == want == {"n01440764": 0, "n02102040": 1}


@pytest.mark.parametrize("kw", [{}, dict(limit=1), dict(limit=3), dict(shard=(0, 2)), dict(shard=(1, 2)),
                                dict(limit=1, shard=(1, 2)), dict(shard=(0, 1))],
                         ids=["all", "limit1", "limit3", "shard0of2", "shard1of2", "limit1-shard1of2", "shard0of1"])
def test_iter_jobs_matches_the_reference(label_map, kw):
    got = list(ImageNetLoader.iter_jobs(DATA, label_map, **kw))
    want = list(JImageNetLoader.iter_jobs(DATA, label_map, **kw))
    assert got == want
    assert got and all(isinstance(b, bytes) and b[:2] == b"\xff\xd8" for b, _ in got)


def test_iter_jobs_refuses_a_shard_out_of_range(label_map):
    for loader in (ImageNetLoader, JImageNetLoader):
        with pytest.raises(ValueError, match="shard index"):
            list(loader.iter_jobs(DATA, label_map, shard=(2, 2)))


def test_iter_jobs_skips_synsets_outside_the_label_map(label_map):
    only = {"n02102040": 1}
    got = list(ImageNetLoader.iter_jobs(DATA, only))
    assert got == list(JImageNetLoader.iter_jobs(DATA, only))
    assert [label for _, label in got] == [1, 1]


@pytest.mark.parametrize("kw", [{}, dict(limit=3), dict(shard=(1, 2))], ids=["all", "limit3", "shard1of2"])
def test_load_matches_the_reference_bit_for_bit(label_map, kw):
    got = ImageNetLoader.load(DATA, label_map, size=SIZE, **kw)
    want = JImageNetLoader.load(DATA, label_map, size=SIZE, **kw)
    assert got.data.dtype == np.float32 and got.labels.dtype == np.int32
    assert got.data.shape == want.data.shape and got.data.shape[1:] == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("total", [1, 2, 3, 5])
def test_load_balanced_sample_matches_the_reference(label_map, total):
    got = ImageNetLoader.load_balanced_sample(DATA, label_map, total, size=SIZE)
    want = JImageNetLoader.load_balanced_sample(DATA, label_map, total, size=SIZE)
    assert got.shape == want.shape == (min(total, 4), SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)


def test_fewer_samples_than_synsets_stride_over_the_synsets(tmp_path, label_map):
    """One sample from each of ``total`` synsets spread over the sorted list,
    not from its first synsets."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    jpeg = next(ImageNetLoader.iter_jobs(DATA, label_map))[0]
    names = [f"n{i:08d}" for i in range(6)]
    for name in names:
        os.makedirs(data / name)
        (data / name / "a.JPEG").write_bytes(jpeg)
    labels = {**label_map, **{name: 10 + i for i, name in enumerate(names)}}
    for total in (2, 3):
        got = ImageNetLoader.load_balanced_sample(str(data), labels, total, size=SIZE)
        np.testing.assert_array_equal(got, JImageNetLoader.load_balanced_sample(str(data), labels, total,
                                                                                 size=SIZE))


@pytest.mark.parametrize("batch_size", [1, 3])
def test_stream_batches_equal_load(label_map, batch_size):
    whole = ImageNetLoader.load(DATA, label_map, size=SIZE)
    got = list(ImageNetLoader.stream_batches(DATA, label_map, batch_size=batch_size, size=SIZE))
    want = list(JImageNetLoader.stream_batches(DATA, label_map, batch_size=batch_size, size=SIZE))
    assert [len(X) for X, _ in got] == [len(X) for X, _ in want] == [batch_size] * (4 // batch_size) + (
        [4 % batch_size] if 4 % batch_size else [])
    for (X, y), (WX, Wy) in zip(got, want):
        assert X.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(X, WX)
        np.testing.assert_array_equal(y, Wy)
    np.testing.assert_array_equal(np.concatenate([X for X, _ in got]), whole.data)
    np.testing.assert_array_equal(np.concatenate([y for _, y in got]), whole.labels)
    assert _no_port_threads()


@pytest.mark.parametrize("through", ["stream", "apply_batches"])
def test_an_abandoned_stream_stops_its_threads(label_map, through):
    assert _no_port_threads()
    stream = ImageNetLoader.stream_batches(DATA, label_map, batch_size=1, size=SIZE, prefetch=1)
    if through == "apply_batches":
        stream = FusedTransformer([]).apply_batches(stream, prefetch_depth=1, device="cpu")
    X, y = next(stream)
    assert X.shape == (1, SIZE, SIZE, 3) and len(y) == 1
    assert _port_threads(), "the producer is running"
    del stream
    assert _no_port_threads()


@pytest.mark.parametrize("through", ["stream", "apply_batches", "load"])
def test_a_corrupt_jpeg_raises_in_the_consumer(tmp_path, label_map, through):
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    (data / "n02102040" / "n02102040_1.JPEG").write_bytes(b"\xff\xd8 not a jpeg")
    if through == "load":
        with pytest.raises(OSError):
            ImageNetLoader.load(str(data), label_map, size=SIZE)
        return
    stream = ImageNetLoader.stream_batches(str(data), label_map, batch_size=1, size=SIZE)
    if through == "apply_batches":
        stream = FusedTransformer([]).apply_batches(stream, device="cpu")
    got = []
    with pytest.raises(OSError):
        for X, _ in stream:
            got.append(X)
    # The tar's two images and the directory's first; apply_batches takes
    # the next batch before it hands on the current one.
    assert len(got) == (3 if through == "stream" else 2)
    del stream
    assert _no_port_threads()


COMPILER_OUTPUT = "jpeg_pool.cpp:1:1: error: forced by the test"


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def broken_build(monkeypatch):
    """The port's library as if ``g++`` had failed, and the reference's
    decode pool reported missing: the same environment for both."""
    from keystone_tpu import native as jnative
    from keystone_tpu_torch import build, native

    def fail():
        raise RuntimeError(f"g++ failed for jpeg_pool.cpp (rc 1):\n{COMPILER_OUTPUT}")

    monkeypatch.setattr(build, "native_library", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_has_jpeg", False)
    monkeypatch.setattr(jnative, "jpeg_available", lambda: False)


def _load_both(backend, data=DATA, label_map=None, monkeypatch=None):
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", backend)
    got = ImageNetLoader.load(data, label_map, size=SIZE)
    want = JImageNetLoader.load(data, label_map, size=SIZE)
    return got, want


@pytest.mark.parametrize("backend, error", [("native", RuntimeError), ("turbo", ValueError)])
def test_a_backend_that_is_not_ported_raises(monkeypatch, broken_build, label_map, backend, error):
    """A backend that is not there raises: ``native`` where the library did
    not build (forced here; the message carries the compiler's output), and
    a name that is no backend."""
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", backend)
    with pytest.raises(error, match="KEYSTONE_JPEG_BACKEND") as raised:
        ImageNetLoader.load(DATA, label_map, size=SIZE)
    if backend == "native":
        assert COMPILER_OUTPUT in str(raised.value)
        with pytest.raises(RuntimeError, match="native jpeg pool unavailable"):
            JImageNetLoader.load(DATA, label_map, size=SIZE)
    with pytest.raises(error, match="KEYSTONE_JPEG_BACKEND"):
        next(ImageNetLoader.stream_batches(DATA, label_map, size=SIZE))
    assert _no_port_threads()


def test_auto_decodes_with_pil(monkeypatch, broken_build, label_map):
    """Where the pool is not built, ``auto`` decodes with PIL in both."""
    pil = ImageNetLoader.load(DATA, label_map, size=SIZE).data
    before = ingest_counters.snapshot()
    monkeypatch.delenv("KEYSTONE_JPEG_BACKEND")
    got = ImageNetLoader.load(DATA, label_map, size=SIZE).data
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, JImageNetLoader.load(DATA, label_map, size=SIZE).data)
    after = ingest_counters.snapshot()
    assert after.get("pil_batches", 0) > before.get("pil_batches", 0)
    assert after.get("pil_fallback_batches", 0) == before.get("pil_fallback_batches", 0)


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_native_decodes_as_the_reference(monkeypatch, label_map, backend):
    before = ingest_counters.get("native_batches")
    got, want = _load_both(backend, label_map=label_map, monkeypatch=monkeypatch)
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)
    assert ingest_counters.get("native_batches") > before
    # Bilinear resize of a DCT-scaled decode: other pixels than PIL's.
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", "pil")
    assert not np.array_equal(got.data, ImageNetLoader.load(DATA, label_map, size=SIZE).data)
    monkeypatch.setenv("KEYSTONE_JPEG_BACKEND", backend)
    streamed = np.concatenate([X for X, _ in ImageNetLoader.stream_batches(DATA, label_map, batch_size=2, size=SIZE)])
    _equal(streamed, got.data)


def test_auto_hands_what_the_pool_cannot_decode_to_pil(tmp_path, monkeypatch, label_map):
    from PIL import Image

    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    Image.new("CMYK", (40, 30), (10, 200, 30, 5)).save(data / "n02102040" / "n02102040_0.JPEG", format="JPEG")
    before = ingest_counters.get("pil_fallback_batches")
    got, want = _load_both("auto", str(data), label_map, monkeypatch)
    _equal(got.data, want.data)
    assert ingest_counters.get("pil_fallback_batches") == before + 1
    with pytest.raises(ValueError, match="jpeg decode failed"):
        _load_both("native", str(data), label_map, monkeypatch)


def test_labeled_data_keeps_its_old_import_path():
    from keystone_tpu_torch.loaders.imagenet import LabeledData as Old
    from keystone_tpu_torch.loaders.labeled_data import LabeledData

    assert Old is LabeledData
    data, labels = LabeledData(np.zeros((2, 1)), np.arange(2))
    assert labels.tolist() == [0, 1]


def test_stream_batches_feed_batch_iterators(label_map):
    """A real-data stream and ``BatchIterator.from_arrays`` of the loaded
    arrays give ``apply_batches`` the same batches."""
    whole = ImageNetLoader.load(DATA, label_map, size=SIZE)
    a = [(X.numpy(), y) for X, y in FusedTransformer([]).apply_batches(
        ImageNetLoader.stream_batches(DATA, label_map, batch_size=3, size=SIZE), device="cpu")]
    b = [(X.numpy(), y) for X, y in FusedTransformer([]).apply_batches(
        BatchIterator.from_arrays(whole.data, whole.labels, 3), device="cpu")]
    for (X, y), (WX, Wy) in zip(a, b, strict=True):
        np.testing.assert_array_equal(X, WX)
        np.testing.assert_array_equal(y, Wy)
