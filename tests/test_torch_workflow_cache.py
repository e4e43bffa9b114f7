"""The port's fingerprints and caches (``workflow/fingerprint.py``,
``workflow/disk_cache.py``, the executor's session and disk fit caches)
held against the JAX package on the CPU.

- ``array_fingerprint`` and ``digest_tree`` of the same numpy data are
  equal in both packages, in full and sampled past
  ``fingerprint_max_bytes``; a tensor digests as its numpy bytes, and its
  memoized fingerprint follows in-place writes.
- The disk fit cache (after ``tests/test_disk_cache.py``): a second
  session hits, a corrupt, tampered or foreign-class entry is refused and
  refitted, gadget callables (``os.system``, ``numpy.load``,
  ``functools.partial``, ``torch.load`` through a storage) never run, a
  fitted module's tensors round-trip bit for bit, and the walk cuts at a
  cached estimator's prefix.
- The reduced ImageNet fit run twice with a cache directory: the rerun
  makes 0 estimator fits, hits ``fit_fisher_featurizer``'s entries and
  gives the same bits.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from keystone_tpu.config import config as jconfig
from keystone_tpu.workflow import fingerprint as jfp
from keystone_tpu_torch.config import config
from keystone_tpu_torch.workflow import LabelEstimator, PipelineEnv, Transformer, on_device
from keystone_tpu_torch.workflow import fingerprint as pfp
from keystone_tpu_torch.workflow.disk_cache import DiskFitCache
from keystone_tpu_torch.workflow.graph import structural_digest


@pytest.fixture(autouse=True)
def _fresh_env(monkeypatch):
    monkeypatch.setattr(config, "exec_workers", 0)
    monkeypatch.delenv("KEYSTONE_EXEC_WORKERS", raising=False)
    monkeypatch.delenv("KEYSTONE_CACHE_DIR", raising=False)
    monkeypatch.delenv("KEYSTONE_CACHE_TRUST_ALL", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    PipelineEnv.reset()
    with on_device("cpu"):
        yield
    PipelineEnv.reset()
    torch.set_num_threads(threads)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "float32 matrix": rng.normal(size=(64, 33)).astype(np.float32),
        "float64 vector": rng.normal(size=1000),
        "int64 labels": rng.integers(0, 9, size=500),
        "uint8 images": rng.integers(0, 255, size=(7, 16, 16, 3)).astype(np.uint8),
        "bool mask": rng.uniform(size=(40, 9)) < 0.5,
        "scalar rows": np.arange(3, dtype=np.int32),
    }


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("name", list(_arrays()))
def test_array_fingerprint_equals_the_reference_and_a_tensor_digests_as_its_bytes(name, sampled, monkeypatch):
    a = _arrays()[name]
    if sampled:  # both packages sample past the same limit
        monkeypatch.setattr(config, "fingerprint_max_bytes", 256)
        monkeypatch.setattr(jconfig, "fingerprint_max_bytes", 256)
    want = jfp.array_fingerprint(a)
    assert pfp.array_fingerprint(a) == want
    assert pfp.array_fingerprint(torch.from_numpy(a)) == want
    assert want[0] == ("ndarray-sampled" if sampled and a.nbytes > 256 else "ndarray")


def test_a_strided_tensor_digests_as_its_logical_values(monkeypatch):
    a = np.random.default_rng(1).normal(size=(50, 40)).astype(np.float32)
    t = torch.from_numpy(a).T  # not contiguous
    assert pfp.array_fingerprint(t) == jfp.array_fingerprint(np.ascontiguousarray(a.T))
    monkeypatch.setattr(config, "fingerprint_max_bytes", 100)
    monkeypatch.setattr(jconfig, "fingerprint_max_bytes", 100)
    assert pfp.array_fingerprint(t) == jfp.array_fingerprint(a.T)


def test_a_tensor_fingerprint_follows_in_place_writes():
    t = torch.zeros(10, 3)
    before = pfp.array_fingerprint(t)
    assert pfp.array_fingerprint(t) is before  # memoized
    t[0, 0] = 1.0
    after = pfp.array_fingerprint(t)
    assert after != before and after == jfp.array_fingerprint(t.numpy())


def _trees():
    rng = np.random.default_rng(2)
    return {
        "primitives": ("est", 1, 2.5, "x", None, True, b"raw"),
        "nested": (("a", (1, 2)), ("b", ("c", 3.0))),
        "with array": ("w", rng.normal(size=(5, 4)).astype(np.float32)),
        "stable dict": ("d", pfp.stable_value({"lam": 0.1, "k": 3})),
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_digest_tree_equals_the_reference(name):
    tree = _trees()[name]
    if name == "stable dict":
        jtree = ("d", jfp.stable_value({"lam": 0.1, "k": 3}))
    else:
        jtree = tree
    assert pfp.digest_tree(tree) == jfp.digest_tree(jtree) is not None


def test_unstable_values_poison_the_digest():
    class Opaque:
        pass

    assert pfp.digest_tree(("x", pfp.stable_value(Opaque()))) is None
    assert pfp.stable_value(torch.device("cpu")) == ("torch", "device", "cpu")
    assert pfp.digest_tree(pfp.stable_value({"device": torch.device("cuda", 0)})) is not None


# --- the disk fit cache -----------------------------------------------------------


class Scale(Transformer):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.as_tensor(w))

    def signature(self):
        return self.stable_signature(pfp.array_fingerprint(self.w))

    def apply_batch(self, X):
        return X * self.w


class CountingEstimator(LabelEstimator):
    fits = 0

    def __init__(self, lam: float):
        self.lam = lam

    def fit(self, data, labels):
        CountingEstimator.fits += 1
        return Scale(torch.as_tensor(labels).float().mean() / (torch.as_tensor(data).mean() + self.lam))


class Doubling(Transformer):
    calls = 0

    def signature(self):
        return self.stable_signature()

    def apply_batch(self, X):
        Doubling.calls += 1
        return X * 2.0


def _data():
    rng = np.random.default_rng(4)
    return rng.normal(size=(20, 3)).astype(np.float32), rng.normal(size=(20, 1)).astype(np.float32)


def _session(cache_dir, monkeypatch):
    monkeypatch.setenv("KEYSTONE_CACHE_DIR", str(cache_dir))
    PipelineEnv.reset(device="cpu")
    return PipelineEnv.get()


def test_a_second_session_hits_the_disk(tmp_path, monkeypatch):
    X, Y = _data()
    CountingEstimator.fits = 0
    _session(tmp_path, monkeypatch)
    first = CountingEstimator(1e-3).with_data(X.copy(), Y.copy()).fit()(X).get()
    assert CountingEstimator.fits == 1 and any(f.endswith(".fit.pkl") for f in os.listdir(tmp_path))
    _session(tmp_path, monkeypatch)  # a new process, as far as session state goes
    again = CountingEstimator(1e-3).with_data(X.copy(), Y.copy()).fit()(X).get()
    assert CountingEstimator.fits == 1 and torch.equal(first, again)
    _session(tmp_path, monkeypatch)
    CountingEstimator(2e-3).with_data(X.copy(), Y.copy()).fit()
    assert CountingEstimator.fits == 2  # another hyperparameter, another key


def test_the_walk_cuts_at_a_cached_prefix(tmp_path, monkeypatch):
    """A disk hit makes the estimator a leaf: its prefix (the Doubling
    stage over the fit data) is not run again."""
    X, Y = _data()
    _session(tmp_path, monkeypatch)
    Doubling.calls = 0
    Doubling().and_then(CountingEstimator(1e-3), X, Y).fit()
    assert Doubling.calls == 1
    _session(tmp_path, monkeypatch)
    Doubling().and_then(CountingEstimator(1e-3), X.copy(), Y.copy()).fit()
    assert Doubling.calls == 1


@pytest.mark.parametrize("damage", ["truncated", "garbage"])
def test_a_corrupt_entry_is_a_miss_and_refits(damage, tmp_path, monkeypatch):
    X, Y = _data()
    CountingEstimator.fits = 0
    _session(tmp_path, monkeypatch)
    CountingEstimator(1e-3).with_data(X, Y).fit()
    (entry,) = [f for f in os.listdir(tmp_path) if f.endswith(".fit.pkl")]
    path = tmp_path / entry
    path.write_bytes(path.read_bytes()[:20] if damage == "truncated" else b"corrupt")
    _session(tmp_path, monkeypatch)
    CountingEstimator(1e-3).with_data(X, Y).fit()
    assert CountingEstimator.fits == 2


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned > /dev/null",))


class _NumpyLoad:
    def __reduce__(self):
        return (np.load, ("/nonexistent.npy",))


class _Partial:
    def __reduce__(self):
        import functools

        return (functools.partial, (print,))


class _TorchLoad:
    """PyTorch's own tensor pickling: a storage rebuilt through torch.load."""

    def __reduce__(self):
        return torch.zeros(2).__reduce_ex__(2)


class _Popen:
    def __reduce__(self):
        import subprocess

        return (subprocess.Popen, (["true"],))


@pytest.mark.parametrize("evil", [_Evil, _NumpyLoad, _Partial, _TorchLoad, _Popen])
def test_a_planted_entry_is_refused_and_dropped(evil, tmp_path):
    cache = DiskFitCache(str(tmp_path / "store"))
    path = cache._path("planted")
    with open(path, "wb") as f:
        pickle.dump(evil(), f, protocol=4)
    assert cache.get("planted") is None
    assert not os.path.exists(path)


def test_an_unimported_module_is_never_imported_by_a_read(tmp_path):
    victim = "antigravity"
    cache = DiskFitCache(str(tmp_path / "store"))
    with open(cache._path("k"), "wb") as f:
        f.write(b"\x80\x04c" + victim.encode() + b"\nfly\n.")
    assert cache.get("k") is None and victim not in sys.modules


def _modules():
    from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLinearMapper
    from keystone_tpu_torch.nodes.learning.pca import PCATransformer
    from keystone_tpu_torch.workflow import FusedTransformer

    rng = np.random.default_rng(5)
    pca = PCATransformer(rng.normal(size=(6, 3)).astype(np.float32), rng.normal(size=6).astype(np.float32),
                         device="cpu")
    fv = FisherVector(np.full(2, 0.5, np.float32), rng.normal(size=(2, 3)).astype(np.float32),
                      np.ones((2, 3), np.float32), device="cpu")
    head = BlockLinearMapper(rng.normal(size=(8, 2)).astype(np.float32), [(0, 4), (4, 8)],
                             rng.normal(size=2).astype(np.float32), device="cpu")
    return {"pca": pca, "fisher vector": fv, "head": head,
            "fused chain": FusedTransformer([pca, Scale(torch.tensor(2.0, dtype=torch.bfloat16))])}


@pytest.mark.parametrize("name", ["pca", "fisher vector", "head", "fused chain"])
def test_a_fitted_module_round_trips_bit_for_bit(name, tmp_path):
    module = _modules()[name]
    cache = DiskFitCache(str(tmp_path / "store"))
    cache.put("k", (module, {"note": [1, 2]}))
    back, extra = cache.get("k")
    assert type(back) is type(module) and extra == {"note": [1, 2]}
    want, got = module.state_dict(), back.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key])


def test_entries_hold_tensors_as_numpy(tmp_path):
    cache = DiskFitCache(str(tmp_path / "store"))
    cache.put("k", torch.arange(4.0))
    raw = open(cache._path("k"), "rb").read()
    assert b"_tensor_from_numpy" in raw and b"_rebuild_tensor" not in raw
    assert torch.equal(cache.get("k"), torch.arange(4.0))


def test_structural_digests_are_content_stable():
    from keystone_tpu_torch.nodes.images.pixels import GrayScaler
    from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer

    def build():
        return GrayScaler().and_then(L2Normalizer())

    a, b = build(), build()
    da = structural_digest(a.graph, a.sink, source_token="in")
    assert da is not None and da == structural_digest(b.graph, b.sink, source_token="in")
    assert structural_digest(a.graph, a.sink) is None  # a free source has no content
    c = Doubling().and_then(Transformer())  # an id-keyed node
    assert structural_digest(c.graph, c.sink, source_token="in") is None


def test_reduced_imagenet_fit_reruns_from_the_disk_cache(tmp_path, monkeypatch):
    """The reduced fit twice: the rerun fits nothing, reads the two branch
    entries of ``fit_fisher_featurizer`` and the head's, and gives the
    same parameters and scores bit for bit."""
    from unittest.mock import patch

    from keystone_tpu_torch.convert import params_to_numpy
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.nodes.images.external.fisher_vector import GMMFisherVectorEstimator
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.pca import PCAEstimator
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port

    conf = port.resolve_scale(port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, synthetic_n=64,
                                                           synthetic_classes=8))
    train, test = ImageNetLoader.synthetic(n=64, num_classes=8, size=32, seed=0)
    fits, hits = [], []
    real_get = DiskFitCache.get

    def get(self, key):
        value = real_get(self, key)
        hits.append(value is not None)
        return value

    def counted(cls):
        real = cls.fit

        def fit(self, *args):
            fits.append(cls.__name__)
            return real(self, *args)
        return fit

    runs = []
    with patch.object(DiskFitCache, "get", get), \
            patch.object(PCAEstimator, "fit", counted(PCAEstimator)), \
            patch.object(GMMFisherVectorEstimator, "fit", counted(GMMFisherVectorEstimator)), \
            patch.object(BlockWeightedLeastSquaresEstimator, "fit", counted(BlockWeightedLeastSquaresEstimator)):
        for _ in range(2):
            _session(tmp_path, monkeypatch)
            fits.clear()
            hits.clear()
            scored = port.fit(conf, train, 8, device="cpu")
            with on_device("cpu"):
                scores = scored(test.data).get().numpy()
            runs.append((list(fits), list(hits), params_to_numpy(scored), scores))
    (f1, h1, p1, s1), (f2, h2, p2, s2) = runs
    assert len(f1) == 5 and h1 == [False] * 3
    assert f2 == [] and h2 == [True] * 3
    assert all(np.array_equal(p1[k], p2[k]) for k in p1) and np.array_equal(s1, s2)
