"""TimitPipeline and its parts in the port, held against the JAX package on
the CPU.

- Loaders (the ``.npz`` fixture under ``tests/fixtures/data/timit``, CSV,
  synthetic with and without label noise): the same arrays, bit for bit.
- ``StandardScaler``: means and standard deviations (``ddof=1``, floored
  at ``eps``) within rtol 1e-5, atol 1e-6, float32 column sums in another
  order; the scaled rows likewise.
- ``CosineRandomFeatures`` with the reference's W and b carried across
  (``convert.py``), Gaussian and Cauchy: cos of the same float32 product,
  within atol 1e-5 (|X W| up to about 30 at these widths, so the product's
  rounding is near 1e-6). The port's own draw: the distribution's
  location and spread, deterministic per seed.
- ``run`` at 2,048 frames and 1,024 features (Gaussian and Cauchy) with the
  reference's W and b carried across: test accuracy and macro-F1 within 0.01 of the
  reference's ``run``; on the 12-frame fixture (147 phone states, the
  training frames scored as the test split) the same phone error rate,
  within one frame (1/12); the head solved streamed from the host (the
  memory budget patched small) predicts as the eager solve does.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.timit import TimitFeaturesDataLoader as JTimitFeaturesDataLoader
from keystone_tpu.nodes.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.nodes.stats import StandardScaler as JStandardScaler
from keystone_tpu.pipelines.speech import timit as j_timit
from keystone_tpu_torch.convert import random_features_from_numpy, standard_scaler_from_numpy
from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
from keystone_tpu_torch.nodes.learning import block_least_squares
from keystone_tpu_torch.nodes.stats.random_features import CosineRandomFeatures
from keystone_tpu_torch.nodes.stats.scalers import StandardScaler
from keystone_tpu_torch.pipelines.speech import timit
from keystone_tpu_torch.utils.stages import StageTimer

TIMIT_FIXTURE = "tests/fixtures/data/timit/frames.npz"
SCALER_TOL = dict(rtol=1e-5, atol=1e-6)
RF_ATOL = 1e-5
METRIC_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _ref(node, X) -> np.ndarray:
    out = node(X)
    return np.asarray(out.get() if hasattr(out, "get") else out)


# --- loaders ---------------------------------------------------------------


def test_npz_fixture_loads_bit_equal():
    got, want = TimitFeaturesDataLoader.load(TIMIT_FIXTURE), JTimitFeaturesDataLoader.load(TIMIT_FIXTURE)
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)
    assert TimitFeaturesDataLoader.NUM_PHONES == JTimitFeaturesDataLoader.NUM_PHONES == 147


def test_csv_loads_bit_equal(tmp_path, rng):
    feats, labels = str(tmp_path / "f.csv"), str(tmp_path / "y.txt")
    np.savetxt(feats, rng.normal(size=(9, 6)), delimiter=",")
    np.savetxt(labels, rng.integers(0, 5, size=9), fmt="%d")
    got, want = TimitFeaturesDataLoader.load(feats, labels), JTimitFeaturesDataLoader.load(feats, labels)
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)
    with pytest.raises(ValueError, match="labels_path required"):
        TimitFeaturesDataLoader.load(feats)


@pytest.mark.parametrize("noise", ["", "0.2"])
def test_synthetic_bit_equal(monkeypatch, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    kw = dict(n=300, num_phones=8, frame_dim=10, context=2, seed=4)
    for got, want in zip(TimitFeaturesDataLoader.synthetic(**kw), JTimitFeaturesDataLoader.synthetic(**kw)):
        _equal(got.data, want.data)
        _equal(got.labels, want.labels)
    train, test = TimitFeaturesDataLoader.synthetic(n=64)
    assert train.data.shape == (64, 440) and test.data.shape == (256, 440)


# --- nodes -----------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_standard_scaler(rng, normalize):
    X = (rng.normal(size=(200, 30)) * rng.uniform(0.1, 10, size=30) + 5).astype(np.float32)
    X[:, 3] = 2.0  # a constant column: its std is floored at eps
    model = StandardScaler(normalize_std_dev=normalize, device="cpu").fit(X)
    jmodel = JStandardScaler(normalize_std_dev=normalize).fit(X)
    np.testing.assert_allclose(model.mean.numpy(), np.asarray(jmodel.mean), **SCALER_TOL)
    if normalize:
        np.testing.assert_allclose(model.std.numpy(), np.asarray(jmodel.std), **SCALER_TOL)
        assert float(model.std[3]) == pytest.approx(1e-8)
    else:
        assert model.std is None and jmodel.std is None
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(model(Xt).numpy(), _ref(jmodel, X), rtol=1e-5, atol=1e-4)
    carried = standard_scaler_from_numpy(jmodel.mean, None if jmodel.std is None else jmodel.std, device="cpu")
    np.testing.assert_allclose(carried(Xt).numpy(), _ref(jmodel, X), rtol=1e-5, atol=1e-5)
    # Fit on a tensor: on its device, the same model.
    _equal(StandardScaler(normalize_std_dev=normalize, device="cpu").fit(Xt).mean.numpy(), model.mean.numpy())


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_random_features_carried(rng, distribution):
    X = rng.normal(size=(16, 40)).astype(np.float32)
    jnode = JCosineRandomFeatures.create(40, 256, gamma=0.055, distribution=distribution, seed=3)
    node = random_features_from_numpy(jnode.W, jnode.b, device="cpu")
    np.testing.assert_allclose(node(torch.from_numpy(X)).numpy(), _ref(jnode, X), rtol=0, atol=RF_ATOL)


def test_cosine_random_features_created():
    node = CosineRandomFeatures.create(400, 500, gamma=2.0, seed=1, device="cpu")
    assert node.W.shape == (400, 500) and node.b.shape == (500,)
    assert abs(float(node.W.mean())) < 0.02 and float(node.W.std()) == pytest.approx(2.0, rel=0.02)
    assert 0.0 <= float(node.b.min()) and float(node.b.max()) < 2 * np.pi
    again = CosineRandomFeatures.create(400, 500, gamma=2.0, seed=1, device="cpu")
    assert torch.equal(node.W, again.W) and torch.equal(node.b, again.b)
    other = CosineRandomFeatures.create(400, 500, gamma=2.0, seed=2, device="cpu")
    assert not torch.equal(node.W, other.W)
    cauchy = CosineRandomFeatures.create(400, 500, distribution="cauchy", seed=1, device="cpu").W
    # A standard Cauchy's quartiles are ±1.
    assert float(cauchy.abs().median()) == pytest.approx(1.0, rel=0.05)
    with pytest.raises(ValueError, match="unknown distribution"):
        CosineRandomFeatures.create(4, 5, distribution="laplace", device="cpu")


# --- the pipeline -----------------------------------------------------------


def _carried_rf(conf, input_dim):
    jnode = JCosineRandomFeatures.create(input_dim=input_dim, num_features=conf.num_features, gamma=conf.gamma,
                                         distribution=conf.distribution, seed=conf.seed)
    return random_features_from_numpy(jnode.W, jnode.b, device="cpu")


# Cauchy features need a narrower bandwidth than Gaussian ones here (at
# γ = 0.1 they leave the frames at chance).
@pytest.mark.parametrize("distribution, gamma", [("gaussian", 0.1), ("cauchy", 0.01)])
def test_run_synthetic(distribution, gamma):
    kw = dict(synthetic_n=2048, num_features=1024, num_phones=12, num_iters=2, gamma=gamma,
              distribution=distribution)
    got = timit.run(timit.TimitConfig(**kw), device="cpu", random_features=_carried_rf(timit.TimitConfig(**kw), 440))
    want = j_timit.run(j_timit.TimitConfig(**kw))
    for key in ("test_accuracy", "phone_error_rate", "macro_f1"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert got["test_accuracy"] > (0.85 if distribution == "gaussian" else 0.7), got["summary"]
    # The port's own draw reaches the same quality.
    own = timit.run(timit.TimitConfig(**kw), device="cpu")
    assert abs(own["test_accuracy"] - want["test_accuracy"]) <= 0.05


def test_run_fixture_and_main(capsys):
    kw = dict(features_path=TIMIT_FIXTURE, test_features_path=TIMIT_FIXTURE, num_features=256, block_size=128)
    conf = timit.TimitConfig(**kw)
    got = timit.run(conf, device="cpu", random_features=_carried_rf(conf, 40))
    want = j_timit.run(j_timit.TimitConfig(**kw))
    assert abs(got["phone_error_rate"] - want["phone_error_rate"]) <= 1 / 12
    out = timit.main(["--features", TIMIT_FIXTURE, "--test-features", TIMIT_FIXTURE, "--num-features", "256",
                      "--block-size", "128", "--device", "cpu"])
    assert "PER" in capsys.readouterr().out and 0.0 <= out["phone_error_rate"] <= 1.0
    with pytest.raises(ValueError, match="test features are required"):
        timit.run(timit.TimitConfig(features_path=TIMIT_FIXTURE), device="cpu")


def test_run_streams_over_half_the_budget(monkeypatch):
    """With the memory budget patched below twice the features' bytes, the
    head is solved streamed from host memory and predicts as the eager
    solve does."""
    conf = timit.TimitConfig(synthetic_n=1024, num_features=512, num_phones=8, num_iters=2, gamma=0.1)
    rf = _carried_rf(conf, 440)
    with StageTimer("cpu") as eager_timer:
        eager = timit.run(conf, device="cpu", random_features=rf)
    monkeypatch.setattr(block_least_squares, "HBM_BUDGET_BYTES", 1024 * 512 * 4)
    with StageTimer("cpu") as timer:
        streamed = timit.run(conf, device="cpu", random_features=rf)
    assert "streamed BCD blocks" in timer.notes and "streamed BCD blocks" not in eager_timer.notes
    assert abs(streamed["test_accuracy"] - eager["test_accuracy"]) <= METRIC_TOL
    assert {"scaler", "apply the prefix to the fit data", "BCD epoch 1", "BCD epoch 2",
            "predicting the test frames"} <= set(timer.seconds())


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timit.run(timit.TimitConfig(synthetic_n=64))
