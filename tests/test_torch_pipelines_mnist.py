"""MnistRandomFFT and its parts in the port, held against the JAX package on
the CPU.

- Loaders (IDX fixture, CSV, synthetic with and without label noise): the
  same arrays, bit for bit.
- ``RandomSignNode`` with the reference's signs carried across, the
  rectifier and ``MaxClassifier``: equal, bit for bit (a sign flip, a max
  and an argmax round nothing). ``PaddedFFT``: two float32 FFTs of the
  same rows, within rtol 1e-5, atol 1e-6.
- The solvers in float32 on well-conditioned systems (κ below 1e3):
  ``_chol_solve``, the normal equations, TSQR and both
  ``LinearMapEstimator`` methods within rtol 1e-4, atol 1e-5 of the
  reference's, whose grams and QRs sum over its 8-device CPU mesh in
  another order.
- The pipeline at 512 rows and 2 FFTs: with the reference's signs carried
  across, the port's gathered features within rtol 1e-5, atol 1e-5; its
  fitted W, like the reference's, within √n·κ·u of a float64 solve (512
  rows under 2,052 features leave the ridge gram's condition number κ near
  1e4), its test scores within 1e-3 of the largest |score| of the
  reference's, and predictions on the 256 test rows equal but for at most
  one. The port's ``run`` on its own signs reaches the
  reference ``run``'s test accuracy within 0.02.

torch runs on two threads here, restored after the module.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.linalg import RowMatrix
from keystone_tpu.linalg import solve_least_squares_normal as j_normal
from keystone_tpu.linalg import solve_least_squares_tsqr as j_tsqr
from keystone_tpu.linalg.normal_equations import _chol_solve as j_chol_solve
from keystone_tpu.loaders import synthetic as j_synthetic
from keystone_tpu.loaders.csv_loader import CsvDataLoader as JCsvDataLoader
from keystone_tpu.loaders.mnist import MnistLoader as JMnistLoader
from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.nodes.learning import LinearMapper as JLinearMapper
from keystone_tpu.nodes.stats import LinearRectifier as JLinearRectifier
from keystone_tpu.nodes.stats import PaddedFFT as JPaddedFFT
from keystone_tpu.nodes.stats import RandomSignNode as JRandomSignNode
from keystone_tpu.nodes.util import MaxClassifier as JMaxClassifier
from keystone_tpu.pipelines.images import mnist_random_fft as ref
from keystone_tpu_torch.convert import linear_mapper_from_numpy, random_sign_nodes
from keystone_tpu_torch.linalg.normal_equations import _chol_solve, solve_least_squares_normal
from keystone_tpu_torch.linalg.tsqr import solve_least_squares_tsqr
from keystone_tpu_torch.loaders import synthetic
from keystone_tpu_torch.loaders.csv_loader import CsvDataLoader
from keystone_tpu_torch.loaders.mnist import MnistLoader
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator, LinearMapper
from keystone_tpu_torch.nodes.stats.fft import PaddedFFT
from keystone_tpu_torch.nodes.stats.random_signs import RandomSignNode
from keystone_tpu_torch.nodes.stats.rectifier import LinearRectifier
from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
from keystone_tpu_torch.pipelines.images import mnist_random_fft as port
from keystone_tpu_torch.workflow import on_device

MNIST_FIXTURE = "tests/fixtures/data/mnist/t10k"
FFT_TOL = dict(rtol=1e-5, atol=1e-6)
SOLVE_TOL = dict(rtol=1e-4, atol=1e-5)


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
    """The reference node or pipeline on X, as numpy (a pipeline's result
    is lazy)."""
    out = node(X)
    return np.asarray(out.get() if hasattr(out, "get") else out)


def _fitted(pipeline, cls):
    """The one node of type ``cls`` of a reference pipeline, its estimators
    fitted (a fitted chain may come back fused: its stages are searched)."""
    nodes = [t for t in pipeline.fit().transformers() for t in getattr(t, "stages", [t])]
    (found,) = [t for t in nodes if isinstance(t, cls)]
    return found

def _own(pipeline, cls):
    """The one node of type ``cls`` of a fitted port pipeline (searched
    through fused chains and gathered branches)."""
    def flat(t):
        for part in getattr(t, "stages", None) or getattr(t, "branches", None) or [t]:
            yield from ([part] if part is t else flat(part))

    (found,) = [n for t in pipeline.fit().transformers() for n in flat(t) if isinstance(n, cls)]
    return found


# --- loaders ---------------------------------------------------------------


def test_idx_fixture_loads_bit_equal():
    want, got = JMnistLoader.load(MNIST_FIXTURE), MnistLoader.load(MNIST_FIXTURE)
    _equal(got.data, want.data)
    _equal(got.labels, want.labels)


def test_csv_loads_bit_equal(tmp_path, rng):
    path = str(tmp_path / "rows.csv")
    raw = np.column_stack([rng.integers(0, 10, 20), rng.uniform(size=(20, 7))])
    np.savetxt(path, raw, delimiter=",")
    for got, want in ((CsvDataLoader.load_labeled(path), JCsvDataLoader.load_labeled(path)),
                      (CsvDataLoader.load_labeled(path, label_col=3), JCsvDataLoader.load_labeled(path, label_col=3))):
        _equal(got.data, want.data)
        _equal(got.labels, want.labels)
    _equal(CsvDataLoader.load(path), JCsvDataLoader.load(path))
    _equal(MnistLoader.load(path).data, JMnistLoader.load(path).data)


@pytest.mark.parametrize("noise", ["", "0.2"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_bit_equal(monkeypatch, seed, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    for got, want in zip(MnistLoader.synthetic(n=300, seed=seed), JMnistLoader.synthetic(n=300, seed=seed)):
        _equal(got.data, want.data)
        _equal(got.labels, want.labels)
    got, want = MnistLoader.synthetic(n=64, dim=800, seed=seed)[0], JMnistLoader.synthetic(n=64, dim=800, seed=seed)[0]
    _equal(got.data, want.data)


@pytest.mark.parametrize("noise", ["", "0.3", "bad"])
def test_label_noise_bit_equal(monkeypatch, noise):
    monkeypatch.setenv("KEYSTONE_SYNTH_LABEL_NOISE", noise)
    assert synthetic.label_noise_rate() == j_synthetic.label_noise_rate()
    y = np.arange(50) % 7
    Y = (np.arange(60).reshape(12, 5) % 3 == 0).astype(np.int32)
    for labels in (y, Y):
        got = synthetic.with_label_noise(labels, 7, np.random.default_rng(4))
        _equal(got, j_synthetic.with_label_noise(labels, 7, np.random.default_rng(4)))


# --- nodes -----------------------------------------------------------------


@pytest.mark.parametrize("width", [784, 100, 64])
def test_padded_fft(rng, width):
    X = rng.normal(size=(5, width)).astype(np.float32)
    want = _ref(JPaddedFFT(), X)
    got = PaddedFFT()(torch.from_numpy(X)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FFT_TOL)


def test_random_signs_carried_and_created(rng):
    X = rng.normal(size=(6, 40)).astype(np.float32)
    jnode = JRandomSignNode.create(40, seed=5)
    (node,) = random_sign_nodes([jnode.signs], device="cpu")
    _equal(node(torch.from_numpy(X)).numpy(), _ref(jnode, X))
    # The port's own draw: ±1, deterministic per seed or generator.
    a = RandomSignNode.create(1000, seed=2, device="cpu").signs
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(a, RandomSignNode.create(1000, seed=2, device="cpu").signs)
    assert not torch.equal(a, RandomSignNode.create(1000, seed=3, device="cpu").signs)
    g = torch.Generator().manual_seed(2)
    assert torch.equal(a, RandomSignNode.create(1000, generator=g, device="cpu").signs)


@pytest.mark.parametrize("max_val, alpha", [(0.0, 0.0), (0.1, 0.25), (-1.0, 0.5)])
def test_linear_rectifier(rng, max_val, alpha):
    X = rng.normal(size=(4, 30)).astype(np.float32)
    got = LinearRectifier(max_val, alpha)(torch.from_numpy(X)).numpy()
    _equal(got, _ref(JLinearRectifier(max_val, alpha), X))


def test_max_classifier_ties_to_the_first(rng):
    S = rng.integers(0, 3, size=(40, 6)).astype(np.float32)  # many ties
    _equal(MaxClassifier()(torch.from_numpy(S)).numpy(), _ref(JMaxClassifier(), S))


# --- solvers ---------------------------------------------------------------


def _system(rng, n=256, d=24, k=3):
    A = rng.normal(size=(n, d)).astype(np.float32)
    B = (A @ rng.normal(size=(d, k)) + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    return A, B


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
def test_chol_solve(rng, refine_steps):
    A, B = _system(rng)
    gram, atb = A.T @ A, A.T @ B
    want = np.asarray(j_chol_solve(gram, atb, np.float32(0.5), refine_steps))
    got = _chol_solve(torch.from_numpy(gram), torch.from_numpy(atb), 0.5, refine_steps).numpy()
    np.testing.assert_allclose(got, want, **SOLVE_TOL)


@pytest.mark.parametrize("lam", [0.0, 0.5, 10.0])
def test_normal_equations(rng, lam):
    A, B = _system(rng)
    want = np.asarray(j_normal(RowMatrix.from_array(A), RowMatrix.from_array(B), lam))
    got = solve_least_squares_normal(torch.from_numpy(A), torch.from_numpy(B), lam).numpy()
    np.testing.assert_allclose(got, want, **SOLVE_TOL)


@pytest.mark.parametrize("n, lam", [(256, 0.0), (256, 0.5), (20, 2.0)])
def test_tsqr(rng, n, lam):
    # n = 20 < d + k = 27: R is completed by zero rows, as each shard's is.
    A, B = _system(rng, n=n)
    want = np.asarray(j_tsqr(RowMatrix.from_array(A), RowMatrix.from_array(B), lam))
    got = solve_least_squares_tsqr(torch.from_numpy(A), torch.from_numpy(B), lam).numpy()
    np.testing.assert_allclose(got, want, **SOLVE_TOL)


@pytest.mark.parametrize("method", ["normal", "tsqr"])
def test_linear_map_estimator(rng, method):
    A, B = _system(rng)
    A += 3.0  # nonzero means: the intercept carries them
    want = JLinearMapEstimator(lam=0.5, method=method).fit(A, B)
    got = LinearMapEstimator(lam=0.5, method=method, device="cpu").fit(A, B)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **SOLVE_TOL)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), **SOLVE_TOL)
    X = rng.normal(size=(9, A.shape[1])).astype(np.float32)
    np.testing.assert_allclose(got(torch.from_numpy(X)).numpy(), _ref(want, X), **SOLVE_TOL)
    carried = linear_mapper_from_numpy(np.asarray(want.W), np.asarray(want.b), device="cpu")
    assert isinstance(carried, LinearMapper)
    np.testing.assert_allclose(carried(torch.from_numpy(X)).numpy(), _ref(want, X), **SOLVE_TOL)


def test_linear_map_estimator_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="method"):
        LinearMapEstimator(method="qr")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        LinearMapEstimator().partial_fit(np.zeros((2, 2)), np.zeros((2, 1)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        LinearMapEstimator().solve_online(None)


# --- the pipeline ----------------------------------------------------------


SMALL = dict(num_ffts=2, synthetic_n=512, seed=0)


def _ridge64(F, Y, lam):
    """The centered ridge solve in float64 numpy: (W, b)."""
    F, Y = F.astype(np.float64), Y.astype(np.float64)
    fm, ym = F.mean(axis=0), Y.mean(axis=0)
    A = F - fm
    W = np.linalg.solve(A.T @ A + lam * np.eye(A.shape[1]), A.T @ (Y - ym))
    return W, ym - fm @ W


def test_pipeline_with_the_reference_signs_matches():
    from keystone_tpu.nodes.util import ClassLabelIndicators as JClassLabelIndicators
    from keystone_tpu.workflow import Pipeline as JPipeline

    conf = ref.MnistRandomFFTConfig(**SMALL)
    train, test = JMnistLoader.synthetic(n=conf.synthetic_n, seed=conf.seed)
    jpipe = ref.build_pipeline(conf, train.data, train.labels)
    want_pred = _ref(jpipe, test.data)
    signs = [np.array(JRandomSignNode.create(784, seed=conf.seed + i).signs) for i in range(conf.num_ffts)]
    pconf = port.MnistRandomFFTConfig(**SMALL)
    featurizer = port.build_featurizer(pconf, 784, signs=signs, device="cpu")
    jfeat = JPipeline.gather([
        JRandomSignNode(s).and_then(JPaddedFFT()).and_then(JLinearRectifier()) for s in signs
    ])
    with torch.inference_mode(), on_device("cpu"):
        got_f, got_train_f = (featurizer(torch.from_numpy(X)).get().numpy() for X in (test.data, train.data))
    want_f = _ref(jfeat, test.data)
    assert got_f.shape == want_f.shape == (len(test.data), 2 * 1026)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=1e-5)

    pipe = port.build_pipeline(pconf, train.data, train.labels, device="cpu", featurizer=featurizer)
    jmap, mapper = _fitted(jpipe, JLinearMapper), _own(pipe, LinearMapper)
    # 512 rows under 2,052 features: the ridge gram's condition number κ is
    # near 1e4, and a float32 gram summed over n rows is off by about √n·u
    # (u = 2⁻²⁴), so float32 solves land apart. Each W is held against a
    # float64 solve of the same features, within √n·κ·u; the test scores
    # within 1e-3 of the largest |score| of the reference's.
    W64, _ = _ridge64(got_train_f, np.asarray(JClassLabelIndicators(10)(train.labels)), conf.lam)
    A = got_train_f.astype(np.float64) - got_train_f.mean(axis=0)
    # Fewer rows than features: AᵀA is singular, so the ridge gram's
    # smallest eigenvalue is lam and its largest σ_max(A)² + lam.
    kappa = (np.linalg.norm(A, 2) ** 2 + conf.lam) / conf.lam
    bound = np.sqrt(len(A)) * kappa * 2.0**-24

    def err(W):
        return np.linalg.norm(np.asarray(W, np.float64) - W64) / np.linalg.norm(W64)

    assert err(mapper.W.numpy()) <= bound and err(jmap.W) <= bound, (err(mapper.W.numpy()), err(jmap.W), bound)
    with torch.inference_mode():
        got_s = mapper(torch.from_numpy(got_f)).numpy()
    want_s = _ref(jmap, want_f)
    assert np.abs(got_s - want_s).max() <= 1e-3 * np.abs(want_s).max()
    got_pred = port.predict(pipe, test.data, device="cpu")
    assert got_pred.dtype == np.int32 and (got_pred != want_pred).sum() <= 1


def test_run_and_main_reach_the_reference_accuracy():
    want = ref.run(ref.MnistRandomFFTConfig(**SMALL))
    got = port.run(port.MnistRandomFFTConfig(**SMALL), device="cpu")
    assert set(got) == set(want)
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 0.02, (got["summary"], want["summary"])
    out = port.main(["--device", "cpu", "--num-ffts", "1", "--synthetic-n", "256", "--lam", "0.5"])
    assert 0.0 <= out["test_accuracy"] <= 1.0
    with pytest.raises(ValueError, match="--test"):
        port.run(port.MnistRandomFFTConfig(train_path=MNIST_FIXTURE), device="cpu")


def test_run_on_the_idx_fixture(tmp_path):
    got = port.run(port.MnistRandomFFTConfig(train_path=MNIST_FIXTURE, test_path=MNIST_FIXTURE, num_ffts=1),
                   device="cpu")
    want = ref.run(ref.MnistRandomFFTConfig(train_path=MNIST_FIXTURE, test_path=MNIST_FIXTURE, num_ffts=1))
    assert 0.0 <= got["test_accuracy"] <= 1.0 and 0.0 <= want["test_accuracy"] <= 1.0
