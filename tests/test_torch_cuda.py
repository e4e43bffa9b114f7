"""The port on the card: kernels against their plain versions.

These tests need a CUDA device and skip without one. They import nothing of
JAX, so on a machine with a card and no JAX they run without the suite's
conftest (which builds the JAX CPU mesh):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernel vs plain version on the card: the kernel's 3xTF32 tensor-core
products keep float32-level accuracy and the two differ in summation order,
so they are held at rtol 1e-4, atol 1e-5, at every serving bucket's width
and with variances near the 1e-4 floor. The SIFT front
is held against itself on the CPU at the descriptor tolerance of
tests/test_descriptors.py (rtol 2e-4, atol 2e-4), which cuDNN's TF32
convolutions would miss.

The streamed solve on the card, double-buffered from pinned memory, gives
the same bits as the same solve serialized (``overlap=False``): the copies
move bytes, and the updates run in one order on one stream. A pinned
staging buffer is not refilled while its copy is in flight.
``apply_batches`` on the card is held against the CPU at rtol 1e-5.

The solver's products: bfloat16 operands multiply into a float32 result,
within float32 summation rounding of the exact products (each is exact in
float32); ``high`` runs TF32 (10 mantissa bits, so within 1e-2 of the
largest |value| of ``highest``'s, and not equal to it) and leaves TF32 off
after it; ``highest`` refuses TF32 turned on from outside. Features on the
card over half the memory budget (patched small) are streamed from the
host, and the head matches the CPU's streamed fit at rtol 1e-4.

The workflow layer on the card: a graph walk over host images runs on the
card and gives the fused serving chain's bits, the parallel walk the
serial walk's, and a disk fit cache entry loads back onto the card.

The serving engine captures one CUDA graph per bucket: a graphed bucket
gives the eager chain's bits on the same padded input (the same operators
on the same stream order), and each replay counts the two Fisher-vector
launches (one per branch) that its graph holds, which capture itself does
not count. A batch already on the card, and a batch given as request
blocks, give the host batch's bits.

The other image pipelines' parts on the card against the CPU: the
Convolver in float32 (cuDNN's TF32 off) within 1e-5 of the largest
|output|, in bfloat16 within 1e-4 (bfloat16 operands, float32 sums; TF32
holds a bfloat16 value exactly) and with TF32 left as it was; the FFT
features within rtol 1e-5, atol 1e-5; the normal equations and TSQR on a
well-conditioned system within rtol 1e-4, atol 1e-5. MnistRandomFFT fitted
on the card predicts as on the CPU but for at most one of 256 test rows.

The speech and text pipelines' parts on the card against the CPU: a
``SparseBatch`` as a CSR tensor times a dense matrix within rtol 1e-5, atol
1e-6; naive Bayes, logistic regression (30 L-BFGS steps, objectives within
a relative 1e-4, predictions equal on 99% of rows) and the sparse block
solver (predictions within rtol 1e-4, atol 1e-4) fitted on the same sparse
features; TIMIT at 2,048 frames and the text pipelines at 400 documents
reach the CPU's metrics within 0.01.

A small fit of the whole pipeline on the card is held against the same fit
on the CPU: both draw the same random numbers, and differ only in rounding.
PCA components up to sign at atol 1e-3 (rounding rotates components whose
singular values are close), the GMM (means in the same signs) within 1e-2
of each array's largest magnitude, and test scores within 1e-2 of the
largest |score|.

The learning nodes and descriptors of the last slice on the card against
the CPU: kernel ridge regression by CG and by Nyström PCG (α and
predictions within 1e-3 of the largest |value|, iterations within 2;
float32 CG, the two devices sum in other orders), HOG and DAISY within atol
1e-5 on unit-norm descriptors; native SIFT's descriptors come to the card
in the layout of the ``xla`` backend, within the descriptor tolerance.
"""

import threading

import numpy as np
import pytest
import torch

import keystone_tpu_torch.ops.fisher_vector as fvo
from keystone_tpu_torch.convert import params_from_numpy, params_to_numpy
from keystone_tpu_torch.linalg.bcd import block_coordinate_descent_streamed
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
from keystone_tpu_torch.ops.sift import dense_sift
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.utils.staging import HostStager
from keystone_tpu_torch.workflow import FusedTransformer, on_device
from keystone_tpu_torch.workflow.serving import CompiledPipeline

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-5)
DESC_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gmm_case(B, m, d, k, seed, zero_component=False, var_range=(0.5, 1.5), mu_scale=0.5):
    """Descriptors drawn from a random diagonal GMM, and that GMM."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, size=k)
    if zero_component:
        w[-1] = 0.0
    w /= w.sum()
    mu = mu_scale * rng.normal(size=(k, d))
    var = rng.uniform(*var_range, size=(k, d))
    z = rng.integers(0, k, size=(B, m))
    X = mu[z] + np.sqrt(var[z]) * rng.normal(size=(B, m, d))
    return [a.astype(np.float32) for a in (X, w, mu, var)]


@pytest.mark.parametrize(
    "B, m, d, k, zero_component",
    [
        (2, 3721, 64, 256, False),  # full width
        (1, 3721, 64, 256, False),  # a one-image request
        (3, 37, 64, 256, False),  # m shorter than one split
        (2, 1000, 64, 256, True),  # a starved component: zero block, no NaN
        (2, 100, 8, 16, False),  # the CPU tests' widths
        (3, 3721, 64, 256, False),  # the serving buckets of 3, 16 and 64 images
        (16, 3721, 64, 256, False),
        (64, 3721, 64, 256, False),
        (2, 500, 8, 5, False),  # k not a multiple of the 8-wide MMA tile
        (64, 841, 64, 16, False),  # VOCSIFTFisher: 128x128 images, k = 16
        (1, 841, 64, 16, False),
    ],
)
def test_kernel_matches_plain(cuda, B, m, d, k, zero_component):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(B, m, d, k, m, zero_component))
    before = fvo.LAUNCHES
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    assert fvo.LAUNCHES == before + 1
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    torch.cuda.synchronize()
    assert got.shape == (B, 2 * k * d) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize(
    "B, m, k, var_range, mu_scale",
    [
        # Variances uniform in 1e-4..1e-3, as a fitted GMM reaches, with
        # the means a few standard deviations apart.
        (3, 3721, 256, (1e-4, 1e-3), 0.05),
        # Every variance at the floor and means fifty standard deviations
        # from 0, as on a GMM fitted to real descriptors: the statistics
        # are summed from x - mu, so the kernel stays within TOL.
        (64, 841, 16, (1e-4, 1e-4), 0.5),
        (2, 3721, 256, (1e-4, 1e-4), 0.5),
    ],
)
def test_kernel_matches_plain_near_floor_variances(cuda, B, m, k, var_range, mu_scale):
    case = _gmm_case(B, m, 64, k, 6, var_range=var_range, mu_scale=mu_scale)
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in case)
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    torch.testing.assert_close(got, ref, **TOL)


def test_two_launches_are_bitwise_equal(cuda):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(4, 3721, 64, 256, 5))
    ops = fvo.fv_operands(w, mu, var)
    first = fvo.fisher_vectors(X, ops)
    second = fvo.fisher_vectors(X, ops)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_node_on_the_card_launches_the_kernel(cuda):
    X, w, mu, var = _gmm_case(2, 300, 16, 8, 0)
    node = FisherVector(w, mu, var, device=cuda)
    before = fvo.LAUNCHES
    got = node(torch.from_numpy(X).to(cuda))
    assert fvo.LAUNCHES == before + 1
    want = FisherVector(w, mu, var, device="cpu")(torch.from_numpy(X))
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(1, 50, 12, 4, 0))
    with pytest.raises(ValueError, match="d in"):
        fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    X, w, mu, var = (torch.from_numpy(a).to(cuda) for a in _gmm_case(1, 50, 16, 4, 0))
    ops = fvo.fv_operands(w, mu, var)
    with pytest.raises(ValueError, match="contiguous"):
        fvo.fisher_vectors(X[:, ::2], ops)
    with pytest.raises(ValueError, match="float32"):
        fvo.fisher_vectors(X.double(), ops)


def test_sift_on_the_card_matches_the_cpu(cuda):
    imgs = np.random.default_rng(1).uniform(size=(2, 64, 72)).astype(np.float32)
    want = dense_sift(torch.from_numpy(imgs))
    got = dense_sift(torch.from_numpy(imgs).to(cuda)).cpu()
    torch.testing.assert_close(got, want, **DESC_TOL)


FIT_CONF = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, synthetic_classes=8, top_k=3)


def test_small_fit_on_the_card_matches_the_cpu(cuda):
    train, test = ImageNetLoader.synthetic(n=64, num_classes=8, seed=3)
    fitted = {dev: port.fit(FIT_CONF, train, 8, device=dev) for dev in (cuda, "cpu")}
    got, want = (params_to_numpy(fitted[dev]) for dev in (cuda, "cpu"))
    for br in ("sift", "lcs"):
        gc, wc = got[f"{br}.pca.components"], want[f"{br}.pca.components"]
        signs = np.sign((gc * wc).sum(axis=0))
        np.testing.assert_allclose(gc * signs, wc, atol=1e-3)
        np.testing.assert_allclose(got[f"{br}.pca.mean"], want[f"{br}.pca.mean"], rtol=1e-4, atol=1e-5)
        for key, flip in (("weights", 1), ("means", signs), ("variances", 1)):
            g, w = got[f"{br}.gmm.{key}"] * flip, want[f"{br}.gmm.{key}"]
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), (br, key)
    X = torch.from_numpy(test.data[:32])
    with torch.inference_mode():
        s_card = fitted[cuda](X.to(cuda)).get().cpu()
        with on_device("cpu"):
            s_cpu = fitted["cpu"](X).get()
    assert (s_card - s_cpu).abs().max() <= 1e-2 * s_cpu.abs().max()


def test_fit_launches_the_kernel_on_every_training_batch(cuda):
    train, _ = ImageNetLoader.synthetic(n=150, num_classes=8, seed=4)
    before = fvo.LAUNCHES
    port.fit(FIT_CONF, train, 8, device=cuda)
    # Three batches of the training set (64, 64, 22), two branches: the
    # branch fits themselves encode nothing.
    assert fvo.LAUNCHES - before == 2 * 3


def test_streamed_solve_double_buffered_equals_serialized(cuda):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 320)).astype(np.float32)
    Y = torch.from_numpy(rng.normal(size=(600, 7)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=600).astype(np.float32)).to(cuda)
    runs = [
        torch.cat(block_coordinate_descent_streamed(
            X, Y, 64, 3, lam=0.1, row_weights=w, col_center=X.mean(axis=0), overlap=overlap)[0])
        for overlap in (True, False)
    ]
    assert torch.equal(runs[0], runs[1])
    cpu = torch.cat(block_coordinate_descent_streamed(
        X, Y.cpu(), 64, 3, lam=0.1, row_weights=w.cpu(), col_center=X.mean(axis=0))[0])
    torch.testing.assert_close(runs[0].cpu(), cpu, rtol=1e-4, atol=1e-4)


def test_a_pinned_buffer_waits_for_its_copy(cuda):
    stager = HostStager(cuda, buffers=1)
    shape = (4096, 4096)
    up = stager.upload(stager.fill(shape, torch.float32, lambda out: out.fill_(1.0)))
    refilled = threading.Event()

    def refill():
        stager.fill(shape, torch.float32, lambda out: out.fill_(2.0))
        refilled.set()

    producer = threading.Thread(target=refill)
    producer.start()
    assert not refilled.wait(0.3)  # the one buffer is still lent to the copy
    stager.reclaim()
    assert refilled.wait(10)
    producer.join(timeout=10)
    assert not producer.is_alive()
    assert torch.equal(stager.ready(up), torch.ones(shape, device=cuda))
    stager.close()


def test_apply_batches_on_the_card_equals_the_cpu(cuda):
    X = np.random.default_rng(6).normal(size=(70, 9)).astype(np.float32)
    pipe = FusedTransformer([L2Normalizer()])
    got = [o.cpu() for o, _ in pipe.apply_batches(BatchIterator.from_arrays(X, None, 16), device=cuda)]
    want = pipe.apply_in_batches(X, batch_size=16, device="cpu")
    torch.testing.assert_close(torch.cat(got), want, rtol=1e-5, atol=1e-6)


def test_solver_products_on_the_card(cuda):
    """bfloat16 operands multiply into float32 (cuBLAS ``out_dtype``); ``high``
    turns TF32 on for its own product only; ``highest`` refuses TF32 set
    from outside."""
    from keystone_tpu_torch.linalg.row_matrix import solver_matmul

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(512, 1024)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(1024, 256)).astype(np.float32)).to(cuda)
    got = solver_matmul(x.to(torch.bfloat16), y)
    assert got.dtype == torch.float32
    exact = x.to(torch.bfloat16).double() @ y.to(torch.bfloat16).double()
    torch.testing.assert_close(got.double(), exact, rtol=0, atol=1024 * 2.0**-24 * float(exact.abs().max()))
    highest = solver_matmul(x, y, "highest")
    high = solver_matmul(x, y, "high")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.equal(high, highest)  # TF32 rounds the operands to 10 bits
    torch.testing.assert_close(high, highest, rtol=0, atol=1e-2 * float(highest.abs().max()))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            solver_matmul(x, y, "highest")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_the_auto_rule_streams_features_on_the_card(cuda, monkeypatch):
    import keystone_tpu_torch.nodes.learning.block_least_squares as bls
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator

    rng = np.random.default_rng(8)
    X = rng.normal(size=(300, 64)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=300)] * 2 - 1
    calls = []
    real = bls.block_coordinate_descent_streamed
    monkeypatch.setattr(bls, "block_coordinate_descent_streamed", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(bls, "HBM_BUDGET_BYTES", 2 * X.nbytes - 2)
    est = BlockWeightedLeastSquaresEstimator(block_size=16, num_iters=2, lam=0.1)
    got = est.fit(torch.from_numpy(X).to(cuda), torch.from_numpy(Y).to(cuda))
    assert calls == [1] and got.W.device.type == "cuda"
    want = BlockWeightedLeastSquaresEstimator(block_size=16, num_iters=2, lam=0.1, device="cpu",
                                              stream=True).fit(X, Y)
    torch.testing.assert_close(got.W.cpu(), want.W, rtol=1e-4, atol=1e-4)


def _small_scorer(cuda):
    """The serving chain at gmm_k=4, pca_dims=8, 5 classes, to scores."""
    conf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, top_k=3)
    params = params_from_numpy(port.seeded_params(0, 4, 8, 5, cuda, conf), cuda)
    return port.build_featurizer(params, conf).and_then(params.head).serving_chain()


def test_graphed_bucket_equals_the_eager_chain(cuda):
    scorer = _small_scorer(cuda)
    captured = fvo.LAUNCHES
    engine = CompiledPipeline(scorer, buckets=[4], devices=[cuda]).warmup((32, 32, 3))
    X = ImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=1)[0].data[:3]
    got = engine(X)
    with torch.inference_mode():
        want = scorer(torch.from_numpy(np.concatenate([X, X[-1:]])).to(cuda))[:3].cpu().numpy()
    np.testing.assert_array_equal(got, want)
    stats = engine.stats()
    assert stats["compile_count"] == 1
    assert next(iter(stats["graph_pool_bytes"].values()))[4] > 0
    # The eager warm-up, the warm-up's replay, the replay serving X and the
    # eager call launch the kernel twice each; the capture launches nothing.
    assert fvo.LAUNCHES - captured == 4 * 2


def test_a_replay_counts_two_fisher_vector_launches(cuda):
    engine = CompiledPipeline(_small_scorer(cuda), buckets=[1, 4], devices=[cuda]).warmup((32, 32, 3))
    X = ImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=2)[0].data
    for n in (1, 3, 8):  # 8: two chunks of 4, two replays
        before = fvo.LAUNCHES
        out = engine(X[:n])
        assert out.shape == (n, 5) and np.isfinite(out).all()
        assert fvo.LAUNCHES - before == 2 * -(-n // 4)


def test_rows_on_the_card_and_in_blocks_equal_the_host_batch(cuda):
    engine = CompiledPipeline(_small_scorer(cuda), buckets=[4], devices=[cuda]).warmup((32, 32, 3))
    X = ImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=3)[0].data[:3]
    want = engine(X)
    # Device to device into the static input, after the caller's stream.
    np.testing.assert_array_equal(engine(torch.from_numpy(X).to(cuda)), want)
    # Request blocks written into the pinned slot at their offsets.
    np.testing.assert_array_equal(engine._call_parts([X[:1], X[1:]]).wait(), want)


def test_convolver_on_the_card_matches_the_cpu(cuda):
    from keystone_tpu_torch.nodes.images.convolver import Convolver

    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.uniform(size=(4, 32, 32, 3)).astype(np.float32))
    F = rng.normal(size=(16, 6, 6, 3)).astype(np.float32)
    before = torch.backends.cudnn.allow_tf32
    for dtype, tol in ((None, 1e-5), ("bfloat16", 1e-4)):
        want = Convolver(F, compute_dtype=dtype, device="cpu")(X)
        got = Convolver(F, compute_dtype=dtype, device=cuda)(X.to(cuda)).cpu()
        assert (got - want).abs().max() <= tol * want.abs().max()
        assert torch.backends.cudnn.allow_tf32 == before


def test_fft_and_solvers_on_the_card_match_the_cpu(cuda):
    from keystone_tpu_torch.linalg.normal_equations import solve_least_squares_normal
    from keystone_tpu_torch.linalg.tsqr import solve_least_squares_tsqr
    from keystone_tpu_torch.nodes.stats.fft import PaddedFFT

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(8, 784)).astype(np.float32))
    torch.testing.assert_close(PaddedFFT()(X.to(cuda)).cpu(), PaddedFFT()(X), rtol=1e-5, atol=1e-5)
    A = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(512, 4)).astype(np.float32))
    for solve in (solve_least_squares_normal, solve_least_squares_tsqr):
        torch.testing.assert_close(solve(A.to(cuda), B.to(cuda), 0.5).cpu(), solve(A, B, 0.5),
                                   rtol=1e-4, atol=1e-5)


def test_mnist_fit_on_the_card_predicts_as_the_cpu(cuda):
    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.pipelines.images import mnist_random_fft as mnist

    conf = mnist.MnistRandomFFTConfig(num_ffts=2, synthetic_n=1024)
    train, test = MnistLoader.synthetic(n=conf.synthetic_n)
    preds = [mnist.predict(mnist.build_pipeline(conf, train.data, train.labels, device=dev), test.data, dev)
             for dev in (cuda, "cpu")]
    assert (preds[0] != preds[1]).sum() <= 1


# --- the speech and text pipelines ---------------------------------------


def _sparse_rows(n=200, d=300, seed=0):
    from keystone_tpu_torch.utils.sparse import SparseBatch

    rng = np.random.default_rng(seed)
    X = np.zeros((n, d), dtype=np.float32)
    for i in range(n):
        X[i, rng.choice(d, size=8, replace=False)] = rng.normal(size=8)
    return SparseBatch.from_dense(X), X, rng.integers(0, 3, size=n)


def test_sparse_batch_on_the_card(cuda):
    sb, X, _ = _sparse_rows()
    for transpose in (False, True):
        csr = sb.to_torch(cuda, transpose=transpose)
        assert csr.layout == torch.sparse_csr and csr.device.type == "cuda"
        A = X.T if transpose else X
        M = np.random.default_rng(1).normal(size=(A.shape[1], 5)).astype(np.float32)
        got = (csr @ torch.from_numpy(M).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(got, A.astype(np.float64) @ M, rtol=1e-5, atol=1e-6)


def test_text_classifiers_on_the_card_match_the_cpu(cuda):
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.logistic_regression import LogisticRegressionEstimator
    from keystone_tpu_torch.nodes.learning.naive_bayes import NaiveBayesEstimator

    sb, X, y = _sparse_rows()
    counts = _sparse_rows()[0]
    counts.values[:] = np.abs(counts.values)  # term weights are not negative
    nb = {dev: NaiveBayesEstimator(3, device=dev).fit(counts, y)(counts).cpu() for dev in (cuda, "cpu")}
    np.testing.assert_allclose(nb[cuda].numpy(), nb["cpu"].numpy(), rtol=1e-5, atol=1e-5)
    ests = {dev: LogisticRegressionEstimator(3, max_iters=30, device=dev) for dev in (cuda, "cpu")}
    lr = {dev: est.fit(sb, y)(sb).cpu().numpy() for dev, est in ests.items()}
    assert abs(ests[cuda].result.value - ests["cpu"].result.value) <= 1e-4 * ests["cpu"].result.value
    assert (lr[cuda].argmax(1) == lr["cpu"].argmax(1)).mean() >= 0.99
    targets = 2.0 * np.eye(3, dtype=np.float32)[y] - 1.0
    bls = {dev: BlockLeastSquaresEstimator(block_size=128, num_iters=3, lam=0.1, device=dev).fit(sb, targets)(sb)
           .cpu().numpy() for dev in (cuda, "cpu")}
    np.testing.assert_allclose(bls[cuda], bls["cpu"], rtol=1e-4, atol=1e-4)


def test_speech_and_text_pipelines_on_the_card_match_the_cpu(cuda):
    from keystone_tpu_torch.pipelines.speech import timit
    from keystone_tpu_torch.pipelines.text import amazon_reviews, newsgroups

    conf = timit.TimitConfig(synthetic_n=2048, num_features=1024, num_phones=12, num_iters=2, gamma=0.1)
    got, want = (timit.run(conf, dev)["test_accuracy"] for dev in (cuda, "cpu"))
    assert abs(got - want) <= 0.01
    for classifier in ("naive_bayes", "logistic"):
        conf = newsgroups.NewsgroupsConfig(synthetic_n=400, num_features=300, classifier=classifier)
        got, want = (newsgroups.run(conf, dev)["test_accuracy"] for dev in (cuda, "cpu"))
        assert abs(got - want) <= 0.01
    conf = amazon_reviews.AmazonReviewsConfig(synthetic_n=400, num_features=300)
    got, want = (amazon_reviews.run(conf, dev)["auc"] for dev in (cuda, "cpu"))
    assert abs(got - want) <= 0.01


def test_kernel_ridge_on_the_card_matches_the_cpu(cuda):
    from keystone_tpu_torch.nodes.learning.kernel_ridge import KernelRidgeRegression

    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 12)).astype(np.float32)
    Y = rng.normal(size=(600, 3)).astype(np.float32)
    for landmarks in (None, 100):
        ests = {dev: KernelRidgeRegression(gamma=0.1, lam=1e-2, max_iters=300, tol=1e-6,
                                           precond_landmarks=landmarks, device=dev) for dev in (cuda, "cpu")}
        models = {dev: est.fit(X, Y) for dev, est in ests.items()}
        assert models[cuda].alpha.device.type == "cuda"
        got, want = models[cuda].alpha.cpu().numpy(), models["cpu"].alpha.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
        assert abs(ests[cuda].last_cg_iters - ests["cpu"].last_cg_iters) <= 2
        pred = {dev: m(torch.from_numpy(X).to(m.alpha.device)).cpu().numpy() for dev, m in models.items()}
        np.testing.assert_allclose(pred[cuda], pred["cpu"], rtol=0, atol=1e-3 * np.abs(pred["cpu"]).max())


def test_hog_and_daisy_on_the_card_match_the_cpu(cuda):
    from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor
    from keystone_tpu_torch.nodes.images.hog import HogExtractor

    X = torch.from_numpy(np.random.default_rng(6).uniform(size=(3, 67, 81, 3)).astype(np.float32))
    for node in (HogExtractor(), DaisyExtractor()):
        got = node(X.to(cuda))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), node(X), rtol=0, atol=1e-5)


def test_native_sift_comes_to_the_card_in_the_xla_layout(cuda):
    from keystone_tpu_torch.nodes.images.external.sift import SIFTExtractor

    imgs = torch.from_numpy(np.random.default_rng(7).uniform(size=(2, 64, 72, 1)).astype(np.float32)).to(cuda)
    got = SIFTExtractor(backend="native")(imgs)
    assert got.device == imgs.device
    torch.testing.assert_close(got, SIFTExtractor(backend="xla")(imgs), **DESC_TOL)


# --- the workflow layer on the card ---------------------------------------------


def test_the_graph_walk_on_the_card_equals_the_fused_chain(cuda):
    """``pipeline(X).get()`` on host images runs on the card (the env's
    device) and gives the fused serving chain's bits; the parallel walk at
    two workers, unfused, gives the serial walk's."""
    from keystone_tpu_torch.config import config
    from keystone_tpu_torch.workflow import PipelineEnv

    conf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, top_k=3)
    params = params_from_numpy(port.seeded_params(0, 4, 8, 5, cuda, conf), cuda)
    scorer = port.build_featurizer(params, conf).and_then(params.head)
    X = ImageNetLoader.synthetic(n=8, num_classes=3, size=32, seed=1)[0].data[:6]
    PipelineEnv.reset()
    with torch.inference_mode(), on_device(cuda):
        walked = scorer(X).get()
        assert walked.device.type == "cuda"
        assert torch.equal(walked, scorer.serving_chain()(torch.from_numpy(X).to(cuda)))
        prior = config.fuse_chains, config.exec_workers
        try:
            config.fuse_chains, config.exec_workers = False, 0
            serial = scorer(X).get()
            config.exec_workers = 2
            parallel = scorer(X).get()
        finally:
            config.fuse_chains, config.exec_workers = prior
    assert torch.equal(serial, parallel)


def test_a_disk_cache_entry_loads_onto_the_card(cuda, tmp_path, monkeypatch):
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow import PipelineEnv

    monkeypatch.setenv("KEYSTONE_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)).to(cuda)
    Y = torch.from_numpy(rng.normal(size=(64, 2)).astype(np.float32)).to(cuda)
    PipelineEnv.reset()
    first = BlockLeastSquaresEstimator(block_size=8, num_iters=2, lam=0.1).with_data(X, Y).fit()
    PipelineEnv.reset()
    again = BlockLeastSquaresEstimator(block_size=8, num_iters=2, lam=0.1).with_data(X, Y).fit()
    head = again.transformers()[0]
    assert head.W.device.type == "cuda" and torch.equal(head.W, first.transformers()[0].W)
    PipelineEnv.reset()
