"""The port's serving engine (``CompiledPipeline``) held against the JAX
package's, and its replica pool, on the CPU.

One small ImageNet serving chain (gmm_k=4, pca_dims=8, 5 classes, 32×32
images: both branches, the gather and the head) is built in both packages
from the same numpy parameters. The reference's engine takes one jittable
transformer, so its side is a test-local ``Transformer`` running the same
stages (SIFT on its XLA backend, the Fisher vectors through the Pallas
kernel in interpreter mode). Both engines serve the same requests on the
ladder (4, 8):

- ``f32``: scores at the tolerance of ``test_torch_imagenet_serving.py``
  (rtol 1e-4, atol 1e-6; float32 with sums in another order);
- ``bf16``: against the reference's ``bf16`` at that same float32
  tolerance — the port rounds to bfloat16 at the same places (the request
  batch, grayscale, LCS's sums one add at a time), so only float32 sums
  differ after the cast — while bfloat16 moves the scores of both by more
  than 1e-3 from their ``f32`` scores;
- ``f32h``: bit-equal to ``f32`` on the CPU, in both packages.

The replica pool on ``devices=("cpu", "cpu", "cpu")`` answers bit for bit
as a one-replica engine, shards an oversize batch over every replica, and
``apply_batches`` keeps the source order. The streamed scorer through
``_scoring_engine`` gives the direct head's scores on the same batches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
from keystone_tpu.nodes.images.external import SIFTExtractor as JSIFTExtractor
from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
from keystone_tpu.nodes.learning import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.nodes.stats import SignedHellingerMapper as JSignedHellingerMapper
from keystone_tpu.nodes.stats.normalizer import L2Normalizer as JL2Normalizer
from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
from keystone_tpu.workflow.pipeline import Transformer as JTransformer
from keystone_tpu.workflow.serving import CompiledPipeline as JCompiledPipeline
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.loaders.stream import BatchIterator
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLinearMapper
from keystone_tpu_torch.nodes.learning.pca import PCATransformer
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.workflow import FusedTransformer, Pipeline, Transformer
from keystone_tpu_torch.workflow.serving import (
    CompiledPipeline,
    RowDependenceError,
    resolve_serve_devices,
)

K, P, C, SIZE = 4, 8, 5, 32
CONF = port.ImageNetSiftLcsFVConfig(gmm_k=K, pca_dims=P, top_k=3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
BUCKETS = (4, 8)
CPU3 = ("cpu", "cpu", "cpu")


def _images(n, seed=0):
    return JImageNetLoader.synthetic(n=16, num_classes=3, size=SIZE, seed=seed)[0].data[:n]


def _numpy_params(seed=0):
    rng = np.random.default_rng(seed)
    d = {}
    for br, width in (("sift", 128), ("lcs", 96)):
        comps, _ = np.linalg.qr(rng.normal(size=(width, P)))
        d[f"{br}.pca.components"] = comps.astype(np.float32)
        d[f"{br}.pca.mean"] = (0.1 * rng.normal(size=width)).astype(np.float32)
        w = rng.uniform(0.2, 1.0, size=K).astype(np.float32)
        d[f"{br}.gmm.weights"] = w / w.sum()
        d[f"{br}.gmm.means"] = (0.2 * rng.normal(size=(K, P))).astype(np.float32)
        d[f"{br}.gmm.variances"] = rng.uniform(0.5, 1.5, size=(K, P)).astype(np.float32)
    D = CONF.feature_dim
    d["head.W"] = rng.normal(size=(D, C)).astype(np.float32)
    d["head.blocks"] = np.array([(0, 24), (24, D)])
    d["head.b"] = rng.normal(size=C).astype(np.float32)
    return d


class _JaxScorer(JTransformer):
    """The reference's chain as one jittable transformer: both branches,
    their concatenation and the head."""

    def __init__(self, d):
        self.branches = []
        for br, fronts in (("sift", [JGrayScaler(), JSIFTExtractor(backend="xla")]),
                           ("lcs", [JLCSExtractor()])):
            self.branches.append(fronts + [
                JPCATransformer(d[f"{br}.pca.components"], d[f"{br}.pca.mean"]),
                JFisherVector(d[f"{br}.gmm.weights"], d[f"{br}.gmm.means"],
                              d[f"{br}.gmm.variances"], backend="pallas"),
                JSignedHellingerMapper(), JL2Normalizer(),
            ])
        W = d["head.W"]
        blocks = [tuple(int(v) for v in se) for se in d["head.blocks"]]
        self.head = JBlockLinearMapper([W[s:e] for s, e in blocks], blocks, d["head.b"])

    def apply_batch(self, X):
        feats = []
        for stages in self.branches:
            h = X
            for stage in stages:
                h = stage.apply_batch(h)
            feats.append(h)
        return self.head.apply_batch(jnp.concatenate(feats, axis=-1))


def _port_scorer_pipeline(d=None) -> Pipeline:
    params = params_from_numpy(_numpy_params() if d is None else d, device="cpu")
    return port.build_featurizer(params, CONF).and_then(params.head)


def _port_scorer(d=None):
    """The scoring pipeline lowered to the one module the engine serves."""
    return _port_scorer_pipeline(d).serving_chain()


def _head(d=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    comps, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return FusedTransformer([
        PCATransformer(comps.astype(np.float32), rng.normal(size=d).astype(np.float32), device="cpu"),
        L2Normalizer(),
        BlockLinearMapper(rng.normal(size=(d, k)).astype(np.float32), [(0, 3), (3, d)],
                          rng.normal(size=k).astype(np.float32), device="cpu"),
    ])


@pytest.fixture(scope="module")
def served():
    """Scores of requests of 3 and 11 images (11 = one chunk of 8 and one of
    3 padded to 4) through both engines at every precision."""
    d = _numpy_params()
    requests = [_images(3, seed=1), _images(11, seed=2)]
    out = {}
    for precision in ("f32", "f32h", "bf16"):
        ref = JCompiledPipeline(_JaxScorer(d), buckets=BUCKETS, devices=1, precision=precision,
                                name=f"port-parity-{precision}").warmup((SIZE, SIZE, 3))
        mine = CompiledPipeline(_port_scorer(d), buckets=BUCKETS, devices=["cpu"],
                                precision=precision).warmup((SIZE, SIZE, 3))
        out[precision] = ([np.asarray(ref(X)) for X in requests], [mine(X) for X in requests])
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_engine_matches_the_reference_engine(served, precision):
    for want, got in zip(*served[precision]):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_bf16_rounding_moves_the_scores_of_both_packages(served):
    for side in (0, 1):
        for f32, bf16 in zip(served["f32"][side], served["bf16"][side]):
            assert np.abs(bf16 - f32).max() > 1e-3


def test_f32h_is_f32_bit_for_bit_on_the_cpu(served):
    for side in (0, 1):
        for f32, f32h in zip(served["f32"][side], served["f32h"][side]):
            np.testing.assert_array_equal(f32h, f32)


def test_graph_or_eager_f32_equals_the_direct_call_on_the_padded_batch():
    scorer = _port_scorer()
    engine = CompiledPipeline(scorer, buckets=BUCKETS, devices=["cpu"]).warmup((SIZE, SIZE, 3))
    X = _images(3, seed=4)
    padded = np.concatenate([X, np.repeat(X[-1:], 1, axis=0)])
    with torch.inference_mode():
        want = scorer(torch.from_numpy(padded)).numpy()[:3]
    np.testing.assert_array_equal(engine(X), want)
    stats = engine.stats()
    assert stats["compile_count"] == 2 and stats["compiles_by_bucket"] == {4: 1, 8: 1}
    assert stats["graph_pool_bytes"] == {"r0:cpu": {4: 0, 8: 0}}


def test_replica_pool_answers_as_one_replica():
    rng = np.random.default_rng(0)
    one = CompiledPipeline(_head(), max_batch=16, devices=["cpu"]).warmup((8,))
    pool = CompiledPipeline(_head(), max_batch=16, devices=CPU3).warmup((8,))
    assert len(pool.replicas) == 3 and pool.compile_count == 3 * len(pool.ladder)
    for n in (1, 3, 16, 17, 50):
        X = rng.normal(size=(n, 8)).astype(np.float32)
        np.testing.assert_array_equal(pool(X), one(X))
    # Sequential calls spread over the pool (round-robin on ties).
    assert all(v > 0 for v in pool.stats()["replica_dispatches"].values())


def test_oversize_batch_shards_over_every_replica():
    pool = CompiledPipeline(_head(), buckets=[4], devices=CPU3).warmup((8,))
    X = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
    handle = pool.call_async(X)
    # Three chunks of 4, each on its own replica, all launched before wait.
    assert [r.outstanding for r in pool.replicas] == [1, 1, 1]
    got = handle.wait()
    assert [r.outstanding for r in pool.replicas] == [0, 0, 0]
    assert [r.dispatches for r in pool.replicas] == [1, 1, 1]
    np.testing.assert_array_equal(got, CompiledPipeline(_head(), buckets=[4], devices=["cpu"])(X))
    assert handle.wait() is got  # idempotent


def test_pinned_call_and_abandon_release_their_slots():
    pool = CompiledPipeline(_head(), buckets=[4], devices=CPU3).warmup((8,))
    X = np.ones((8, 8), np.float32)
    handle = pool.call_async(X, replica=2, window=1)
    assert [r.outstanding for r in pool.replicas] == [0, 0, 1]
    handle.abandon()
    assert [r.outstanding for r in pool.replicas] == [0, 0, 0]
    with pytest.raises(ValueError, match="out of range"):
        pool.call_async(X, replica=3)


def test_apply_batches_keeps_source_order_across_the_pool():
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(n, 8)).astype(np.float32), i) for i, n in enumerate((5, 1, 7, 4, 9, 2))]
    pool = CompiledPipeline(_head(), max_batch=8, devices=CPU3).warmup((8,))
    one = CompiledPipeline(_head(), max_batch=8, devices=["cpu"]).warmup((8,))
    for depth in (0, 2):
        got = list(pool.apply_batches(iter(batches), prefetch_depth=depth))
        assert [y for _, y in got] == list(range(6))
        for (out, _), (X, _) in zip(got, batches):
            np.testing.assert_array_equal(out, one(X))
    # The pipeline's apply_batches hands the stream to the engine.
    head = _head().to_pipeline()
    via = list(head.apply_batches(iter(batches), engine=head.compiled(max_batch=8, devices=CPU3)))
    for (out, y), (X, y0) in zip(via, batches):
        assert y == y0
        np.testing.assert_array_equal(out, one(X))


def test_scoring_engine_gives_the_direct_head():
    conf = port.ImageNetSiftLcsFVConfig(gmm_k=K, pca_dims=P, top_k=3, stream_batch=4)
    scored = _port_scorer_pipeline()
    X = _images(10, seed=5)
    labels = np.arange(10)
    got, got_labels = port.score_streamed(scored, conf, BatchIterator.from_arrays(X, labels, 4),
                                          SIZE, device="cpu")
    np.testing.assert_array_equal(got_labels, labels)
    chain = scored.serving_chain()
    featurizer, head = FusedTransformer(list(chain.stages)[:-1]), chain.stages[-1]
    with torch.inference_mode():
        want = np.concatenate([head(featurizer(torch.from_numpy(X[i : i + 4]))).numpy()
                               for i in range(0, 10, 4)])
    assert got.shape == want.shape == (10, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    engine = port._scoring_engine(head, 4, torch.device("cpu"))
    assert engine.ladder == (4,) and engine.name == "imagenet-score-head"


def test_row_coupled_stages_are_refused():
    class RowMean(Transformer):
        row_independent = False

        def apply_batch(self, X):
            return X - X.mean(dim=0)

    with pytest.raises(RowDependenceError, match="RowMean"):
        CompiledPipeline(_head().to_pipeline().and_then(Pipeline.gather([RowMean()])), devices=["cpu"])
    with pytest.raises(TypeError, match="cannot serve"):
        CompiledPipeline(lambda X: X, devices=["cpu"])


def test_devices_resolve_like_the_reference(monkeypatch):
    assert resolve_serve_devices(CPU3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="empty"):
        resolve_serve_devices([])
    with pytest.raises(TypeError, match="sequence"):
        resolve_serve_devices("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, 0, 1, ["cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_serve_devices(devices)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _head().to_pipeline().compiled(max_batch=4)


def test_engine_validates_its_traffic():
    engine = CompiledPipeline(_head(), max_batch=4, devices=["cpu"], inflight=1)
    with pytest.raises(ValueError, match="precision"):
        CompiledPipeline(_head(), devices=["cpu"], precision="fp8")
    with pytest.raises(ValueError, match="inflight"):
        CompiledPipeline(_head(), devices=["cpu"], inflight=0)
    out = engine(np.ones((3, 8), np.float64))  # warms lazily, serves float32
    assert out.dtype == np.float32 and engine.dtype == np.float32
    with pytest.raises(ValueError, match="feature shape"):
        engine(np.ones((2, 9), np.float32))
    with pytest.raises(ValueError, match="empty"):
        engine(np.ones((0, 8), np.float32))
    np.testing.assert_array_equal(engine(torch.ones(3, 8)), out)
