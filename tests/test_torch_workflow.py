"""The port's workflow layer (``keystone_tpu_torch/workflow/``: graph,
pipeline, executor, functional) held against the JAX package on the CPU.

- Graph algebra: the same ``add``/``union``/``instantiate``/``pruned``/
  ``replace_node`` sequence gives the same topology in both packages.
- The lazy pipeline: composition, laziness, estimators, gathers, the fit
  cache, ``fit``, ``apply_datum``, ``fitted_forward``, ``.cache()`` and
  ``Cacher``, each giving the reference's values on the same numpy data.
- The executor: the parallel walk at 1, 2 and 4 workers bit-equal to the
  serial walk (after ``tests/test_parallel_exec.py``), faults raised on
  the caller, values dropped after their last use.
- ``serving_chain``: a gather of chains from one input lowered to one
  ``GatherTransformer``, bit-equal to the graph walk, fused or not.
- A reduced ImageNetSiftLcsFV (32×32 images, ``gmm_k=4``, ``pca_dims=8``)
  fitted through both packages' graphs: errors within the tolerance of
  ``tests/test_torch_imagenet_fit.py``.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.workflow import Estimator as JEstimator
from keystone_tpu.workflow import LabelEstimator as JLabelEstimator
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow import Transformer as JTransformer
from keystone_tpu.workflow import graph as jgraph
from keystone_tpu_torch.config import config
from keystone_tpu_torch.nodes.util.misc import Cacher
from keystone_tpu_torch.workflow import (
    Estimator,
    FusedTransformer,
    GatherTransformer,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    PipelineEnv,
    Transformer,
    fitted_forward,
    on_device,
)
from keystone_tpu_torch.workflow import graph as pgraph
from keystone_tpu_torch.workflow.executor import UnboundSourceError


@pytest.fixture(autouse=True)
def _fresh_envs(monkeypatch):
    """Each test in fresh sessions of both packages, the port's on the CPU,
    with torch at two threads."""
    monkeypatch.setattr(config, "exec_workers", 0)
    monkeypatch.delenv("KEYSTONE_EXEC_WORKERS", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    PipelineEnv.reset()
    JPipelineEnv.reset()
    with on_device("cpu"):
        yield
    PipelineEnv.reset()
    JPipelineEnv.reset()
    torch.set_num_threads(threads)


# --- graph algebra ---------------------------------------------------------


def _canon(g, targets):
    """A graph's topology from ``targets``, ids replaced by walk positions
    (sources numbered in the order the walk first meets them)."""
    order = g.reachable(targets)
    idx = {n: i for i, n in enumerate(order)}
    src: dict = {}

    def ref(gid):
        return ("n", idx[gid]) if gid in idx else ("s", src.setdefault(gid, len(src)))

    nodes = [(g.operators[n], tuple(ref(d) for d in g.dependencies[n])) for n in order]
    return nodes, [ref(t) for t in targets]


def _chain(G):
    src = G.fresh_source_id()
    g, a = G.Graph().add("a", [src])
    g, b = g.add("b", [a])
    g, c = g.add("c", [b])
    return _canon(g, [c])


def _diamond(G):
    src = G.fresh_source_id()
    g, a = G.Graph().add("a", [src])
    g, b = g.add("b", [a])
    g, c = g.add("c", [a])
    g, d = g.add("d", [b, c])
    return _canon(g, [d]), sorted(len(v) for v in g.consumers([d]).values())


def _union(G):
    src = G.fresh_source_id()
    g1, a = G.Graph().add("a", [src])
    g2, b = g1.add("b", [a])
    g3, c = g1.add("c", [a])
    g = g2.union(g3)
    g, d = g.add("d", [b, c])
    return _canon(g, [d]), len(g.operators)


def _instantiate(G):
    src, src2 = G.fresh_source_id(), G.fresh_source_id()
    g, a = G.Graph().add("a", [src])
    g, b = g.add("b", [a])
    g, x = g.add("x", [src2])
    g, (b2,) = g.instantiate([b], {src: x})
    return _canon(g, [b, b2]), len(g.sources_of([b2])), len(g.operators)


def _pruned(G):
    src = G.fresh_source_id()
    g, a = G.Graph().add("a", [src])
    g, orphan = g.add("orphan", [a])
    g, b = g.add("b", [a])
    p = g.pruned([b])
    return _canon(p, [b]), len(p.operators), orphan in p.operators


def _replace(G):
    src = G.fresh_source_id()
    g, a = G.Graph().add("a", [src])
    g, b = g.add("b", [a])
    g = g.replace_node(b, "B", [src, a])
    return _canon(g, [b])


@pytest.mark.parametrize("build", [_chain, _diamond, _union, _instantiate, _pruned, _replace])
def test_graph_algebra_gives_the_reference_topology(build):
    assert build(pgraph) == build(jgraph)


# --- the lazy pipeline, against the reference ------------------------------


class Plus(Transformer):
    def __init__(self, c):
        super().__init__()
        self.c = c

    def apply_batch(self, X):
        return X + self.c


class JPlus(JTransformer):
    def __init__(self, c):
        self.c = c

    def apply_batch(self, X):
        return X + self.c


class Times(Transformer):
    def __init__(self, c):
        super().__init__()
        self.c = c

    def apply_batch(self, X):
        return X * self.c


class JTimes(JTransformer):
    def __init__(self, c):
        self.c = c

    def apply_batch(self, X):
        return X * self.c


class MeanShift(Estimator):
    def __init__(self):
        self.fit_count = 0

    def fit(self, data):
        self.fit_count += 1
        return Plus(-torch.as_tensor(data).mean(dim=0))


class JMeanShift(JEstimator):
    def __init__(self):
        self.fit_count = 0

    def fit(self, data):
        self.fit_count += 1
        return JPlus(-jnp.mean(jnp.asarray(data), axis=0))


class ScaleToLabels(LabelEstimator):
    def fit(self, data, labels):
        return Times(torch.as_tensor(labels).float().mean() / torch.as_tensor(data).mean())


class JScaleToLabels(JLabelEstimator):
    def fit(self, data, labels):
        return JTimes(jnp.mean(jnp.asarray(labels)) / jnp.mean(jnp.asarray(data)))


class Counting(Transformer):
    """Doubles its input and counts the batches it saw."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def apply_batch(self, X):
        self.calls += 1
        return X * 2.0


def _x(n=12, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _port(out):
    return (out.get() if isinstance(out, PipelineDataset) else out).numpy()


def _ref(out):
    return np.asarray(out.get() if hasattr(out, "get") else out)


def _pair(kind):
    """The same pipeline in both packages: (port, reference, data)."""
    X = _x()
    if kind == "chain":
        return Plus(1.0).and_then(Times(2.0)), JPlus(1.0).and_then(JTimes(2.0)), X
    if kind == "estimator":
        return (Plus(1.0).and_then(MeanShift(), X), JPlus(1.0).and_then(JMeanShift(), X), X)
    if kind == "label estimator":
        y = np.arange(12, dtype=np.float32)
        return (Plus(3.0).and_then(ScaleToLabels(), X, y), JPlus(3.0).and_then(JScaleToLabels(), X, y), X)
    if kind == "with_data":
        return MeanShift().with_data(X), JMeanShift().with_data(X), X[:5]
    if kind == "gather":
        return (Pipeline.gather([Plus(1.0), Times(3.0).and_then(Plus(-1.0))]),
                JPipeline.gather([JPlus(1.0), JTimes(3.0).and_then(JPlus(-1.0))]), X)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["chain", "estimator", "label estimator", "with_data", "gather"])
def test_lazy_pipeline_gives_the_reference_values(kind):
    port, ref, X = _pair(kind)
    got = port(X)
    assert isinstance(got, PipelineDataset)
    np.testing.assert_allclose(_port(got), _ref(ref(X)), rtol=1e-6, atol=1e-6)
    # Fitted: a transformer-only pipeline that gives the same values.
    np.testing.assert_allclose(_port(port.fit()(X)), _ref(ref.fit()(X)), rtol=1e-6, atol=1e-6)


def test_pipeline_is_lazy_and_fits_once_across_applications():
    X = _x()
    est = MeanShift()
    p = Plus(1.0).and_then(est, X)
    ds = p(X)
    assert est.fit_count == 0
    first = ds.get()
    assert est.fit_count == 1 and ds.get() is first
    p(X[:4]).get()
    p.fit()
    assert est.fit_count == 1  # the session's fit cache


def test_fit_returns_a_transformer_only_pipeline_without_the_training_data():
    X = _x()
    fitted = Plus(1.0).and_then(MeanShift(), X).fit()
    names = [type(t).__name__ for t in fitted.transformers()]
    assert names == ["Plus", "Plus"]
    assert "Dataset" not in fitted.describe() and "MeanShift" not in fitted.to_dot()
    assert fitted.to_dot().startswith("digraph pipeline {")


def test_gather_computes_a_shared_prefix_once():
    counting = Counting()
    prefix = counting.to_pipeline()
    p = prefix.and_then(Pipeline.gather([Plus(1.0), Times(2.0)]))
    out = p(_x()).get()
    assert out.shape == (12, 6) and counting.calls == 1


def test_apply_datum_gives_the_reference_datum():
    X = _x()
    p = Plus(1.0).and_then(MeanShift(), X)
    j = JPlus(1.0).and_then(JMeanShift(), X)
    got = p.apply_datum(X[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(j.apply_datum(X[3])), rtol=1e-6, atol=1e-6)
    assert got.shape == (3,)


def test_fitted_forward_replays_the_optimized_graph():
    X = _x()
    fitted = Pipeline.gather([Plus(1.0).and_then(Times(2.0)), Times(3.0).to_pipeline()]).fit()
    fn = fitted_forward(fitted, X[:2])
    np.testing.assert_array_equal(fn(torch.from_numpy(X)).numpy(), fitted(X).get().numpy())


@pytest.mark.parametrize("how", ["cache()", "Cacher"])
def test_a_cached_prefix_is_cut_from_the_next_walk(how):
    counting = Counting()
    prefix = counting.to_pipeline()
    cached = prefix.cache() if how == "cache()" else prefix.and_then(Cacher())
    p = cached.and_then(Plus(1.0))
    X = torch.from_numpy(_x())
    a = p(X).get()
    b = p(X).get()
    assert torch.equal(a, b) and counting.calls == 1
    assert len(PipelineEnv.get().node_cache) == 1
    assert torch.equal(Cacher()(X), X)  # called directly it is the identity


def test_unbound_sources_and_profile_raise():
    p = Plus(1.0).to_pipeline()
    with pytest.raises(UnboundSourceError):
        PipelineEnv.get().execute(p.graph, p.sink)
    with pytest.raises(NotImplementedError, match="profile store"):
        Plus(1.0).to_pipeline().fit(profile=True)


def test_host_data_runs_on_the_env_device_only():
    """A host array goes to the env's device: with CUDA absent and no
    device named, the walk raises instead of falling back to the CPU."""
    env = PipelineEnv.get()
    with env.on_device(None):
        prior, env._device = env._device, None
        try:
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="CUDA is not available"):
                    Plus(1.0).to_pipeline()(_x()).get()
        finally:
            env._device = prior


def test_row_batches_write_one_output():
    """A device stage over more rows than FIT_BATCH runs in row batches
    whose outputs land in one tensor, the values of one call."""
    counting = Counting()
    X = _x(n=150)
    got = counting.to_pipeline()(X).get()
    assert counting.calls == 3  # batches of 64, 64, 22
    np.testing.assert_array_equal(got.numpy(), X * 2.0)


# --- the executor's walks ---------------------------------------------------


def _imagenet_featurizer():
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port

    conf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8)
    params = params_from_numpy(port.seeded_params(0, 4, 8, 5, "cpu", conf), "cpu")
    return port.build_featurizer(params, conf), params


def _walk_cases():
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(6, 32, 32, 3)).astype(np.float32)
    X = _x(n=40, d=8)
    return {
        "imagenet featurizer": lambda: (_imagenet_featurizer()[0], images),
        "fit and score": lambda: (
            Pipeline.gather([Plus(1.0).and_then(Times(2.0)), Times(3.0).to_pipeline()]).and_then(
                MeanShift(), X),
            X,
        ),
        "host branches": lambda: (
            Pipeline.gather([Counting().and_then(Plus(1.0)), Plus(2.0).and_then(Counting())]), X),
    }


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("case", ["imagenet featurizer", "fit and score", "host branches"])
def test_parallel_walk_is_bit_equal_to_the_serial_walk(case, workers, fuse, monkeypatch):
    monkeypatch.setattr(config, "fuse_chains", fuse)
    pipe, data = _walk_cases()[case]()
    serial = pipe(data).get()
    PipelineEnv.get().clear_caches()
    monkeypatch.setattr(config, "exec_workers", workers)
    parallel = pipe(data).get()
    assert torch.equal(serial, parallel)


def test_a_fault_on_a_worker_is_raised_on_the_caller(monkeypatch):
    class Boom(Transformer):
        def apply_batch(self, X):
            raise ValueError("boom")

    monkeypatch.setattr(config, "exec_workers", 2)
    monkeypatch.setattr(config, "fuse_chains", False)
    p = Pipeline.gather([Plus(1.0).and_then(Boom()), Times(2.0).to_pipeline()])
    with pytest.raises(ValueError, match="boom"):
        p(_x()).get()


def test_parallel_walk_runs_branches_on_worker_threads(monkeypatch):
    seen = set()

    class Where(Transformer):
        def apply_batch(self, X):
            seen.add(threading.current_thread().name)
            return X

    monkeypatch.setattr(config, "exec_workers", 2)
    monkeypatch.setattr(config, "fuse_chains", False)
    Pipeline.gather([Where().and_then(Plus(1.0)), Plus(2.0).and_then(Where())])(_x()).get()
    assert seen and all(name.startswith("keystone-exec") for name in seen)


def test_serial_walk_drops_values_after_their_last_use():
    """Only the targets' values come back from a walk; the fit's data and
    the branch outputs are not kept."""
    X = _x()
    p = Pipeline.gather([Plus(1.0), Times(2.0)]).and_then(MeanShift(), X)
    ds = p(X)
    env = PipelineEnv.get()
    g = env.optimizer.execute(ds.graph, [ds.sink])
    values = env.executor.execute_many(g, [ds.sink])
    assert list(values) == [ds.sink]


# --- serving_chain: the gather lowering --------------------------------------


@pytest.mark.parametrize("fuse", [True, False])
def test_serving_chain_lowers_the_gather_bit_equal_to_the_graph_walk(fuse, monkeypatch):
    monkeypatch.setattr(config, "fuse_chains", fuse)
    featurizer, params = _imagenet_featurizer()
    scorer = featurizer.and_then(params.head)
    chain = scorer.serving_chain()
    assert isinstance(chain, FusedTransformer) and isinstance(chain.stages[0], GatherTransformer)
    assert [len(b.stages) for b in chain.stages[0].branches] == [6, 5]
    images = np.random.default_rng(5).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        walked = scorer(images).get()
        lowered = chain(torch.from_numpy(images))
    assert torch.equal(walked, lowered)


def test_serving_chain_refuses_an_unfitted_estimator_and_foreign_gathers():
    X = _x()
    with pytest.raises(TypeError, match="cannot serve"):
        PipelineEnv.get().executor.serving_chain(
            *(lambda p: (p.graph, p.source, p.sink))(Plus(1.0).and_then(MeanShift(), X)))
    # Two branches that do not start from the pipeline's one input.
    a, b = Plus(1.0).to_pipeline(), Plus(2.0).to_pipeline()
    g = a.graph.union(b.graph)
    from keystone_tpu_torch.workflow.operators import GatherOperator

    g, out = g.add(GatherOperator(), [a.sink, b.sink])
    with pytest.raises((TypeError, ValueError)):
        PipelineEnv.get().executor.serving_chain(g, a.source, out)


# --- a reduced ImageNetSiftLcsFV through both packages' graphs ---------------


def test_reduced_imagenet_fit_through_both_graphs_matches_the_errors():
    """Both packages fit the reduced pipeline lazily through their graphs:
    the branches' PCA and GMM (the port's carried from the reference's, as
    ``tests/test_torch_imagenet_fit.py`` does), then ``and_then(solver,
    images, labels)`` and ``fit()``. Test errors within ERROR_TOL."""
    from keystone_tpu.loaders.imagenet import ImageNetLoader as JImageNetLoader
    from keystone_tpu.nodes.images import GrayScaler as JGrayScaler
    from keystone_tpu.nodes.images import LCSExtractor as JLCSExtractor
    from keystone_tpu.nodes.images.external.fisher_vector import FisherVector as JFisherVector
    from keystone_tpu.nodes.images.external.fisher_vector import (
        fit_fisher_featurizer as jfit_fisher_featurizer,
    )
    from keystone_tpu.nodes.images.external.sift import SIFTExtractor as JSIFTExtractor
    from keystone_tpu.nodes.learning import BlockWeightedLeastSquaresEstimator as JBlockWLS
    from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
    from keystone_tpu.nodes.util import ClassLabelIndicators as JClassLabelIndicators
    from keystone_tpu.nodes.util import TopKClassifier as JTopKClassifier
    from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as ref
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util.classifiers import TopKClassifier
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as port

    error_tol = 2 / 128  # tests/test_torch_imagenet_fit.py's ERROR_TOL
    conf = ref.resolve_scale(ref.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, sift_backend="xla",
                                                         synthetic_n=128, synthetic_classes=16, top_k=3))
    train, test = JImageNetLoader.synthetic(n=128, num_classes=16, size=32, seed=conf.seed)
    fronts = ((JGrayScaler().and_then(JSIFTExtractor(backend="xla")), conf.seed),
              (JLCSExtractor().to_pipeline(), conf.seed + 1))
    jbranches = [
        jfit_fisher_featurizer(front, train.data, pca_dims=8, gmm_k=4, em_iters=conf.gmm_iters,
                               sample_size=conf.descriptor_sample, backend=conf.fv_backend, seed=seed)
        for front, seed in fronts
    ]
    jfeat = JPipeline.gather(jbranches)
    kw = dict(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
              mixture_weight=conf.mixture_weight)
    jscored = jfeat.and_then(JBlockWLS(**kw), train.data, JClassLabelIndicators(16)(train.labels))
    jtop = np.asarray(jscored.and_then(JTopKClassifier(3))(test.data).get())

    def found(pipe, cls):
        nodes = [t for t in pipe.fit().transformers() for t in getattr(t, "stages", [t])]
        return [t for t in nodes if isinstance(t, cls)]

    d = {}
    for br, branch in zip(("sift", "lcs"), jbranches):
        (pca,), (fv,) = found(branch, JPCATransformer), found(branch, JFisherVector)
        d[f"{br}.pca.components"], d[f"{br}.pca.mean"] = np.array(pca.components), np.array(pca.mean)
        for key in ("weights", "means", "variances"):
            d[f"{br}.gmm.{key}"] = np.array(getattr(fv, key))
    d.update({"head.W": np.zeros((128, 16), np.float32), "head.blocks": [(0, 128)]})
    pconf = port.ImageNetSiftLcsFVConfig(gmm_k=4, pca_dims=8, synthetic_classes=16, top_k=3)
    pfeat = port.build_featurizer(params_from_numpy(d, device="cpu"), pconf)
    targets = ClassLabelIndicators(16)(torch.as_tensor(train.labels))
    scored = pfeat.and_then(BlockWeightedLeastSquaresEstimator(**kw), train.data, targets)
    top = scored.and_then(TopKClassifier(3))(test.data).get().numpy()

    def errors(topk):
        return (float(1 - (topk == test.labels[:, None]).any(axis=1).mean()),
                float((topk[:, 0] != test.labels).mean()))

    got, want = errors(top), errors(jtop)
    assert abs(got[0] - want[0]) <= error_tol and abs(got[1] - want[1]) <= error_tol, (got, want)
