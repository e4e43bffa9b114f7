"""The port's optimizer (``workflow/optimizer.py``, ``workflow/rules.py``,
``workflow/cache.py``) held against the JAX package on the CPU.

- ``EquivalentNodeMergeRule`` and ``ChainFusionRule`` merge and fuse the
  same nodes of the same pipelines; the port also lowers a gather of
  single-consumer chains over one input, and fusion keeps every prefix
  hash.
- ``NodeOptimizationRule`` makes the reference's ``choose_solver``
  decision at the same shapes, read off a dataset or sampled through a
  prefix, and records it.
- ``AutoCacheRule`` chooses the reference's cache set from the same
  injected ``NodeProfile``s (after ``tests/test_autocache_cost.py``), and
  with ``config.auto_cache`` on leaves a fit's outputs as they were.
- FLOP counts: a quadratic stage extrapolates as scale², and the
  Fisher-vector op counts its own formula, not its plain version's
  products.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from keystone_tpu.config import config as jconfig
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow import Transformer as JTransformer
from keystone_tpu.workflow.cache import CacheOperator as JCacheOperator
from keystone_tpu.workflow.cache import NodeProfile as JNodeProfile
from keystone_tpu.workflow.cache import Profiler as JProfiler
from keystone_tpu.workflow.graph import Graph as JGraph
from keystone_tpu.workflow.operators import DatasetOperator as JDatasetOperator
from keystone_tpu.workflow.operators import TransformerOperator as JTransformerOperator
from keystone_tpu.workflow.optimizer import ChainFusionRule as JChainFusionRule
from keystone_tpu.workflow.optimizer import EquivalentNodeMergeRule as JEquivalentNodeMergeRule
from keystone_tpu.workflow.rules import AutoCacheRule as JAutoCacheRule
from keystone_tpu.workflow.rules import NodeOptimizationRule as JNodeOptimizationRule
from keystone_tpu_torch.config import config
from keystone_tpu_torch.workflow import Pipeline, PipelineEnv, Transformer, on_device, rules
from keystone_tpu_torch.workflow.cache import CacheOperator, NodeProfile, Profiler, count_flops
from keystone_tpu_torch.workflow.graph import Graph, structural_hash
from keystone_tpu_torch.workflow.operators import DatasetOperator, EstimatorOperator, TransformerOperator
from keystone_tpu_torch.workflow.optimizer import ChainFusionRule, EquivalentNodeMergeRule


@pytest.fixture(autouse=True)
def _fresh_envs(monkeypatch):
    monkeypatch.setattr(config, "exec_workers", 0)
    monkeypatch.delenv("KEYSTONE_EXEC_WORKERS", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    PipelineEnv.reset()
    JPipelineEnv.reset()
    rules.clear_decisions()
    with on_device("cpu"):
        yield
    PipelineEnv.reset()
    JPipelineEnv.reset()
    torch.set_num_threads(threads)


class Plus(Transformer):
    def __init__(self, c):
        super().__init__()
        self.c = c

    def signature(self):
        return self.stable_signature(self.c)

    def apply_batch(self, X):
        return X + self.c


class JPlus(JTransformer):
    def __init__(self, c):
        self.c = c

    def signature(self):
        return self.stable_signature(self.c)

    def apply_batch(self, X):
        return X + self.c


class Host(Transformer):
    host_stage = True

    def apply(self, x):
        return x


class JHost(JTransformer):
    jittable = False

    def apply(self, x):
        return x


def _x(n=16, d=4):
    return np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)


def _shape(g, targets):
    """Operator labels in walk order, with their dependencies as positions."""
    order = g.reachable(targets)
    idx = {n: i for i, n in enumerate(order)}
    return [(g.operators[n].label(), tuple(idx.get(d, -1) for d in g.dependencies[n])) for n in order]


def _dedup_case(P, T, kind):
    X = _x()
    if kind == "same branch twice":
        return P.gather([T(1.0).and_then(T(2.0)), T(1.0).and_then(T(2.0))]), X
    if kind == "rebuilt prefix":
        return P.gather([T(1.0).to_pipeline().and_then(T(3.0)), T(1.0).and_then(T(4.0))]), X
    if kind == "distinct":
        return P.gather([T(1.0).to_pipeline(), T(2.0).to_pipeline()]), X
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["same branch twice", "rebuilt prefix", "distinct"])
def test_node_merge_merges_the_reference_nodes(kind):
    port, X = _dedup_case(Pipeline, Plus, kind)
    ref, _ = _dedup_case(JPipeline, JPlus, kind)
    pd, jd = port(X), ref(X)
    pg = EquivalentNodeMergeRule().apply(pd.graph, [pd.sink])
    jg = JEquivalentNodeMergeRule().apply(jd.graph, [jd.sink])
    assert len(pg.operators) == len(jg.operators)
    assert [deps for _, deps in _shape(pg, [pd.sink])] == [deps for _, deps in _shape(jg, [jd.sink])]


def _fusion_case(P, T, H, kind):
    if kind == "chain":
        return T(1.0).and_then(T(2.0)).and_then(T(3.0))
    if kind == "host in the middle":
        return T(1.0).and_then(T(2.0)).and_then(H()).and_then(T(3.0)).and_then(T(4.0))
    if kind == "two consumers":
        shared = T(1.0).and_then(T(2.0))
        return shared.and_then(P.gather([T(3.0).to_pipeline(), H().to_pipeline()]))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["chain", "host in the middle", "two consumers"])
def test_chain_fusion_fuses_the_reference_chains(kind):
    X = _x()
    pd = _fusion_case(Pipeline, Plus, Host, kind)(X)
    jd = _fusion_case(JPipeline, JPlus, JHost, kind)(X)
    pg = ChainFusionRule().apply(pd.graph, [pd.sink])
    jg = JChainFusionRule().apply(jd.graph, [jd.sink])
    ported = [(lab.replace("Host", "H").replace("Plus", "P"), deps) for lab, deps in _shape(pg, [pd.sink])]
    reference = [(lab.replace("JHost", "H").replace("JPlus", "P"), deps) for lab, deps in _shape(jg, [jd.sink])]
    assert ported == reference


def test_fusion_lowers_a_gather_of_chains_and_keeps_every_prefix_hash():
    X = _x()
    p = Plus(1.0).and_then(Pipeline.gather([Plus(2.0).and_then(Plus(3.0)), Plus(4.0).to_pipeline()]))
    ds = p(X)
    before = structural_hash(ds.graph, ds.sink, lambda s: s)
    g = ChainFusionRule().apply(ds.graph, [ds.sink])
    labels = [g.operators[n].label() for n in g.reachable([ds.sink])]
    assert labels == ["Dataset", "Fused(Plus|Gather[Fused(Plus|Plus), Plus])"]
    assert structural_hash(g, ds.sink, lambda s: s) == before
    Xt = torch.from_numpy(X)
    assert torch.equal(PipelineEnv.get().execute(g, ds.sink), torch.cat([Xt + 1.0 + 2.0 + 3.0, Xt + 1.0 + 4.0], -1))


def test_fusion_can_be_turned_off(monkeypatch):
    monkeypatch.setattr(config, "fuse_chains", False)
    ds = Plus(1.0).and_then(Plus(2.0))(_x())
    assert ChainFusionRule().apply(ds.graph, [ds.sink]) is ds.graph


# --- node-level solver choice ----------------------------------------------------


SHAPES = {"local": (256, 64, 3), "normal": (1024, 4096, 3), "block": (64, 40000, 2)}


def _ls_graph(ls_cls, P, T, n, d, k, deep):
    X = np.zeros((n, d), np.float32)
    Y = np.zeros((n, k), np.float32)
    est = ls_cls(lam=1e-3, hbm_budget_bytes=1 << 30)
    p = T(0.0).and_then(est, X, Y) if deep else est.with_data(X, Y)
    ds = p(X[:2])
    return ds.graph, ds.sink, est


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("choice", ["local", "normal", "block"])
def test_node_level_rule_makes_the_reference_choice(choice, deep):
    from keystone_tpu.nodes.learning.least_squares import LeastSquaresEstimator as JLS
    from keystone_tpu_torch.nodes.learning.least_squares import LeastSquaresEstimator

    n, d, k = SHAPES[choice]
    pg, psink, pest = _ls_graph(LeastSquaresEstimator, Pipeline, Plus, n, d, k, deep)
    jg, jsink, jest = _ls_graph(JLS, JPipeline, JPlus, n, d, k, deep)
    pout = rules.NodeOptimizationRule().apply(pg, [psink])
    jout = JNodeOptimizationRule().apply(jg, [jsink])

    def chosen(g, sink):
        (op,) = [g.operators[n] for n in g.reachable([sink]) if isinstance(g.operators[n], EstimatorOperator)
                 or type(g.operators[n]).__name__ == "EstimatorOperator"]
        return type(op.estimator).__name__

    assert pest.last_choice.name == jest.last_choice.name == choice
    assert pest.last_choice.reason == jest.last_choice.reason
    assert chosen(pout, psink) == chosen(jout, jsink)
    (decision,) = [d for d in rules.optimizer_decisions() if d.rule == "NodeOptimizationRule"]
    assert decision.provenance == ("sampled" if deep else "model")
    assert decision.cost["shapes"][0] == [n, d]


def test_node_level_choice_fits_as_the_concrete_estimator():
    from keystone_tpu_torch.nodes.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.local_least_squares import LocalLeastSquaresEstimator

    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 20)).astype(np.float32)
    Y = rng.normal(size=(300, 3)).astype(np.float32)
    ls = LeastSquaresEstimator(lam=1e-2, hbm_budget_bytes=1 << 30)
    via_rule = Plus(1.0).and_then(ls, X, Y).fit()
    assert ls.last_choice.name == "local"
    PipelineEnv.get().clear_caches()  # else the fit cache serves the chosen fit to its twin
    concrete = Plus(1.0).and_then(LocalLeastSquaresEstimator(1e-2), X, Y).fit()
    assert torch.equal(via_rule(X).get(), concrete(X).get())


# --- auto-caching ------------------------------------------------------------------


class Linear(Transformer):
    def apply_batch(self, X):
        return X * 2.0 + 1.0


class Quadratic(Transformer):
    def apply_batch(self, X):
        return (X @ X.T) @ X


class JLinear(JTransformer):
    def apply_batch(self, X):
        return X * 2.0 + 1.0


class JQuadratic(JTransformer):
    def apply_batch(self, X):
        return (X @ X.T) @ X


def _cost_graph(G, D, T, L, Q, n=1024, d=16):
    X = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    g = G()
    g, data = g.add(D(X), [])
    g, q = g.add(T(Q()), [data])
    g, l1 = g.add(T(L()), [q])
    g, sink = g.add(T(L()), [l1])
    return g, data, q, l1, sink


def _cached(graph, cache_cls):
    return {graph.dependencies[nid][0] for nid, op in graph.operators.items() if isinstance(op, cache_cls)}


PROFILES = {
    "flops ratio": ((5e-4, 256.0), (2e-3, 16.0)),
    "row ratio": ((5e-4, None), (2e-3, None)),
    "same cost": ((1e-3, None), (1e-3, None)),
}


@pytest.mark.parametrize("budget_values", [0, 1, 2])
@pytest.mark.parametrize("case", list(PROFILES))
def test_auto_cache_chooses_the_reference_cache_set(case, budget_values, monkeypatch):
    """The same injected profiles and budget: the same nodes cached."""
    nbytes = 1000
    (qs, qr), (ls_, lr) = PROFILES[case]
    pg, _, pq, pl, psink = _cost_graph(Graph, DatasetOperator, TransformerOperator, Linear, Quadratic)
    jg, _, jq, jl, jsink = _cost_graph(JGraph, JDatasetOperator, JTransformerOperator, JLinear, JQuadratic)
    monkeypatch.setattr(Profiler, "profile", lambda self, g, t: {
        pq: NodeProfile(seconds=qs, bytes=nbytes, scale=16.0, flops_ratio=qr),
        pl: NodeProfile(seconds=ls_, bytes=nbytes, scale=16.0, flops_ratio=lr)})
    monkeypatch.setattr(JProfiler, "profile", lambda self, g, t: {
        jq: JNodeProfile(seconds=qs, bytes=nbytes, scale=16.0, flops_ratio=qr),
        jl: JNodeProfile(seconds=ls_, bytes=nbytes, scale=16.0, flops_ratio=lr)})
    budget = nbytes * 16 * budget_values
    got = _cached(rules.AutoCacheRule(budget_bytes=budget).apply(pg, [psink]), CacheOperator)
    want = _cached(JAutoCacheRule(budget_bytes=budget).apply(jg, [jsink]), JCacheOperator)
    position = {pq: "q", pl: "l", jq: "q", jl: "l"}
    assert {position[n] for n in got} == {position[n] for n in want}
    if case == "flops ratio" and budget_values == 1:
        assert {position[n] for n in got} == {"q"}  # the FLOPs ratio flips the decision


def test_counted_flops_extrapolate_a_quadratic_stage():
    g, _, q, l1, sink = _cost_graph(Graph, DatasetOperator, TransformerOperator, Linear, Quadratic)
    jg, _, jq, jl, jsink = _cost_graph(JGraph, JDatasetOperator, JTransformerOperator, JLinear, JQuadratic)
    profiles = Profiler(sample_rows=64).profile(g, [sink])
    jprofiles = JProfiler(sample_rows=64).profile(jg, [jsink])
    assert profiles[q].scale == jprofiles[jq].scale == pytest.approx(16.0)
    assert profiles[q].flops_ratio == pytest.approx(jprofiles[jq].flops_ratio, rel=0.1)
    assert profiles[q].flops_ratio == pytest.approx(16.0**2, rel=0.01)
    # FlopCounterMode counts products only, so an elementwise stage falls
    # back to the row ratio: the time scale the reference's count gives.
    assert profiles[l1].time_scale == pytest.approx(jprofiles[jl].time_scale, rel=0.1)


def test_the_fisher_vector_op_counts_its_formula():
    from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
    from keystone_tpu_torch.ops.fisher_vector import fisher_vector_flops

    rng = np.random.default_rng(2)
    k, d = 3, 8
    fv = FisherVector(np.full(k, 1 / k, np.float32), rng.normal(size=(k, d)).astype(np.float32),
                      np.ones((k, d), np.float32), device="cpu")
    X = torch.from_numpy(rng.normal(size=(5, 7, d)).astype(np.float32))
    assert count_flops(fv, X) == fisher_vector_flops(5, 7, d, k)


def test_auto_cache_leaves_a_fit_as_it_was(monkeypatch):
    """A prefix with two consumers (a head's fit and the scoring of the same
    rows): with the flag on, the rule inserts a cache node after the sample
    run, and the scores are those of the run without it."""
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator

    X = np.random.default_rng(3).normal(size=(200, 12)).astype(np.float32)
    Y = np.random.default_rng(4).normal(size=(200, 2)).astype(np.float32)

    def fit_and_score():
        feats = Plus(1.0).and_then(Quadratic())(X)
        head = BlockLeastSquaresEstimator(block_size=4, num_iters=2, lam=0.1).with_data(feats, Y)
        return head(feats).get()

    off = fit_and_score()
    monkeypatch.setattr(config, "auto_cache", True)
    monkeypatch.setattr(rules, "device_hbm_bytes", lambda device=None: 1 << 30)
    on = fit_and_score()
    assert torch.equal(on, off)
    inserted = [d for d in rules.optimizer_decisions() if d.action == "cache-insert"]
    assert inserted and all(d.provenance == "sampled" for d in inserted)
    auto = PipelineEnv.get().optimizer.batches[2][1][0]
    assert {lab for lab, _ in auto.last_profiles} >= {"Plus", "Quadratic"}


def test_auto_cache_is_gated_per_apply_and_off_by_default():
    assert config.auto_cache is False and jconfig.auto_cache is False
    ds = Plus(1.0).and_then(Plus(2.0))(_x())
    auto = PipelineEnv.get().optimizer.batches[2][1][0]
    assert isinstance(auto, rules.AutoCacheRule) and auto.apply(ds.graph, [ds.sink]) is ds.graph


def test_fused_modules_are_reused_across_applies_and_die_with_their_pipeline():
    import gc
    import weakref

    p = Plus(1.0).and_then(Pipeline.gather([Plus(2.0).and_then(Plus(3.0)), Plus(4.0).to_pipeline()]))
    rule = ChainFusionRule()

    def fused_module():
        ds = p(_x())
        (op,) = [op for op in rule.apply(ds.graph, [ds.sink]).operators.values()
                 if isinstance(op, TransformerOperator)]
        return op.transformer

    first = fused_module()
    assert fused_module() is first
    gone = weakref.ref(first)
    del first, p
    gc.collect()
    assert gone() is None
