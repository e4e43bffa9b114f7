"""The port's serving ladder, memory planner and precision gate held
against the JAX package.

The pure functions (``pow2_ladder``, ``resolve_ladder`` with its
precedence of argument, exported ``KEYSTONE_SERVE_BUCKETS`` and
``config.serve_buckets``, ``bucket_for``, ``plan_serve_ladder`` at one
explicit ``budget_bytes``) must give the reference's results exactly. The
quality gate (``precision_quality_delta``, ``check_precision_quality``)
and the numpy evaluators under it must give the reference's metric names,
scores and deltas within 1e-12, on the same arrays.

``qualify`` on a chain built so that bfloat16 rounding must flip every
argmax: rows ``[1, 1 + 2**-10]`` score their second class in float32, and
bfloat16 (8 mantissa bits) rounds both entries to 1, a tie that argmax
gives to the first class. Both packages refuse, naming the same metric and
delta; an f32 engine's gate is the identity.
"""

import numpy as np
import pytest

import keystone_tpu.config as jconfig_mod
from keystone_tpu.config import config as jconfig
from keystone_tpu.evaluation import (
    BinaryClassifierEvaluator as JBinary,
    MeanAveragePrecisionEvaluator as JMAP,
    MulticlassClassifierEvaluator as JMulticlass,
)
from keystone_tpu.nodes.learning import PCATransformer as JPCATransformer
from keystone_tpu.workflow import rules as jrules
from keystone_tpu.workflow import serving as jserving
from keystone_tpu_torch import config as pconfig_mod
from keystone_tpu_torch.config import config as pconfig
from keystone_tpu_torch.evaluation.binary import BinaryClassifierEvaluator
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLinearMapper
from keystone_tpu_torch.nodes.learning.pca import PCATransformer
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.utils import metrics as pmetrics
from keystone_tpu_torch.utils.metrics import serve_plan_counters
from keystone_tpu_torch.workflow import FusedTransformer, rules
from keystone_tpu_torch.workflow import serving

TIGHT = 1e-12


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SERVE_BUCKETS", raising=False)
    saved = [(c, c.plan_resources, c.serve_buckets, c.serve_max_batch) for c in (pconfig, jconfig)]
    yield
    for c, *values in saved:
        c.plan_resources, c.serve_buckets, c.serve_max_batch = values


def _chain(d=8, k=3, seed=0):
    """A small row-independent serving chain of the port, on the CPU."""
    rng = np.random.default_rng(seed)
    comps, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return FusedTransformer([
        PCATransformer(comps.astype(np.float32), rng.normal(size=d).astype(np.float32), device="cpu"),
        L2Normalizer(),
        BlockLinearMapper(rng.normal(size=(d, k)).astype(np.float32), [(0, d // 2), (d // 2, d)],
                          rng.normal(size=k).astype(np.float32), device="cpu"),
    ])


@pytest.mark.parametrize("max_batch", [1, 2, 48, 64, 1024])
def test_pow2_ladder_and_bucket_for_match_the_reference(max_batch):
    ladder = pconfig_mod.pow2_ladder(max_batch)
    assert ladder == jconfig_mod.pow2_ladder(max_batch)
    for n in range(0, max_batch + 3):
        assert serving.bucket_for(n, ladder) == jserving.bucket_for(n, ladder)
    with pytest.raises(ValueError):
        pconfig_mod.pow2_ladder(0)


@pytest.mark.parametrize(
    "buckets, max_batch, env, conf",
    [
        (None, None, None, ()),
        (None, 16, None, ()),
        ([8, 2, 2, 32], None, None, ()),
        ([8, 2, 32], 16, None, ()),
        ([64], 16, None, ()),
        (None, None, "4,32", ()),
        (None, 8, "pow2", ()),
        (None, None, None, (3, 12)),
        (None, None, "5", (3, 12)),
        ([7], None, "5", (3, 12)),
    ],
)
def test_resolve_ladder_precedence_matches_the_reference(monkeypatch, buckets, max_batch, env, conf):
    if env is not None:
        monkeypatch.setenv("KEYSTONE_SERVE_BUCKETS", env)
    pconfig.serve_buckets = jconfig.serve_buckets = conf
    pconfig.serve_max_batch = jconfig.serve_max_batch = 64
    got = serving.resolve_ladder(buckets, max_batch)
    assert got == jserving.resolve_ladder(buckets, max_batch)
    assert serving.ladder_is_pinned(buckets) == jserving.ladder_is_pinned(buckets)
    assert pconfig_mod.resolved_serve_buckets() == jconfig_mod.resolved_serve_buckets()


def test_resolve_ladder_refuses_what_the_reference_refuses(monkeypatch):
    for bad in ([0, 4], [-1]):
        with pytest.raises(ValueError):
            jserving.resolve_ladder(bad)
        with pytest.raises(ValueError):
            serving.resolve_ladder(bad)
    with pytest.raises(ValueError):
        serving.resolve_ladder(None, 0)
    monkeypatch.setenv("KEYSTONE_SERVE_BUCKETS", "4,x")
    with pytest.raises(ValueError, match="KEYSTONE_SERVE_BUCKETS"):
        pconfig_mod.resolved_serve_buckets()


@pytest.mark.parametrize(
    "ladder, bpr, replicas, budget",
    [
        ((1, 2, 4, 8, 16), 100.0, 2, 1500),  # trims 8 and 16
        ((4, 8), 1000.0, 1, 1),  # over budget at its last rung
        ((1, 2, 4, 8, 16, 32, 64), 2.5e7, 1, 40 * 2**30),  # keeps every rung
        ((1, 2, 4, 8, 16, 32, 64), 2.5e7, 3, 2 * 2**30),
        ((3, 12, 48), 77.7, 0, 5000),
    ],
)
def test_plan_serve_ladder_matches_the_reference(ladder, bpr, replicas, budget):
    rules.clear_decisions()
    before = serve_plan_counters.snapshot()
    kept, trimmed, info = rules.plan_serve_ladder(ladder, bpr, replicas, budget_bytes=budget,
                                                  provenance="measured", node="t")
    jkept, jtrimmed, jinfo = jrules.plan_serve_ladder(ladder, bpr, replicas, budget_bytes=budget,
                                                      provenance="measured", node="t")
    assert (kept, trimmed, info) == (jkept, jtrimmed, jinfo)
    assert kept[0] == min(ladder)  # the smallest rung always stays
    after = serve_plan_counters.snapshot()
    assert after.get("buckets_trimmed", 0) - before.get("buckets_trimmed", 0) == len(trimmed)
    assert after["ladders_planned"] - before.get("ladders_planned", 0) == 1
    actions = [d.action for d in rules.optimizer_decisions() if d.rule == "PlanServeLadder"]
    assert actions == [f"trim-bucket={b}" for b in trimmed] + [
        "serve_buckets=" + ",".join(map(str, kept))
    ]


def test_decision_ring_is_bounded():
    rules.clear_decisions()
    for i in range(300):
        rules.record_decision("R", str(i), "a", "model", "why")
    kept = rules.optimizer_decisions()
    assert len(kept) == 256 and kept[0].node == "44" and kept[-1].node == "299"


def _score_cases(seed=0):
    rng = np.random.default_rng(seed)
    oracle = rng.normal(size=(300, 6)).astype(np.float32)
    served = oracle + 0.3 * rng.normal(size=oracle.shape).astype(np.float32)
    # Labels the oracle mostly gets right, so that noise costs quality.
    y = np.where(rng.uniform(size=300) < 0.9, oracle.argmax(axis=1), rng.integers(0, 6, 300))
    multilabel = oracle > 0.8
    return oracle, served, y, multilabel


@pytest.mark.parametrize("metric, labels", [("multiclass", False), ("multiclass", True),
                                            ("binary", False), ("binary", True), ("map", True)])
def test_quality_delta_and_gate_match_the_reference(metric, labels):
    oracle, served, y, multilabel = _score_cases()
    if metric == "binary" and labels:
        y = oracle[:, 0] > 0
    if metric == "map":
        y = multilabel
    yy = y if labels else None
    name, delta, ref, got = serving.precision_quality_delta(oracle, served, y=yy, metric=metric)
    jname, jdelta, jref, jgot = jserving.precision_quality_delta(oracle, served, y=yy, metric=metric)
    assert name == jname
    for a, b in ((delta, jdelta), (ref, jref), (got, jgot)):
        assert abs(a - b) <= TIGHT
    assert delta > 0  # the perturbation costs quality on every metric
    tol = delta + 1e-3
    report = serving.check_precision_quality(oracle, served, y=yy, metric=metric, tolerance=tol,
                                             precision="bf16")
    assert report == jserving.check_precision_quality(oracle, served, y=yy, metric=metric,
                                                      tolerance=tol, precision="bf16")
    with pytest.raises(serving.PrecisionQualityError, match=f"{name} dropped {delta:.6f}"):
        serving.check_precision_quality(oracle, served, y=yy, metric=metric, precision="bf16",
                                        tolerance=delta / 2)


def test_quality_gate_refuses_bad_arguments_like_the_reference():
    oracle, _, _, _ = _score_cases()
    for mod in (serving, jserving):
        with pytest.raises(ValueError, match="multilabel"):
            mod.check_precision_quality(oracle, oracle, metric="map")
        with pytest.raises(ValueError, match="unknown quality metric"):
            mod.check_precision_quality(oracle, oracle, metric="psnr")
        with pytest.raises(ValueError, match="shapes differ"):
            mod.precision_quality_delta(oracle, oracle[:, :3])
    assert serving.PRECISION_QUALITY_TOLERANCES == jserving.PRECISION_QUALITY_TOLERANCES


def test_evaluators_match_the_reference():
    oracle, served, y, multilabel = _score_cases(1)
    pred = served.argmax(axis=1)
    got, want = MulticlassClassifierEvaluator(6).evaluate(pred, y), JMulticlass(6).evaluate(pred, y)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_allclose(got.per_class_accuracy, want.per_class_accuracy, rtol=0, atol=TIGHT)
    assert abs(got.total_accuracy - want.total_accuracy) <= TIGHT
    assert abs(got.macro_f1 - want.macro_f1) <= TIGHT
    assert got.summary() == want.summary()
    b_pred, b_act = served[:, 0] > 0, oracle[:, 0] > 0.2
    got = BinaryClassifierEvaluator.evaluate(b_pred, b_act, scores=served[:, 0])
    want = JBinary.evaluate(b_pred, b_act, scores=served[:, 0])
    assert got.summary() == want.summary()
    for key in ("tp", "fp", "tn", "fn", "accuracy", "precision", "recall", "f1", "auc"):
        assert abs(getattr(got, key) - getattr(want, key)) <= TIGHT, key
    for eleven in (True, False):
        got = MeanAveragePrecisionEvaluator(6, eleven_point=eleven).evaluate(served, multilabel)
        want = JMAP(6, eleven_point=eleven).evaluate(served, multilabel)
        np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], rtol=0, atol=TIGHT)
        assert abs(got["map"] - want["map"]) <= TIGHT


def _flip_case():
    """Identity PCA over 2 features; rows [1, 1 + 2**-10] (+ a row offset
    of 2**-3 times an integer, exact in bfloat16)."""
    comps, mean = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
    base = (np.arange(16, dtype=np.float32) / 8.0 + 1.0)[:, None]
    X = np.concatenate([base, base * (1 + 2.0**-10)], axis=1).astype(np.float32)
    return comps, mean, X


def test_qualify_refuses_a_bf16_engine_naming_metric_and_delta():
    comps, mean, X = _flip_case()
    port_cp = serving.CompiledPipeline(FusedTransformer([PCATransformer(comps, mean, device="cpu")]),
                                       max_batch=16, devices=["cpu"], precision="bf16")
    ref_cp = jserving.CompiledPipeline(JPCATransformer(comps, mean), max_batch=16, devices=1,
                                       precision="bf16", name="port-flip")
    for cp, error in ((port_cp, serving.PrecisionQualityError),
                      (ref_cp, jserving.PrecisionQualityError)):
        with pytest.raises(error, match=r"serve_precision=bf16 refused: multiclass_accuracy dropped 1\.000000"):
            cp.qualify(X)
    # With a tolerance the gate passes, and both reports agree.
    got = port_cp.qualify(X, tolerance=1.0)
    assert got == ref_cp.qualify(X, tolerance=1.0)
    assert got["quality_delta"] == 1.0 and got["score"] == 0.0
    np.testing.assert_array_equal(port_cp(X).argmax(axis=1), np.zeros(16))


def test_qualify_of_an_f32_engine_is_the_identity():
    comps, mean, X = _flip_case()
    cp = serving.CompiledPipeline(FusedTransformer([PCATransformer(comps, mean, device="cpu")]),
                                  max_batch=16, devices=["cpu"])
    report = cp.qualify(X, tolerance=0.0)
    assert report["quality_delta"] == 0.0 and report["within_tolerance"]
    assert report["precision"] == "f32"
    np.testing.assert_array_equal(cp(X).argmax(axis=1), np.ones(16))


def test_warmup_plans_an_unpinned_ladder_against_the_budget(monkeypatch):
    before = serve_plan_counters.snapshot()
    # In 8 floats and out 3 per row: 44 B/row on the CPU. Half of 8 KiB
    # keeps rungs 1..32 (2,772 B) and trims 64 (2,816 more).
    monkeypatch.setattr(pmetrics, "HBM_BUDGET_BYTES", 8192)
    cp = serving.CompiledPipeline(_chain(), max_batch=64, devices=["cpu"])
    assert cp.ladder == (1, 2, 4, 8, 16, 32, 64)  # planned at warmup
    cp.warmup((8,))
    plan = cp.stats()["plan"]
    assert plan["enabled"] and plan["provenance"] == "model" and plan["bytes_per_row"] == 44.0
    assert plan["trimmed"] == [64] and cp.ladder == (1, 2, 4, 8, 16, 32) and cp.max_batch == 32
    assert serve_plan_counters.snapshot()["buckets_trimmed"] - before.get("buckets_trimmed", 0) == 1
    assert cp.compiles_by_bucket == {b: 1 for b in cp.ladder}
    # Oversize batches chunk through the trimmed top rung.
    X = np.random.default_rng(0).normal(size=(70, 8)).astype(np.float32)
    full = serving.CompiledPipeline(_chain(), buckets=[1, 2, 4, 8, 16, 32], devices=["cpu"])
    np.testing.assert_array_equal(cp(X), full(X))


def test_pinned_ladders_and_a_disabled_planner_are_left_alone(monkeypatch):
    monkeypatch.setattr(pmetrics, "HBM_BUDGET_BYTES", 1)
    cp = serving.CompiledPipeline(_chain(), buckets=[8, 64], devices=["cpu"]).warmup((8,))
    assert cp.ladder == (8, 64) and cp.stats()["plan"] == {"enabled": False, "reason": "ladder pinned"}
    monkeypatch.setenv("KEYSTONE_SERVE_BUCKETS", "4,32")
    cp = serving.CompiledPipeline(_chain(), devices=["cpu"]).warmup((8,))
    assert cp.ladder == (4, 32) and cp.stats()["plan"]["reason"] == "ladder pinned"
    monkeypatch.delenv("KEYSTONE_SERVE_BUCKETS")
    pconfig.plan_resources = False
    cp = serving.CompiledPipeline(_chain(), max_batch=16, devices=["cpu"]).warmup((8,))
    assert cp.ladder == (1, 2, 4, 8, 16)
    assert cp.stats()["plan"]["reason"] == "config.plan_resources off"


def test_reprice_ladder_builds_what_is_missing():
    cp = serving.CompiledPipeline(_chain(), max_batch=8, devices=["cpu", "cpu"])
    assert not cp.reprice_ladder([2, 8])  # not warmed
    cp.warmup((8,))
    assert cp.compile_count == 2 * 4
    assert cp.reprice_ladder([3, 8])
    assert cp.ladder == (3, 8) and cp.base_ladder == (1, 2, 4, 8)
    assert cp.compile_count == 2 * 5  # bucket 3 on both replicas
    assert not cp.reprice_ladder([3, 8])
