"""The port's ``PipelineService`` micro-batcher on the CPU.

Held to the reference's contract (``keystone_tpu/workflow/serving.py``
``PipelineService``): coalesced answers equal the engine's direct ones,
concurrent clients each get their own rows, ``QueueFullError`` at
``max_pending``, ``DeadlineExceeded`` for requests that expire in the
queue or while their group waits for a replica's window, the
``worker_death`` and ``replica_death`` fault sites of a ``FaultPlan``
recovered with no future left unresolved (a fully dead pool revived), and
``close()`` resolving every future with and without drain. The outcome
counters count what was rejected and what expired. ``FaultPlan`` fires
the reference's sequence for the same spec and seed, and ``RetryPolicy``
backs off by the reference's delays.

To hold the service at a chosen point, a test gates the engine's
``_complete_chunk`` on an event: collecting a chunk then waits until the
test opens the gate, which keeps the replica's window full (or, on the
serial path, the dispatcher busy).

Every test runs its body on a thread under a time limit of its own
(``time_limit``), so that a hang fails that test instead of eating the
suite's clock.
"""

import functools
import threading
import time

import numpy as np
import pytest

from keystone_tpu_torch.config import config
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLinearMapper
from keystone_tpu_torch.nodes.learning.pca import PCATransformer
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.utils.metrics import reliability_counters
from keystone_tpu.utils.reliability import FaultPlan as JFaultPlan
from keystone_tpu.utils.reliability import RetryPolicy as JRetryPolicy
from keystone_tpu_torch.utils.reliability import (
    DeadlineExceeded,
    FaultPlan,
    QueueFullError,
    RetryPolicy,
    ServiceClosed,
    WorkerDiedError,
    reset_fault_plan,
)
from keystone_tpu_torch.workflow import FusedTransformer
from keystone_tpu_torch.workflow.serving import CompiledPipeline, PipelineService

D = 8
RESULT_S = 20.0  # longest wait for one future


def time_limit(seconds: float):
    """Runs the test's body on a daemon thread and fails the test if it
    has not finished within ``seconds``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # handed to the test's own thread
                    box["error"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} did not finish within {seconds} s")
            if "error" in box:
                raise box["error"]

        return run

    return wrap


def _chain(seed=0):
    rng = np.random.default_rng(seed)
    comps, _ = np.linalg.qr(rng.normal(size=(D, D)))
    return FusedTransformer([
        PCATransformer(comps.astype(np.float32), rng.normal(size=D).astype(np.float32), device="cpu"),
        L2Normalizer(),
        BlockLinearMapper(rng.normal(size=(D, 3)).astype(np.float32), [(0, 4), (4, D)],
                          rng.normal(size=3).astype(np.float32), device="cpu"),
    ])


def _engine(devices=("cpu",), max_batch=8, inflight=None):
    return CompiledPipeline(_chain(), max_batch=max_batch, devices=list(devices),
                            inflight=inflight).warmup((D,))


def _gate(monkeypatch, engine):
    """Makes collecting a chunk wait for the returned event."""
    gate = threading.Event()
    collect = engine._complete_chunk

    def gated(lc):
        gate.wait(RESULT_S)
        return collect(lc)

    monkeypatch.setattr(engine, "_complete_chunk", gated)
    return gate


def _rows(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _wait_until(cond, seconds=5.0):
    end = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


@pytest.fixture(autouse=True)
def _no_faults():
    saved = (config.faults, config.faults_seed)
    yield
    config.faults, config.faults_seed = saved
    reset_fault_plan()


@pytest.mark.parametrize("devices, inflight", [(("cpu",), 1), (("cpu", "cpu", "cpu"), 2)])
@time_limit(60)
def test_coalesced_answers_equal_direct_ones(devices, inflight):
    engine = _engine(devices, inflight=inflight)
    X = _rows(24)
    want = engine(X)
    with PipelineService(engine, max_delay_ms=50.0, inflight=inflight) as svc:
        futs = [svc.submit(x) for x in X[:20]]  # single examples
        futs.append(svc.submit(X[20:24]))  # one small batch
        got = [f.result(RESULT_S) for f in futs]
        stats = svc.stats()
    for i in range(20):
        assert got[i].shape == (3,)
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[20], want[20:24])
    assert stats["pipelined"] == (len(devices) > 1 or inflight > 1)
    assert stats["rows_served"] == 24 and stats["requests"] == 21
    assert stats["batches_run"] < 21  # requests were coalesced
    assert stats["outcomes"] == {"ok": 21}
    assert stats["latency"]["count"] == 21


@time_limit(90)
def test_concurrent_clients_each_get_their_rows():
    engine = _engine(("cpu", "cpu"), inflight=2)
    X = _rows(160, seed=2)
    want = engine(X)
    results = {}
    with PipelineService(engine, max_delay_ms=1.0) as svc:

        def client(c):
            futs = [(i, svc.submit(X[i])) for i in range(c, 160, 8)]
            results.update({i: f.result(RESULT_S) for i, f in futs})

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        stats = svc.stats()
    assert sorted(results) == list(range(160))
    for i, r in results.items():
        np.testing.assert_array_equal(r, want[i])
    assert stats["outcomes"] == {"ok": 160}
    assert sum(stats["compiled"]["replica_dispatches"].values()) >= stats["batches_run"]


@time_limit(60)
def test_queue_full_rejects_fast_and_counts(monkeypatch):
    engine = _engine(inflight=1)
    gate = _gate(monkeypatch, engine)
    before = reliability_counters.get("requests_rejected")
    svc = PipelineService(engine, max_delay_ms=0.0, max_pending=3, inflight=1)
    try:
        first = svc.submit(_rows(1)[0])
        _wait_until(lambda: svc.queue_depth() == 0)  # the dispatcher holds it
        queued = [svc.submit(_rows(1, seed=s)[0]) for s in range(3)]
        with pytest.raises(QueueFullError, match="capacity"):
            svc.submit(_rows(1)[0])
        gate.set()
        for f in [first, *queued]:
            f.result(RESULT_S)
        stats = svc.stats()
    finally:
        gate.set()
        svc.close()
    assert stats["rejected"] == 1 and stats["outcomes"]["rejected"] == 1
    assert stats["outcomes"]["ok"] == 4
    assert reliability_counters.get("requests_rejected") - before == 1


@time_limit(60)
def test_deadline_expires_in_the_queue(monkeypatch):
    engine = _engine(inflight=1)
    gate = _gate(monkeypatch, engine)
    svc = PipelineService(engine, max_delay_ms=0.0, inflight=1)
    try:
        first = svc.submit(_rows(1)[0])
        _wait_until(lambda: svc.queue_depth() == 0)
        late = svc.submit(_rows(1)[0], deadline_ms=20.0)
        patient = svc.submit(_rows(1)[0])
        time.sleep(0.1)
        gate.set()
        first.result(RESULT_S)
        patient.result(RESULT_S)
        with pytest.raises(DeadlineExceeded):
            late.result(RESULT_S)
        stats = svc.stats()
    finally:
        gate.set()
        svc.close()
    assert stats["expired"] == 1
    assert stats["outcomes"] == {"expired": 1, "ok": 2}


@time_limit(60)
def test_deadline_expires_while_waiting_for_a_slot(monkeypatch):
    engine = _engine(("cpu", "cpu"), inflight=1)
    gate = _gate(monkeypatch, engine)
    svc = PipelineService(engine, max_delay_ms=0.0, max_rows=1, inflight=1)
    try:
        busy = [svc.submit(_rows(1, seed=s)[0]) for s in range(2)]
        # Both windows fill, one one-row group each.
        _wait_until(lambda: svc.stats()["inflight"] == 2)
        waiting = svc.submit(_rows(1)[0], deadline_ms=50.0)
        # The dispatcher takes it and waits for a slot.
        _wait_until(lambda: svc.queue_depth() == 0)
        time.sleep(0.15)
        gate.set()
        for f in busy:
            f.result(RESULT_S)
        with pytest.raises(DeadlineExceeded):
            waiting.result(RESULT_S)
        stats = svc.stats()
    finally:
        gate.set()
        svc.close()
    assert stats["expired"] == 1 and stats["outcomes"] == {"expired": 1, "ok": 2}
    assert stats["inflight"] == 0 and stats["replicas"]["outstanding"] == [0, 0]


@time_limit(60)
def test_injected_worker_death_restarts_the_dispatcher(monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    config.faults = "worker_death:1"
    reset_fault_plan()
    engine = _engine(inflight=1)
    X = _rows(2)
    want = engine(X)
    svc = PipelineService(engine, max_delay_ms=0.0, inflight=1)
    try:
        first = svc.submit(X[0])
        _wait_until(lambda: not svc._worker.is_alive())  # died before taking it
        second = svc.submit(X[1])  # detects the death and restarts it
        np.testing.assert_array_equal(first.result(RESULT_S), want[0])
        np.testing.assert_array_equal(second.result(RESULT_S), want[1])
        stats = svc.stats()
    finally:
        svc.close()
    assert stats["worker_restarts"] == 1 and stats["worker_alive"]
    assert stats["outcomes"] == {"ok": 2}


class _Crash(BaseException):
    """Kills the dispatcher thread the way an uncaught error would."""


@time_limit(60)
def test_a_dead_dispatcher_fails_the_requests_it_held(monkeypatch):
    engine = _engine(inflight=1)
    svc = PipelineService(engine, max_delay_ms=0.0, inflight=1)
    flush = svc._flush

    def crash(group):
        monkeypatch.setattr(svc, "_flush", flush)
        raise _Crash()

    monkeypatch.setattr(svc, "_flush", crash)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    try:
        held = svc.submit(_rows(1)[0])
        _wait_until(lambda: not svc._worker.is_alive())
        after = svc.submit(_rows(1)[0])
        with pytest.raises(WorkerDiedError):
            held.result(RESULT_S)
        after.result(RESULT_S)
    finally:
        svc.close()
    assert svc.worker_restarts == 1


@pytest.mark.parametrize("deaths", [1, 2])
@time_limit(60)
def test_replica_death_redispatches_with_no_future_stranded(deaths):
    config.faults = f"replica_death:{deaths}"
    reset_fault_plan()
    engine = _engine(("cpu", "cpu"), max_batch=4, inflight=2)
    X = _rows(40, seed=3)
    want = engine(X)
    svc = PipelineService(engine, max_delay_ms=0.0, max_rows=4)
    try:
        futs = [svc.submit(X[i : i + 4]) for i in range(0, 40, 4)]
        got = [f.result(RESULT_S) for f in futs]
        stats = svc.stats()
        after = svc.submit(X[:4])  # a later submit revives any dead replica
        np.testing.assert_array_equal(after.result(RESULT_S), want[:4])
        revived = svc.stats()["replicas"]
    finally:
        svc.close()
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert stats["replicas"]["deaths"] == deaths
    assert stats["outcomes"] == {"ok": 10}
    assert revived["dead"] == [False, False] and revived["revivals"] == deaths
    assert all(f.done() for f in futs)


@pytest.mark.parametrize("drain", [True, False])
@time_limit(60)
def test_close_resolves_every_future(monkeypatch, drain):
    engine = _engine(inflight=1)
    gate = _gate(monkeypatch, engine)
    svc = PipelineService(engine, max_delay_ms=0.0, inflight=1)
    futs = [svc.submit(_rows(1, seed=0)[0])]
    _wait_until(lambda: svc.queue_depth() == 0)  # held by the dispatcher
    futs += [svc.submit(_rows(1, seed=s)[0]) for s in range(1, 5)]
    if drain:
        gate.set()
        svc.close()
        assert all(f.result(RESULT_S) is not None for f in futs)
        assert svc.stats()["outcomes"] == {"ok": 5}
    else:
        svc.close(drain=False, join_s=0.2)
        for f in futs:
            with pytest.raises(ServiceClosed):
                f.result(RESULT_S)
        gate.set()  # the held flush ends late; its futures stay failed
        svc._worker.join(RESULT_S)
        assert svc.stats()["outcomes"] == {"closed": 5}
    assert all(f.done() for f in futs)
    with pytest.raises(ServiceClosed):
        svc.submit(_rows(1)[0])
    svc.close()  # idempotent


def test_service_refuses_a_cold_engine_and_bad_limits():
    with pytest.raises(RuntimeError, match="warmed"):
        PipelineService(CompiledPipeline(_chain(), max_batch=4, devices=["cpu"]))
    engine = _engine()
    for kw in (dict(max_rows=0), dict(max_pending=0), dict(inflight=0)):
        with pytest.raises(ValueError):
            PipelineService(engine, **kw)
    with PipelineService(engine) as svc:
        with pytest.raises(ValueError, match="does not match"):
            svc.submit(np.ones(D + 1, np.float32))


def test_fault_plan_and_retry_policy_follow_the_reference():
    spec = "worker_death:2, replica_death:0.3, io:0.05"
    mine, ref = FaultPlan(spec, seed=7), JFaultPlan(spec, seed=7)
    assert mine.sites == ref.sites
    for site in ("worker_death", "replica_death", "io", "oom"):
        assert [mine.check(site) for _ in range(60)] == [ref.check(site) for _ in range(60)]
    assert mine.fired == ref.fired and mine.checked == ref.checked
    for bad in ("io", "io:1.5", "io:-1", ":3"):
        with pytest.raises(ValueError, match="KEYSTONE_FAULTS token"):
            FaultPlan(bad)
    kw = dict(max_attempts=5, base_delay=0.01, max_delay=0.05, seed=3)
    assert [RetryPolicy(**kw).delay(i) for i in range(6)] == [JRetryPolicy(**kw).delay(i) for i in range(6)]
    calls, pauses = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return 5

    policy = RetryPolicy(max_attempts=4, seed=0, sleep=pauses.append)
    assert policy.call(flaky, site="t") == 5 and len(calls) == 3 and len(pauses) == 2
    with pytest.raises(FileNotFoundError):  # not transient: raised at once
        policy.call(lambda: (_ for _ in ()).throw(FileNotFoundError("gone")))
