"""The port's streamed pieces held against the JAX package.

- ``loaders/stream.py``: the same batches as the reference's
  ``BatchIterator.from_arrays``, bit for bit and in order; the prefetcher's
  contract (errors raised at the consumer, depth 0 passes through, at most
  ``depth`` queued, the thread stopped by ``close()`` or by an abandoned
  consumer, ``map_batches`` on the prefetch thread).
- ``Transformer.apply_batches``: equal to ``apply_in_batches``, labels passed
  through.
- ``CenterCornerPatcher`` and ``AugmentedExamplesEvaluator``: equal to the
  reference's (exact: crops, flips and a mean over views).
- ``block_coordinate_descent_streamed``: within rtol 1e-4, atol 1e-4 of the
  reference's (its ``RowMatrix`` B on the suite's 8-device mesh, whose sums
  run in another order), as ``tests/test_linalg.py`` holds the reference's
  own; within rtol 1e-5, atol 1e-5 of the port's dense solve on the same
  problem (float32 rounding of the inverses, formed one block at a time
  instead of batched).
- ``BlockWeightedLeastSquaresEstimator(stream=True)``: W and b within rtol
  1e-4, atol 1e-4 of the reference's.
- Checkpoints (the port's own format): a solve stopped by a hook and resumed
  gives the uninterrupted W bit for bit; epoch saves resume across the dense
  and streamed solves within 1e-5.

Every problem has n ≫ d, so the ridge grams are well conditioned.
"""

import gc
import os
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import keystone_tpu_torch.linalg.bcd as pbcd
import keystone_tpu_torch.nodes.learning.block_least_squares as pbls
from keystone_tpu.evaluation.augmented import AugmentedExamplesEvaluator as JAugmented
from keystone_tpu.linalg import RowMatrix, assemble_blocks
from keystone_tpu.linalg import block_coordinate_descent_streamed as j_bcd_streamed
from keystone_tpu.loaders.stream import BatchIterator as JBatchIterator
from keystone_tpu.nodes.images import CenterCornerPatcher as JCenterCornerPatcher
from keystone_tpu.nodes.learning import BlockWeightedLeastSquaresEstimator as JBlockWLS
from keystone_tpu_torch.evaluation.augmented import AugmentedExamplesEvaluator
from keystone_tpu_torch.linalg.bcd import block_coordinate_descent, block_coordinate_descent_streamed
from keystone_tpu_torch.loaders.stream import (
    BatchIterator,
    PrefetchIterator,
    prefetch_batches,
    prefetched,
)
from keystone_tpu_torch.nodes.images.patches import CenterCornerPatcher
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats.normalizer import L2Normalizer
from keystone_tpu_torch.utils.stages import StageTimer
from keystone_tpu_torch.workflow import FusedTransformer, Transformer

REF_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(n=150, d=40, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) + 0.3 * rng.normal(size=(1, d))
    y = rng.choice(k, size=n, p=np.linspace(1, 3, k) / np.linspace(1, 3, k).sum())
    Y = 2.0 * np.eye(k)[y] - 1.0 + 0.1 * (X[:, :k] @ rng.normal(size=(k, k)))
    return X.astype(np.float32), Y.astype(np.float32), y


def _weights(y, k, mixture_weight=0.5):
    counts = np.maximum(np.bincount(y, minlength=k), 1)
    return ((1 - mixture_weight) + mixture_weight * len(y) / (k * counts))[y].astype(np.float32)


# -- loaders/stream.py ----------------------------------------------------


@pytest.mark.parametrize("batch_rows, labelled", [(7, True), (50, True), (64, False)])
def test_batches_equal_the_reference(batch_rows, labelled):
    X = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    y = np.arange(50, dtype=np.int32) if labelled else None
    want = list(JBatchIterator.from_arrays(X, y, batch_rows))
    for source in (BatchIterator.from_arrays(X, y, batch_rows),
                   BatchIterator.from_arrays(X, y, batch_rows).prefetch(2)):
        for _ in range(2):  # re-iterable
            got = list(source)
            assert len(got) == len(want)
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                assert (gy is None) == (wy is None)
                if gy is not None:
                    np.testing.assert_array_equal(gy, wy)


def test_producer_error_is_raised_at_next():
    def gen():
        yield 1
        yield 2
        raise KeyError("upstream")

    it = PrefetchIterator(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="upstream"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_depth_zero_passes_through_and_negative_is_refused():
    src = iter([1, 2])
    assert prefetch_batches(src, 0) is src
    with prefetched(src, 0) as same:
        assert same is src
    with pytest.raises(ValueError):
        PrefetchIterator([1], depth=0)
    with pytest.raises(ValueError):
        prefetch_batches([1], -1)


def test_queue_never_holds_more_than_depth():
    it = PrefetchIterator(range(40), depth=3)
    got = []
    for x in it:
        time.sleep(0.002)  # a slow consumer lets the queue fill
        got.append(x)
    assert got == list(range(40))
    assert 1 <= it.max_queued <= 3


def _endless():
    i = 0
    while True:
        yield i
        i += 1


def test_close_stops_a_producer_blocked_on_a_full_queue():
    it = PrefetchIterator(_endless(), depth=2)
    assert next(it) == 0
    time.sleep(0.05)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    with prefetched(_endless(), 2) as src:
        assert next(src) == 0
        thread = src._thread
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_an_abandoned_consumer_stops_the_thread():
    it = PrefetchIterator(_endless(), depth=2)
    assert next(it) == 0
    thread = it._thread
    del it
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_map_batches_runs_on_the_prefetch_thread():
    seen = []

    def fn(X):
        seen.append(threading.current_thread().name)
        return X * 2

    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = list(BatchIterator.from_arrays(X, None, 4).map_batches(fn).prefetch(2))
    np.testing.assert_array_equal(np.concatenate([g for g, _ in got]), X * 2)
    assert seen == ["keystone-prefetch"] * 2


# -- apply_batches, patches, augmented evaluation ---------------------------


class _Double(Transformer):
    def apply_batch(self, X):
        return 2 * X


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_apply_batches_equals_apply_in_batches(depth):
    X = np.random.default_rng(2).normal(size=(37, 5)).astype(np.float32)
    y = np.arange(37)
    pipe = FusedTransformer([_Double(), L2Normalizer()])
    want = pipe.apply_in_batches(X, batch_size=8, device="cpu")
    got = list(pipe.apply_batches(BatchIterator.from_arrays(X, y, 8), prefetch_depth=depth, device="cpu"))
    assert [len(o) for o, _ in got] == [8, 8, 8, 8, 5]
    torch.testing.assert_close(torch.cat([o for o, _ in got]), want, rtol=0, atol=0)
    np.testing.assert_array_equal(np.concatenate([lab for _, lab in got]), y)
    bare = list(pipe.apply_batches((X[i : i + 10] for i in range(0, 37, 10)), device="cpu"))
    assert all(lab is None for _, lab in bare)
    torch.testing.assert_close(torch.cat([o for o, _ in bare]), want, rtol=0, atol=0)


@pytest.mark.parametrize("with_flips", [True, False])
@pytest.mark.parametrize("shape, crop", [((2, 9, 12, 3), 7), ((3, 16, 11, 1), 11), ((1, 8, 8, 3), 8)])
def test_center_corner_patcher_equals_the_reference(shape, crop, with_flips):
    X = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(JCenterCornerPatcher(crop, with_flips).apply_batch(X))
    patcher = CenterCornerPatcher(crop, with_flips)
    got = patcher(torch.from_numpy(X))
    assert patcher.num_views == JCenterCornerPatcher(crop, with_flips).num_views
    assert got.shape == (shape[0] * patcher.num_views, crop, crop, shape[3])
    np.testing.assert_array_equal(got.numpy(), want)
    assert not patcher.row_independent


def test_center_corner_patcher_refuses_a_crop_larger_than_the_image():
    with pytest.raises(ValueError, match="exceeds"):
        CenterCornerPatcher(10)(torch.zeros(1, 9, 12, 3))


def test_augmented_evaluator_equals_the_reference():
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(6 * 10, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=6)
    port, ref = AugmentedExamplesEvaluator(10), JAugmented(10)
    np.testing.assert_allclose(port.average_scores(torch.from_numpy(scores)).numpy(),
                               ref.average_scores(scores), rtol=1e-6, atol=1e-7)
    for k in (1, 3):
        assert port.top_k_error(scores, labels, k) == pytest.approx(ref.top_k_error(scores, labels, k))
    with pytest.raises(ValueError, match="not divisible"):
        port.average_scores(scores[:-1])


# -- the streamed solve -------------------------------------------------------


@pytest.mark.parametrize(
    "weighted, d, centered",
    [(False, 48, False), (True, 48, False), (True, 40, False), (True, 40, True)],
    ids=["unweighted", "weighted", "ragged", "centered"],
)
def test_streamed_bcd_matches_the_reference_and_the_dense_solve(weighted, d, centered):
    X, Y, y = _problem(d=d, seed=5)
    w = _weights(y, 3) if weighted else None
    center = X.mean(axis=0) if centered else None
    lam, iters, block = 0.3, 3, 16
    Wj, blocks_j = j_bcd_streamed(
        X, RowMatrix.from_array(Y), block, iters, lam=lam,
        row_weights=None if w is None else jax.numpy.asarray(w), col_center=center,
    )
    tw = None if w is None else torch.from_numpy(w)
    Wp, blocks_p = block_coordinate_descent_streamed(
        X, torch.from_numpy(Y), block, iters, lam=lam, row_weights=tw, col_center=center,
    )
    assert [tuple(b) for b in blocks_j] == blocks_p
    np.testing.assert_allclose(torch.cat(Wp).numpy(), np.asarray(assemble_blocks(Wj)), **REF_TOL)
    A = torch.from_numpy(X if center is None else X - center)
    Wd, _ = block_coordinate_descent(A, torch.from_numpy(Y), block, iters, lam=lam, row_weights=tw, cache_grams=True)
    torch.testing.assert_close(torch.cat(Wp), torch.cat(Wd), **DENSE_TOL)


def test_streamed_bcd_leaves_A_alone_and_marks_its_epochs():
    X, Y, _ = _problem(seed=6)
    X.flags.writeable = False  # nothing may write to the caller's array
    before = X.copy()
    with StageTimer("cpu") as timer:
        W, _ = block_coordinate_descent_streamed(X, torch.from_numpy(Y), 16, 2, lam=0.1,
                                                 col_center=X.mean(axis=0))
    np.testing.assert_array_equal(X, before)
    assert list(timer.seconds()) == ["BCD epoch 1", "BCD epoch 2"]
    rows = timer.notes["streamed BCD blocks"]
    assert [(r["epoch"], r["block"], r["first"]) for r in rows] == [
        (e, i, e == 0) for e in range(2) for i in range(3)
    ]
    assert all(r["copy_ms"] == 0.0 and r["prep_ms"] >= 0 and r["update_ms"] >= 0 for r in rows)


def test_streamed_bcd_serialized_equals_overlapped():
    X, Y, y = _problem(seed=7)
    w = torch.from_numpy(_weights(y, 3))
    runs = [
        torch.cat(block_coordinate_descent_streamed(X, torch.from_numpy(Y), 16, 2, lam=0.1, row_weights=w,
                                                    overlap=overlap)[0])
        for overlap in (True, False)
    ]
    assert torch.equal(runs[0], runs[1])


def test_streamed_bcd_refuses_a_row_count_mismatch():
    X, Y, _ = _problem(seed=8)
    with pytest.raises(ValueError, match="must match"):
        block_coordinate_descent_streamed(X[:-1], torch.from_numpy(Y), 16, 1)


@pytest.mark.parametrize("mixture_weight", [0.0, 0.5])
def test_streamed_estimator_matches_the_reference(mixture_weight):
    X, Y, _ = _problem(n=200, d=40, seed=9)
    kw = dict(block_size=16, num_iters=3, lam=0.2, mixture_weight=mixture_weight)
    want = JBlockWLS(stream=True, **kw).fit(X, Y)
    before = X.copy()
    got = BlockWeightedLeastSquaresEstimator(stream=True, device="cpu", **kw).fit(X, Y)
    np.testing.assert_array_equal(X, before)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **REF_TOL)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), **REF_TOL)
    dense = BlockWeightedLeastSquaresEstimator(stream=False, device="cpu", **kw).fit(X, Y)
    torch.testing.assert_close(got.W, dense.W, **DENSE_TOL)
    torch.testing.assert_close(got.b, dense.b, **DENSE_TOL)


def test_auto_stream_rule_streams_just_above_half_the_budget(monkeypatch):
    """The reference's rule: the data's float32 bytes over half the budget
    stream, wherever the data lies."""
    assert pbls.HBM_BUDGET_BYTES // 2 == 6 * 2**30
    X, Y, _ = _problem(n=64, d=16, seed=10)
    calls = []
    real = pbls.block_coordinate_descent_streamed
    monkeypatch.setattr(pbls, "block_coordinate_descent_streamed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    est = BlockWeightedLeastSquaresEstimator(block_size=16, num_iters=1, device="cpu")
    monkeypatch.setattr(pbls, "HBM_BUDGET_BYTES", 2 * X.nbytes)  # half the budget = A's bytes
    est.fit(X, Y)
    assert calls == []
    monkeypatch.setattr(pbls, "HBM_BUDGET_BYTES", 2 * X.nbytes - 2)
    est.fit(X, Y)
    assert calls == [1]
    est.fit(torch.from_numpy(X), torch.from_numpy(Y))  # a host tensor streams too
    assert calls == [1, 1]
    est.fit(X.astype(np.float64), Y)  # float32 bytes decide, not the array's own
    assert calls == [1, 1, 1]
    # So does a tensor that is not on the host (here one with no storage:
    # the rule reads its shape only).
    routed = []
    monkeypatch.setattr(BlockWeightedLeastSquaresEstimator, "_fit_streamed",
                        lambda self, data, labels: routed.append(data.device.type))
    est.fit(torch.empty(X.shape, device="meta"), torch.from_numpy(Y))
    assert routed == ["meta"]
    monkeypatch.setattr(pbls, "HBM_BUDGET_BYTES", 2 * X.nbytes)
    with pytest.raises(NotImplementedError):  # the dense path, which a meta tensor cannot run
        est.fit(torch.empty(X.shape, device="meta"), torch.from_numpy(Y))
    assert routed == ["meta"]


# -- checkpoints ----------------------------------------------------------------


class _Stop(Exception):
    pass


def _stop_after(monkeypatch, updates):
    """Makes the solve raise at block update number ``updates + 1``."""
    count = [0]
    real = pbcd._solve_update

    def hooked(*args):
        count[0] += 1
        if count[0] > updates:
            raise _Stop
        return real(*args)

    monkeypatch.setattr(pbcd, "_solve_update", hooked)


@pytest.mark.parametrize("stop_after", [3, 7, 9])
def test_a_stopped_solve_resumes_bit_for_bit(monkeypatch, tmp_path, stop_after):
    X, Y, y = _problem(n=120, d=64, seed=11)
    kw = dict(block_size=16, num_iters=3, lam=0.1, row_weights=torch.from_numpy(_weights(y, 3)),
              col_center=X.mean(axis=0))
    want = torch.cat(block_coordinate_descent_streamed(X, torch.from_numpy(Y), **kw)[0])
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _stop_after(m, stop_after)
        with pytest.raises(_Stop):
            block_coordinate_descent_streamed(X, torch.from_numpy(Y), checkpoint_dir=ck, checkpoint_every=2, **kw)
    assert os.path.exists(os.path.join(ck, pbcd.SNAPSHOT))
    got = torch.cat(block_coordinate_descent_streamed(
        X, torch.from_numpy(Y), checkpoint_dir=ck, checkpoint_every=2, **kw)[0])
    assert torch.equal(got, want)
    assert not os.path.exists(os.path.join(ck, pbcd.SNAPSHOT))
    assert sorted(os.listdir(ck)) == ["epoch_1.pt", "epoch_2.pt", "epoch_3.pt"]


@pytest.mark.parametrize("first", ["dense", "streamed"])
def test_epoch_saves_resume_across_the_dense_and_streamed_solves(tmp_path, first):
    X, Y, _ = _problem(n=150, d=32, seed=12)
    center = X.mean(axis=0)
    A, B = torch.from_numpy(X - center), torch.from_numpy(Y)
    want, _ = block_coordinate_descent(A, B, 8, 4, lam=0.1)
    ck = str(tmp_path / "x")
    dense = lambda iters: block_coordinate_descent(A, B, 8, iters, lam=0.1, checkpoint_dir=ck)  # noqa: E731
    streamed = lambda iters: block_coordinate_descent_streamed(  # noqa: E731
        X, B, 8, iters, lam=0.1, checkpoint_dir=ck, col_center=center)
    (dense, streamed)[first == "streamed"](2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the saves belong to this problem
        got, _ = (streamed, dense)[first == "streamed"](4)
    torch.testing.assert_close(torch.cat(got), torch.cat(want), **DENSE_TOL)
    assert sorted(os.listdir(ck)) == [f"epoch_{e}.pt" for e in range(1, 5)]


def test_a_snapshot_of_another_problem_is_ignored_with_a_warning(monkeypatch, tmp_path):
    X, Y, _ = _problem(n=100, d=48, seed=13)
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _stop_after(m, 4)
        with pytest.raises(_Stop):
            block_coordinate_descent_streamed(X, torch.from_numpy(Y), 16, 3, lam=0.1,
                                              checkpoint_dir=ck, checkpoint_every=2)
    want = torch.cat(block_coordinate_descent_streamed(X, torch.from_numpy(Y), 16, 3, lam=0.2)[0])
    with pytest.warns(UserWarning, match="different solve"):
        got = torch.cat(block_coordinate_descent_streamed(X, torch.from_numpy(Y), 16, 3, lam=0.2,
                                                          checkpoint_dir=ck, checkpoint_every=2)[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("streamed", [False, True], ids=["dense", "streamed"])
@pytest.mark.parametrize("lam", [1.9e-3, 0.0])
def test_a_checkpoint_of_another_lambda_is_ignored_with_a_warning(tmp_path, lam, streamed):
    """λ is compared exactly: the probes' relative 1e-3 does not apply to it."""
    X, Y, _ = _problem(n=100, d=32, seed=15)
    A, B = torch.from_numpy(X), torch.from_numpy(Y)
    ck = str(tmp_path / "ck")
    block_coordinate_descent(A, B, 16, 1, lam=1e-3, checkpoint_dir=ck)
    want = torch.cat(block_coordinate_descent(A, B, 16, 1, lam=lam)[0])
    with pytest.warns(UserWarning, match="different solve"):
        if streamed:
            got, _ = block_coordinate_descent_streamed(X, B, 16, 1, lam=lam, checkpoint_dir=ck)
        else:
            got, _ = block_coordinate_descent(A, B, 16, 1, lam=lam, checkpoint_dir=ck)
    torch.testing.assert_close(torch.cat(got), want, **DENSE_TOL)


def test_the_estimator_passes_checkpoints_through(tmp_path):
    X, Y, _ = _problem(n=100, d=32, seed=14)
    ck = str(tmp_path / "est")
    kw = dict(block_size=16, num_iters=2, lam=0.1, device="cpu", checkpoint_dir=ck)
    first = BlockWeightedLeastSquaresEstimator(stream=True, **kw).fit(X, Y)
    assert sorted(os.listdir(ck)) == ["epoch_1.pt", "epoch_2.pt"]
    # A dense refit of the same problem starts from the last epoch: nothing is left to do.
    again = BlockWeightedLeastSquaresEstimator(stream=False, **kw).fit(X, Y)
    torch.testing.assert_close(again.W, first.W, **DENSE_TOL)
