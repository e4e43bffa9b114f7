#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failed check raises and the
script exits non-zero:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. builds every CUDA kernel of the port from ``keystone_tpu_torch/csrc``
   and prints what ``ptxas`` and the runtime say of its blocks (registers,
   spills, shared memory, blocks resident per SM);
3. holds the Fisher-vector kernel against its plain PyTorch version on the
   card at full width (B=4, m=3721, d=64, k=256), at B=1, at ragged m,
   with variances near the 1e-4 floor, at the floor with means fifty
   standard deviations from 0, and on a mixture the port's EM fits to such
   descriptors at VOC's shape, checks that two launches give the
   same bits, and at every serving bucket a request of 1, 3, 16 or 64
   images reaches (B = 1, 4, 16, 64) holds it against the plain version
   again and times both;
4. serves 256×256 synthetic images through the 65,536-feature
   ImageNetSiftLcsFV pipeline with 1,000 classes and seeded random
   parameters through ``CompiledPipeline(max_batch=64)``: the memory plan,
   one CUDA graph per bucket (capture seconds and pool bytes per bucket,
   device memory with all of them resident), requests of 1, 3, 16 and 64
   images through the graphs (the main path: 2 Fisher-vector launches a
   replay, and a ``torch.profiler`` trace of one replay listing each of
   the kernel's two kernels twice), their median walls beside the eager
   chain's on the same requests, the eager stage breakdown and the
   profiler's idle share at 1 and 64 images for both; every bucket's
   graphed top-5 and scores bit-equal to the eager chain's; a
   ``PipelineService`` (8 client threads × 64 one-image requests, in a
   burst and in a closed loop: requests/s, p50 and p99, batches and rows
   a batch, no stranded future, every answer held against the engine's
   direct call); and the scores
   against the same pipeline with the plain Fisher-vector version on the
   card and against the port on the CPU;
5. fits the pipeline at reduced size (64×64 images, ``gmm_k=16``,
   ``pca_dims=16``, 16 classes, 256 images) on the card and on the CPU from
   one seed, and checks that the PCA (up to sign), the GMM and the test
   scores agree and that the test errors are within one point;
6. fits it at full width (the reference's real-data settings: 65,536
   features, 1,000 classes, 8 blocks of 8,192, 3 epochs) on 8,192 training
   and 512 test 256×256 synthetic images, printing each stage's seconds
   between CUDA events, the Fisher-vector launches of the fit (one per
   branch and training batch), the objective after each epoch (it may not
   grow by more than a relative 1e-3), the train and test errors and the
   peak device memory, and checks the train error and, in float64, the
   last block's normal equations (the fit goes through the graph executor,
   and its peak may exceed the eager chain's 18.4 GiB by at most 1 GiB);
   then the ``workflow`` phase on the same images: the optimizer's plan
   for the graph fit (operators before and after each rule batch, the
   fused chains, the decision log), the node-level solver choice on the
   8,192 x 65,536 features bit-equal to the concrete estimator's fit, the
   host cost of ``pipeline(X).get()`` against the fused chain's eager call
   and the engine at 1 and 64 images (an optimizer pass and a walk timed
   apart), the reduced fit twice through a disk fit cache in a temporary
   directory (0 fits and the same bits the second time), the parallel walk
   bit-equal to the serial one, and the auto-cache rule on a prefix with
   two consumers; then serves the fitted pipeline, carried through
   ``convert.py``, with ``CompiledPipeline`` for requests of 1 and 64
   images and checks its top-k against the fitted pipeline's direct call;
   then the precision ladder on the fitted pipeline: engines at ``f32``,
   ``f32h`` and ``bf16``, every bucket bit-equal to its precision's eager
   chain, their walls for 1 and 64 images and ``qualify``'s report on the
   512 test images (with their labels it must pass);
7. on the same images, the head solved streamed from host features
   (``stream=True``) against the eager one on the same features: epoch
   seconds and per-block prep, copy and update medians, double-buffered
   and serialized (the two must give the same bits), device memory above
   the baseline (below A's bytes plus the inverses'), objectives within
   1e-3, W's distance, the last block's normal equations, test errors
   within 0.02; then ``fit_streamed`` and ``score_streamed`` end to end
   with checkpoints (stage seconds, save sizes and seconds, launches, plain
   scoring with the head through ``_scoring_engine`` (its warm-up and
   capture seconds) and ten-view TTA
   errors, plain and TTA scores against the direct call and the views scored
   directly), and a solve stopped after 12 block updates by a hook here
   and resumed from its checkpoints (W within 1e-6 of the uninterrupted);
   the kernel phase also holds and times the kernel at the streamed
   shapes (B=256, and B=250 at m=2,809);
8. the solver's modes on the same features (A 8,192 x 65,536): bfloat16
   storage of A, eager and streamed, and TF32 products (precision
   ``high``), eager, each against the float32 solve at ``highest``
   (objectives per epoch and training scores within 5e-2, W's distance,
   train and test errors, device peak, per-block times when streamed, and
   the last block's visit in float64 on the operands the solve held); then
   the eager solve with its inverses formed one block at a time against
   the batched one and the streamed one on one centered A;
9. real data: 1,000 synsets of 500x375 JPEGs made from a seed in a
   temporary directory (4 training and 1 test image each, half the
   synsets as tars), decode throughput of ``load`` and ``stream_batches``
   against featurizing on the card, the first streamed batch against
   ``load`` bit for bit, and ``run_streamed`` on the JPEGs end to end
   (65,536 features, 3 epochs, 1,000 classes, batches of 256, a balanced
   sample of 512);
10. the other image pipelines at the reference's configs and their
   datasets' real counts: VOCSIFTFisher (20 classes, 5,011 training and
   4,952 test synthetic 128x128 images; SIFT at step 4 and bin 4,
   ``pca_dims=64``, ``gmm_k=16``, 2,048 features) fitted and scored on the
   card (stage seconds, Fisher-vector launches, mAP, peak memory; its test
   scores against the same pipeline with the plain Fisher vector; the
   kernel at its shape, B = 64 and 1, against the plain version and timed
   against the k = 16 bound); MnistRandomFFT (4 FFTs, 4,104 features,
   60,000 and 10,000 rows from IDX files) through ``run``, then both
   solvers on its features (seconds, test error, peak memory), the normal
   equations checked in float64 and the two solutions' distance;
   RandomPatchCifar (256 filters of 6x6, 2,048 features; float32 and
   bfloat16 features) and LinearPixels through ``run`` on 50,000 and
   10,000 images from CIFAR binary files, the convolver against a float64
   convolution; MNIST and CIFAR fitted again at a reduced count on the card
   and on the CPU, features and test errors compared;
11. the speech and text pipelines, which run no hand kernel: TIMIT through
   ``main`` (200,000 training and 50,000 test 440-dim frames from .npz
   files, 147 phone states, 16,384 cosine random features, the head
   streamed from host memory: stage seconds, per-block prep, copy and
   update medians, objectives per epoch, PER, peak memory); Newsgroups
   through ``main`` with naive Bayes and with logistic regression (11,314
   and 7,532 documents written to 20 class directories from a seeded
   Zipfian vocabulary; host front-end seconds apart from the device's
   fit and scoring, L-BFGS steps, accuracy, macro-F1); Amazon through
   ``main`` (65,536 and 16,384 reviews as JSON lines, 20,000 features kept
   as a CSR ``SparseBatch``; accuracy, F1, AUC), then the sparse streamed
   block solver on the same features; and each pipeline at a reduced size
   on the card and on the CPU, scores, predictions and L-BFGS objectives
   compared;
12. the rest of the learning nodes, the descriptors and the native host
   library ("learning suite, descriptors, native"): kernel ridge
   regression on 50,000 of TIMIT's training frames by CG and by Nyström
   PCG (1,024 landmarks), gamma from the median heuristic (the matvec's
   time against its bound, iterations, seconds, peak memory, the float64
   relative residual, test accuracy); ``LeastSquaresEstimator`` on four
   shapes (its choice and reason, seconds, the float64 residual, the
   result equal to the concrete estimator's); LDA on 200,000 frames, and
   card against CPU on 20,000; HOG and DAISY on the full-width phase's
   8,192 images (images/s, device ms a batch, card against CPU); then the
   native library: its build, ``auto`` decode (the pool where it built,
   else PIL, and the batches of each), native SIFT against the device's
   on VOC's images, the native EM against the torch EM at k = 16, native
   Fisher vectors against the kernel at VOC's shape on the native EM's
   mixture (and the kernel against its plain version there), and
   VOCSIFTFisher with native SIFT end to end;
13. one JSON line with every kernel's launches (on every path: serving
   through graphs, the service, fitting, serving what was fitted, the streamed fit, plain and TTA
   streamed scoring, the streamed fit on real data, VOC's fit and scoring, VOC with native SIFT;
   0 on the speech and text pipelines and on the learning nodes and descriptors), error and
   times: ``ms`` is the kernel's device time
   per call at B=64 (``torch.profiler``), ``call_ms`` the same call between
   CUDA events, host included.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest.mock import patch

# Published float32 (non-tensor-core) and dense TF32 tensor-core peaks and
# memory rate of one H100 SXM, NVIDIA's data sheet, at the full 700 W power
# limit.
F32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain version on the card: the kernel's 3xTF32 products keep
# float32-level accuracy, and the two differ in summation order (the kernel
# sums each image's descriptors in splits).
FV_RTOL, FV_ATOL = 1e-4, 1e-5
# Pipeline scores, relative to the largest |score|: card with the plain
# Fisher vectors, and the port on the CPU, against the card with the kernel.
SCORE_RTOL = 1e-3

# The fit on the card against the fit on the CPU, from one seed: they draw
# the same random numbers and differ in rounding. PCA components up to sign
# (rounding turns components whose singular values are close); the GMM
# (means in the same signs) and the test scores relative to each array's
# largest magnitude; test errors within one point.
FIT_PCA_ATOL = 1e-3
FIT_RTOL = 1e-2
FIT_ERROR_TOL = 0.01
# An epoch may raise the objective by no more than the rounding of a
# float32 inverse at this conditioning.
OBJECTIVE_RTOL = 1e-3
# The full-width head's last block against its own normal equations, in
# float64: |(A_l' w A_l + lam I) W_l - A_l' w R+| / |A_l' w R+|, and W_l's
# distance from a float64 solve relative to its norm. Float32 grams,
# inverse and running residual leave both of order kappa * u (kappa the
# ridge gram's condition number, measured in float64; u = 2^-24): each may
# be at most SOLVE_KAPPA_U times that. A 1% error in W_l, or a wrong
# inverse, exceeds it.
SOLVE_KAPPA_U = 4.0
F32_UNIT_ROUNDOFF = 2.0**-24
# The full-width head's train top-1 error: 65,536 features over 8,192 rows.
TRAIN_ERROR_MAX = 0.01

# The full-width fit's peak device memory through the eager chain of PRs
# 4-7 (PERF.md §5); the graph executor's fit may exceed it by at most
# PEAK_SLACK_GIB.
EAGER_FIT_PEAK_GIB = 18.4
PEAK_SLACK_GIB = 1.0

FULL = dict(B=4, m=3721, d=64, k=256)
TTA_M = 2809  # descriptors of a 224x224 view at step 4, bin 4
REQUESTS = (1, 3, 16, 64)
BUCKETS = (1, 4, 16, 64)  # the serving buckets those requests reach
REPEATS = 5  # calls of each request size
# The service run: client threads, each submitting 64 one-image requests.
# Its answers come from other buckets than the direct call's, so the
# Fisher-vector kernel splits their sums otherwise: scores are held at
# SCORE_RTOL, and top-5 sets where the 5th and 6th scores are further
# apart than SERVICE_GAP_RTOL x max|score|, ten times that tolerance.
SERVICE_CLIENTS = 8
SERVICE_GAP_RTOL = 1e-2


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, after warm-up, between CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gmm_case(B, m, d, k, seed, torch, var_range=(0.5, 1.5), mu_scale=0.5):
    """Descriptors drawn from a random diagonal GMM, so responsibilities
    are spread over several components, plus that GMM."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(k, generator=g) + 0.1
    w = w / w.sum()
    mu = mu_scale * torch.randn(k, d, generator=g)
    lo, hi = var_range
    var = lo + (hi - lo) * torch.rand(k, d, generator=g)
    z = torch.randint(0, k, (B, m), generator=g)
    X = mu[z] + var[z].sqrt() * torch.randn(B, m, d, generator=g)
    return [t.cuda() for t in (X, w, mu, var)]


def held_against_plain(torch, got, ref, label: str) -> float:
    """Max abs error of the kernel's output ``got`` against the plain
    version's ``ref``; raises unless it is finite, of ``ref``'s shape and
    within rtol ``FV_RTOL``, atol ``FV_ATOL``."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"fv kernel {label}: bad shape or non-finite output")
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(FV_ATOL)).max())
    ok = bool((err <= FV_ATOL + FV_RTOL * ref.abs()).all())
    print(
        f"fv kernel vs plain {label}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tol=(rtol {FV_RTOL}, atol {FV_ATOL}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"fv kernel disagrees with plain at {label}")
    return max_abs


def check_fv(torch, fvo, B, m, d, k, seed, **gmm) -> float:
    X, w, mu, var = gmm_case(B, m, d, k, seed, torch, **gmm)
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    return held_against_plain(torch, got, ref, f"B={B} m={m} d={d} k={k} {gmm or ''}")


def check_fitted_floor(torch, fvo) -> float:
    """The kernel on a mixture fitted by the port's EM to descriptors of
    tight clusters (variance 1e-4, means of scale 0.5), at VOCSIFTFisher's
    shape (B 64, m 841, k 16): the fit puts variances at its 1e-4 floor, as
    the EM does on real descriptors."""
    from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModelEstimator

    X = gmm_case(64, 841, 64, 16, 9, torch, var_range=(1e-4, 1e-4), mu_scale=0.5)[0]
    gmm = GaussianMixtureModelEstimator(k=16, max_iters=20, seed=0).fit(X.reshape(-1, 64))
    w, mu, var = gmm.weights, gmm.means, gmm.variances
    floor = int((var <= 1e-4 * (1 + 1e-6)).sum())
    got = fvo.fisher_vectors(X, fvo.fv_operands(w, mu, var))
    ref = fvo.fisher_vectors_plain(X, w, mu, var)
    return held_against_plain(torch, got, ref, f"B=64 m=841 d=64 k=16, fitted by EM, {floor} of {var.numel()} "
                                               f"variances at the floor")


def check_repeat(torch, fvo) -> None:
    """Two launches on the same input give the same bits: the splits are
    summed in a fixed order, with no atomics."""
    X, w, mu, var = gmm_case(FULL["B"], FULL["m"], FULL["d"], FULL["k"], 5, torch)
    ops = fvo.fv_operands(w, mu, var)
    first = fvo.fisher_vectors(X, ops)
    second = fvo.fisher_vectors(X, ops)
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    print(f"fv kernel, two launches on one input: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("fv kernel is not bitwise repeatable")


def device_ms(fn, calls: int, names, torch) -> float:
    """Device milliseconds per call of ``fn()`` spent in the kernels named
    in ``names`` (each launched once a call), from a ``torch.profiler``
    trace of ``calls`` back-to-back calls after warm-up: the kernels' own
    time, without the host's launch overhead. Each kernel's time is the
    mean over the launches the trace holds, which may be fewer than
    ``calls``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for name in names:
        us = [
            e.time_range.end - e.time_range.start
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name
        ]
        if not us:
            raise AssertionError(f"the profiler saw no launch of {name}")
        total += sum(us) / len(us)
    return total / 1e3


def time_fv(torch, fvo, B, m, d, k) -> dict:
    """Kernel and plain version at one bucket: the kernel's output is held
    against the plain version's, then both are timed. ``ms`` is the device
    time of the kernel's two launches (partial sums and reduce) per call;
    ``call_ms`` the time of a call between CUDA events, host included."""
    X, w, mu, var = gmm_case(B, m, d, k, 7, torch)
    ops = fvo.fv_operands(w, mu, var)
    max_abs = held_against_plain(
        torch, fvo.fisher_vectors(X, ops), fvo.fisher_vectors_plain(X, w, mu, var),
        f"B={B} m={m} d={d} k={k} (timed bucket)",
    )
    ms = device_ms(lambda: fvo.fisher_vectors(X, ops), 20, ("fv_partial_kernel", "fv_reduce_kernel"), torch)
    call_ms = cuda_ms(lambda: fvo.fisher_vectors(X, ops), 20, torch)
    plain_ms = cuda_ms(lambda: fvo.fisher_vectors_plain(X, w, mu, var), 5, torch)
    tc_flops = 4.0 * B * m * k * d  # the logits product, m × 2d × k an image
    cc_flops = 5.0 * B * m * k * d  # the centred statistics: x - mu, r·(x - mu), two sums
    nbytes = 4.0 * (B * m * d + k + 2 * k * d + B * 2 * k * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = (tc_flops + cc_flops) / F32_PEAK_FLOPS * 1e3
    # The arithmetic the kernel does: the product in 3xTF32 on the tensor
    # cores, beside the statistics on the CUDA cores.
    t_3xtf32 = 3 * tc_flops / TF32_PEAK_FLOPS * 1e3
    t_cuda_cores = cc_flops / F32_PEAK_FLOPS * 1e3
    bound_ms = max(t_3xtf32, t_cuda_cores, t_bytes)
    print(
        f"fv timing B={B} m={m}: kernel {ms:.4f} ms on the device (call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms; bounds: 3xTF32 logits {t_3xtf32:.4f} ms, centred statistics on the CUDA "
        f"cores {t_cuda_cores:.4f} ms, all in float32 on the CUDA cores {t_f32:.4f} ms, bytes {t_bytes:.4f} ms; "
        f"share of the bound {bound_ms / ms:.3f}; {(tc_flops + cc_flops) / ms / 1e9:.3f} TFLOP/s of the float32 work"
    )
    return {
        "max_abs_err": max_abs,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if max(t_3xtf32, t_cuda_cores) >= t_bytes else "bytes",
        "f32_bound_ms": t_f32,
    }


def with_plain_fv(module, FisherVector, fvo, nn):
    """Replaces every FisherVector below ``module`` by the plain version
    on the same fitted GMM (in place)."""

    class PlainFV(nn.Module):
        def __init__(self, fv):
            super().__init__()
            self.fv = fv

        def forward(self, X):
            o = self.fv.operands()
            return fvo.fisher_vectors_plain(X, o.weights, o.means, o.variances)

    for name, child in module.named_children():
        if isinstance(child, FisherVector):
            setattr(module, name, PlainFV(child))
        else:
            with_plain_fv(child, FisherVector, fvo, nn)
    return module


def stage_ms(pipe, images, torch) -> list:
    """(name, device ms) of each step of one bucketed call on ``images``
    (host numpy): the copy to the card, each stage of both branches, the
    concatenation, the head and the top-k, each timed alone between CUDA
    events on the previous step's output."""
    gather, *rest = pipe.stages
    rows = [("copy to card", cuda_ms(lambda: torch.from_numpy(images).cuda(), 5, torch))]
    X = torch.from_numpy(images).cuda()
    feats = []
    with torch.inference_mode():
        for br, branch in zip(("sift", "lcs"), gather.branches):
            h = X
            for stage in branch.stages:
                rows.append((f"{br}/{type(stage).__name__}", cuda_ms(lambda: stage(h), 5, torch)))
                h = stage(h)
            feats.append(h)
        rows.append(("concatenate", cuda_ms(lambda: torch.cat(feats, dim=-1), 5, torch)))
        h = torch.cat(feats, dim=-1)
        for stage in rest:
            rows.append((type(stage).__name__, cuda_ms(lambda: stage(h), 5, torch)))
            h = stage(h)
    return rows


def profile_requests(fn, n: int, label: str, torch, calls: int = 3) -> float:
    """Device busy and idle share of ``calls`` back-to-back requests
    ``fn()`` of ``n`` images from a ``torch.profiler`` trace: the union of
    the device intervals of every kernel and copy, over the host wall time
    of the window, and the device time of the costliest kernels by name.
    Returns the idle share (nan when the trace holds no device activity,
    or none of the Fisher-vector kernels every request runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not any("fv_partial_kernel" in name for _, _, name in spans):
        print(f"profile of {calls} {label} requests of {n} images: device time not measured "
              "(the trace holds none of the Fisher-vector kernels every request runs)")
        return float("nan")
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = 1 - busy / wall_us
    print(
        f"profile of {calls} {label} requests of {n} images: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {idle:.3f}; costliest on the device: "
        + "; ".join(f"{name[:70]} {us / 1e3 / calls:.4f} ms/request" for name, us in top)
    )
    return idle


def replay_kernels(pipe, images, torch) -> dict:
    """Kernel launches by name in a ``torch.profiler`` trace of one replay
    of a graphed bucket of ``pipe`` at ``len(images)`` rows: the
    Fisher-vector kernel's partial and reduce kernels must each appear
    twice (once per branch). The bucket is captured inside the same
    trace, since CUPTI traces a graph's kernels one by one only when it
    was attached as the graph was instantiated; the replay is the one
    inside the ``one replay`` range (the warm-up's kernels end before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from keystone_tpu_torch.workflow.serving import CompiledPipeline

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine = CompiledPipeline(pipe, buckets=[len(images)], devices=["cuda"])
        engine.warmup(tuple(images.shape[1:]))
        torch.cuda.synchronize()
        with record_function("one replay"):
            engine(images)
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "one replay" and e.device_type == DeviceType.CPU)
    counts: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and span.start <= e.time_range.start <= span.end:
            for name in ("fv_partial_kernel", "fv_reduce_kernel"):
                if name in e.name:
                    counts[name] = counts.get(name, 0) + 1
    return counts


def eager_call(pipe, X, ladder, torch):
    """The serving chain called eagerly, as the engine did before graphs:
    pad to the bucket with the last row, copy to the card from pageable
    memory, run every operator from Python, slice, copy back."""
    import numpy as np

    n = len(X)
    b = next(b for b in ladder if b >= n)
    if n < b:
        X = np.concatenate([X, np.repeat(X[-1:], b - n, axis=0)])
    with torch.inference_mode():
        return pipe(torch.from_numpy(X).cuda())[:n].cpu().numpy()


def serve(torch) -> dict:
    import numpy as np
    from torch import nn

    import keystone_tpu_torch.ops.fisher_vector as fvo
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
    from keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv import (
        ImageNetSiftLcsFVConfig,
        build_serving_pipeline,
        seeded_params,
    )
    from keystone_tpu_torch.workflow import FusedTransformer
    from keystone_tpu_torch.workflow.serving import CompiledPipeline

    conf = ImageNetSiftLcsFVConfig(gmm_k=256, pca_dims=64, top_k=5)
    classes = 1000
    t0 = time.perf_counter()
    raw = seeded_params(seed=0, gmm_k=256, pca_dims=64, num_classes=classes, device="cuda", conf=conf)
    params = params_from_numpy(raw, "cuda")
    if params.head.W.shape != (conf.feature_dim, classes) or conf.feature_dim != 65536:
        raise AssertionError(f"head {tuple(params.head.W.shape)}, want (65536, {classes})")
    # The lazy pipeline, fitted and lowered by the engine to its serving
    # chain (the gathered branches, the head and the top-k as one module):
    # what each bucket captures, and the eager chain it is held against.
    engine = CompiledPipeline(build_serving_pipeline(params, conf), max_batch=64, devices=["cuda"])
    pipe = engine.transformer
    print(f"params and pipeline: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    before_warmup = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine.warmup((256, 256, 3))
    stats = engine.stats()
    (builds,) = stats["build_seconds"].values()
    (pools,) = stats["graph_pool_bytes"].values()
    plan = stats["plan"]
    print(f"warmup of buckets {list(engine.ladder)}: {time.perf_counter() - t0:.3f} s; plan: "
          f"{plan['bytes_per_row'] / 2**20:.3f} MiB a row ({plan['provenance']}), budget "
          f"{plan['budget_bytes'] / 2**30:.3f} GiB, planned {plan['planned_bytes'] / 2**30:.3f} GiB, "
          f"trimmed {plan['trimmed']}")
    print("capture seconds per bucket (eager warm-up, capture, first replay): "
          + ", ".join(f"{b}: {s:.3f}" for b, s in builds.items()))
    print("graph pool per bucket (MiB): " + ", ".join(f"{b}: {v / 2**20:.1f}" for b, v in pools.items())
          + f"; device memory with every bucket's graph resident: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({(torch.cuda.memory_allocated() - before_warmup) / 2**30:.3f} "
          f"above the parameters), reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    if engine.ladder != (1, 2, 4, 8, 16, 32, 64) or engine.compile_count != 7:
        raise AssertionError(f"the planner kept {engine.ladder}; {engine.compile_count} captures")

    _, test = ImageNetLoader.synthetic(n=4, num_classes=16, size=256, seed=1)
    images = test.data
    torch.cuda.reset_peak_memory_stats()
    fvo.LAUNCHES = 0  # the main path's run starts here
    off = 0
    outs, wall = {}, {}
    for n in REQUESTS:
        X = images[off : off + n]
        off += n
        wall[n] = []
        for _ in range(REPEATS):
            before = fvo.LAUNCHES
            t0 = time.perf_counter()
            topk = engine(X)
            wall[n].append(1e3 * (time.perf_counter() - t0))
            grew = fvo.LAUNCHES - before
            if topk.shape != (n, 5) or topk.dtype != np.int32:
                raise AssertionError(f"top-k of shape {topk.shape} {topk.dtype}")
            if topk.min() < 0 or topk.max() >= classes:
                raise AssertionError("top-k index out of range")
            if grew != 2:
                raise AssertionError(f"fv kernel launched {grew} times for one bucketed call, want 2")
        outs[n] = (X, topk)
    launches = fvo.LAUNCHES  # the main path's run ends here
    print(f"fv launches on the main path (graph replays, 2 each): {launches}; calls by bucket "
          f"{dict(engine.calls_by_bucket)}")
    print(f"peak device memory while serving: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    counts = replay_kernels(pipe, outs[1][0], torch)
    print(f"torch.profiler on one replay of bucket 1: {counts}")
    if counts != {"fv_partial_kernel": 2, "fv_reduce_kernel": 2}:
        raise AssertionError(f"one replay ran the fv kernels {counts}, want each twice")

    # Graphs against the eager chain: walls on the same requests, in turns.
    eager_wall = {n: [] for n in REQUESTS}
    for n in REQUESTS:
        X = outs[n][0]
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            eager_call(pipe, X, engine.ladder, torch)
            eager_wall[n].append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            engine(X)
            wall[n].append(1e3 * (time.perf_counter() - t0))
        print(f"request of {n} images: graphs median {statistics.median(wall[n]):.3f} ms (min "
              f"{min(wall[n]):.3f}, {len(wall[n])} calls), eager median {statistics.median(eager_wall[n]):.3f} ms "
              f"(min {min(eager_wall[n]):.3f}, {REPEATS} calls)")

    # Where the time goes: device time of each stage at the bucket of the
    # smallest and the largest request, beside the request's wall time.
    idle = {}
    for n in (REQUESTS[0], REQUESTS[-1]):
        X = outs[n][0]
        rows = stage_ms(pipe, X, torch)
        device = sum(ms for _, ms in rows)
        print(
            f"stages of a {n}-image request, eager (device ms): "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in rows)
            + f"; sum {device:.4f} of eager median wall {statistics.median(eager_wall[n]):.4f} ms"
        )
        idle[n] = (profile_requests(lambda: engine(X), n, "graphed", torch),
                   profile_requests(lambda: eager_call(pipe, X, engine.ladder, torch), n, "eager", torch))

    # Every bucket: graphed top-5 and scores bit-equal to the eager chain's
    # on the same padded batch.
    scorer = FusedTransformer(list(pipe.stages)[:-1]).eval()
    score_engine = CompiledPipeline(scorer, max_batch=64, devices=["cuda"]).warmup((256, 256, 3))
    for b in engine.ladder:
        X = images[:b]
        same_top = np.array_equal(engine(X), eager_call(pipe, X, engine.ladder, torch))
        same_scores = np.array_equal(score_engine(X), eager_call(scorer, X, engine.ladder, torch))
        print(f"bucket {b}: graphed top-5 {'equal' if same_top else 'DIFFER'}, scores "
              f"{'bit-equal' if same_scores else 'DIFFER'} to the eager chain's")
        if not (same_top and same_scores):
            raise AssertionError(f"bucket {b}'s graph disagrees with the eager chain")

    service_launches = run_service(torch, score_engine, images[:64])
    del score_engine

    # Scores of one request: kernel on the card vs the plain version on the
    # card, and vs the port on the CPU for its first image.
    X3 = torch.from_numpy(outs[3][0]).cuda()
    with torch.inference_mode():
        s_kernel = scorer(X3)
        if not torch.isfinite(s_kernel).all() or s_kernel.shape != (3, classes):
            raise AssertionError("scores not finite or of the wrong shape")
        scale = float(s_kernel.abs().max())
        cpu_params = params_from_numpy({k: v.cpu() if torch.is_tensor(v) else v for k, v in raw.items()}, "cpu")
        cpu_scorer = FusedTransformer(list(build_serving_pipeline(cpu_params, conf).serving_chain().stages)[:-1]).eval()
        s_cpu = cpu_scorer(X3[:1].cpu())
        s_plain = with_plain_fv(scorer, FisherVector, fvo, nn)(X3)
    err_plain = float((s_plain - s_kernel).abs().max())
    err_cpu = float((s_cpu - s_kernel[:1].cpu()).abs().max())
    print(
        f"scores: max|score| {scale:.4e}; card plain-FV vs kernel max_abs_err {err_plain:.3e}; "
        f"cpu vs card max_abs_err {err_cpu:.3e}; tolerance {SCORE_RTOL} x max|score|"
    )
    if err_plain > SCORE_RTOL * scale or err_cpu > SCORE_RTOL * scale:
        raise AssertionError("pipeline scores disagree beyond tolerance")
    return {"launches": launches, "service_launches": service_launches,
            "idle": idle, "walls": wall, "eager_walls": eager_wall}


def run_service(torch, engine, images) -> int:
    """Two runs of a ``PipelineService`` over the graphed scorer, each of
    ``SERVICE_CLIENTS`` threads sending every image of ``images`` as a
    one-image request: a burst (each client submits all of its requests,
    then waits for the answers) and a closed loop (each client waits for
    an answer before its next request). Every answer is held against the
    engine's direct call on the same rows. Returns the Fisher-vector
    launches of both runs."""
    import threading

    import numpy as np

    import keystone_tpu_torch.ops.fisher_vector as fvo
    from keystone_tpu_torch.workflow.serving import PipelineService

    direct = engine(images)
    scale = float(np.abs(direct).max())
    order = np.argsort(-direct, axis=1)
    top5 = np.sort(order[:, :5], axis=1)
    gap = np.take_along_axis(direct, order[:, 4:5], 1)[:, 0] - np.take_along_axis(direct, order[:, 5:6], 1)[:, 0]
    launches = 0
    for mode in ("burst", "closed loop"):
        answers = [[] for _ in range(SERVICE_CLIENTS)]
        futures = []
        lock = threading.Lock()
        svc = PipelineService(engine, max_delay_ms=2.0)

        def client(c):
            mine = []
            for i in np.random.default_rng(c).permutation(len(images)):
                f = svc.submit(images[i])
                with lock:
                    futures.append(f)
                mine.append((int(i), f))
                if mode == "closed loop":
                    f.result(120)
            answers[c] = [(i, f.result(120)) for i, f in mine]

        fvo.LAUNCHES = 0  # this service run starts here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVICE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t0
        stats = svc.stats()
        svc.close()
        launches += fvo.LAUNCHES  # and ends here
        answers = [a for per in answers for a in per]
        stranded = sum(not f.done() for f in futures)
        n = len(answers)
        worst = max(float(np.abs(a - direct[i]).max()) for i, a in answers)
        checked = [(i, a) for i, a in answers if gap[i] > SERVICE_GAP_RTOL * scale]
        top_ok = all(np.array_equal(np.sort(np.argsort(-a)[:5]), top5[i]) for i, a in checked)
        lat = stats["latency"]
        print(f"service, {mode}: {SERVICE_CLIENTS} clients x {len(images)} one-image requests = {n} in "
              f"{wall:.3f} s, {n / wall:.1f} requests/s; latency p50 {lat['p50_ms']:.3f} ms, p99 "
              f"{lat['p99_ms']:.3f} ms, max {lat['max_ms']:.3f} ms; {stats['batches_run']} batches, mean "
              f"{stats['rows_served'] / stats['batches_run']:.2f} rows a batch; stranded futures {stranded}; "
              f"outcomes {stats['outcomes']}; fv launches {fvo.LAUNCHES}")
        print(f"service, {mode}: answers against the direct engine: max abs difference {worst:.3e} "
              f"(max|score| {scale:.4e}, tol {SCORE_RTOL} x); top-5 equal on {len(checked)} of {n} answers "
              f"whose 5th and 6th scores are over {SERVICE_GAP_RTOL} x max|score| apart: {top_ok}")
        if (stranded or len(futures) != n or n != SERVICE_CLIENTS * len(images)
                or stats["outcomes"] != {"ok": n} or worst > SCORE_RTOL * scale or not top_ok
                or not checked or fvo.LAUNCHES != 2 * stats["batches_run"]
                or any(t.is_alive() for t in threads)):
            raise AssertionError(f"the service's {mode} run failed its checks")
    return launches


def fit_reduced(torch) -> None:
    """The same reduced fit on the card and on the CPU, compared."""
    import numpy as np

    from keystone_tpu_torch.convert import params_to_numpy
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv import (
        ImageNetSiftLcsFVConfig,
        evaluate,
        fit,
        resolve_scale,
    )
    from keystone_tpu_torch.workflow import on_device

    conf = resolve_scale(ImageNetSiftLcsFVConfig(gmm_k=16, pca_dims=16, synthetic_n=256, synthetic_classes=16))
    train, test = ImageNetLoader.synthetic(n=conf.synthetic_n, num_classes=conf.synthetic_classes, seed=conf.seed)
    got, err, scores = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scored = fit(conf, train, conf.synthetic_classes, device=dev)
        got[dev] = params_to_numpy(scored)
        err[dev] = evaluate(scored, conf, test, device=dev)
        with torch.inference_mode(), on_device(dev):
            scores[dev] = scored(torch.from_numpy(test.data).to(dev)).get().cpu().numpy()
        print(f"reduced fit on {dev}: {time.perf_counter() - t0:.3f} s, feature dim "
              f"{conf.feature_dim}, test top-{conf.top_k} error {err[dev][0]:.4f}, top-1 {err[dev][1]:.4f}")
    card, cpu = got["cuda"], got["cpu"]
    worst = {}
    for br in ("sift", "lcs"):
        gc, wc = card[f"{br}.pca.components"], cpu[f"{br}.pca.components"]
        signs = np.sign((gc * wc).sum(axis=0))
        worst[f"{br} pca components (abs)"] = (float(np.abs(gc * signs - wc).max()), FIT_PCA_ATOL)
        for key, flip in (("weights", 1), ("means", signs), ("variances", 1)):
            g, w = card[f"{br}.gmm.{key}"] * flip, cpu[f"{br}.gmm.{key}"]
            worst[f"{br} gmm {key} (rel. to max)"] = (float(np.abs(g - w).max() / np.abs(w).max()), FIT_RTOL)
    worst["test scores (rel. to max)"] = (
        float(np.abs(scores["cuda"] - scores["cpu"]).max() / np.abs(scores["cpu"]).max()), FIT_RTOL)
    for i, name in enumerate(("top-k error", "top-1 error")):
        worst[f"test {name} (abs)"] = (abs(err["cuda"][i] - err["cpu"][i]), FIT_ERROR_TOL)
    print("card vs cpu: " + "; ".join(f"{k} {v:.3e} (tol {t})" for k, (v, t) in worst.items()))
    bad = [k for k, (v, t) in worst.items() if not v <= t]
    if bad:
        raise AssertionError(f"the reduced fit on the card disagrees with the cpu: {bad}")


def full_width_data(np):
    """8,192 training and 512 test 256×256 images over 1,000 classes, from
    four seeded ``ImageNetLoader.synthetic`` calls run in threads (numpy
    draws and array arithmetic release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader, LabeledData

    def one(seed):
        return ImageNetLoader.synthetic(n=2048, num_classes=1000, size=256, seed=seed)

    with ThreadPoolExecutor(4) as pool:
        parts = list(pool.map(one, (0, 10, 20, 30)))
    train = LabeledData(np.concatenate([p[0].data for p in parts]), np.concatenate([p[0].labels for p in parts]))
    test = LabeledData(np.concatenate([p[1].data[:128] for p in parts]),
                       np.concatenate([p[1].labels[:128] for p in parts]))
    return train, test


def check_last_block(torch, scored, conf, train, features=None) -> None:
    """The full-width solve, checked in float64 on the card. The last block
    visited in the last epoch solved its normal equations against the
    residual of the final W, so with A the training features centered at
    their weighted mean (``features``, the host array the solve saw, or
    else the featurizer applied as the in-memory fit applies it: the
    residual amplifies a change of the features' rounding by about the
    gram's condition number, and the features' float32 rounding follows
    the batch size), w the row weights, R = (Y - y_mean) - A W and
    R+ = R + A_l W_l, its W_l satisfies (A_l' w A_l + lam I) W_l = A_l' w R+.
    Prints that residual relative to |A_l' w R+|, W_l's distance from a
    float64 solve of the same normal equations relative to its norm, and
    the condition number of the block's ridge gram, and holds both to
    SOLVE_KAPPA_U times the rounding that float32 leaves at it."""
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.workflow import FusedTransformer

    t0 = time.perf_counter()
    chain = scored.serving_chain()
    head = chain.stages[-1]
    with torch.inference_mode():
        if features is None:
            A = FusedTransformer(chain.stages[:-1]).apply_in_batches(train.data, device="cuda").double()
        else:
            A = torch.from_numpy(features).cuda().double()
        Y = ClassLabelIndicators(1000)(torch.from_numpy(train.labels).cuda()).double()
        w = BlockWeightedLeastSquaresEstimator(mixture_weight=conf.mixture_weight)._weights(Y)
        A -= (w @ A) / w.sum()
        R = Y - (w @ Y) / w.sum() - A @ head.W.double()
        s, e = head.blocks[-1]
        A_l, W_l = A[:, s:e], head.W[s:e].double()
        del A
        rhs = (A_l * w[:, None]).T @ (R + A_l @ W_l)
        gram = (A_l * w[:, None]).T @ A_l
        gram.diagonal().add_(conf.lam)
        residual = float(torch.linalg.norm(gram @ W_l - rhs) / torch.linalg.norm(rhs))
        W64 = torch.cholesky_solve(rhs, torch.linalg.cholesky(gram))
        dist = float(torch.linalg.norm(W_l - W64) / torch.linalg.norm(W64))
        eig = torch.linalg.eigvalsh(gram)
        cond = float(eig[-1] / eig[0])
    tol = SOLVE_KAPPA_U * cond * F32_UNIT_ROUNDOFF
    print(f"last block {s}:{e} in float64: ridge gram condition number {cond:.3e}; normal-equation residual "
          f"{residual:.3e}, distance from a float64 solve {dist:.3e} (tol {SOLVE_KAPPA_U} x kappa x u = {tol:.3e}) "
          f"({time.perf_counter() - t0:.3f} s)")
    if not (residual <= tol and dist <= tol):
        raise AssertionError(f"the last block's W does not solve its normal equations: {residual}, {dist}")


def fit_full(torch, train, test) -> dict:
    import numpy as np

    import keystone_tpu_torch.ops.fisher_vector as fvo
    from keystone_tpu_torch.convert import params_from_numpy, params_to_numpy
    from keystone_tpu_torch.nodes.util.classifiers import TopKClassifier
    from keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv import (
        REAL_SCALE,
        ImageNetSiftLcsFVConfig,
        build_serving_pipeline,
        evaluate,
        fit,
        resolve_scale,
    )
    from keystone_tpu_torch.utils.stages import StageTimer
    from keystone_tpu_torch.workflow.serving import CompiledPipeline

    # The reference's real-data settings, on synthetic images.
    conf = resolve_scale(ImageNetSiftLcsFVConfig(pca_dims=64, **REAL_SCALE))
    if (conf.gmm_k, conf.num_iters, conf.feature_dim) != (256, 3, 65536):
        raise AssertionError("the full-width settings are not the reference's real-data settings")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fvo.LAUNCHES = 0  # the fit path's run starts here
    t0 = time.perf_counter()
    with StageTimer("cuda") as timer:
        scored = fit(conf, train, 1000, device="cuda")
    fit_s = timer.seconds()  # synchronises
    wall = time.perf_counter() - t0
    launches = fvo.LAUNCHES  # the fit path's run ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    head = scored.transformers()[-1]
    print(f"fit wall {wall:.3f} s; head W {tuple(head.W.shape)}, blocks {len(head.blocks)} of "
          f"{head.blocks[0][1] - head.blocks[0][0]}")
    label = {"apply the prefix to the fit data": "featurizing the training set"}
    print("fit stages (s, between CUDA events): "
          + ", ".join(f"{label.get(name, name)} {s:.4f}" for name, s in fit_s.items())
          + f"; sum {sum(fit_s.values()):.4f}")
    print(f"peak device memory of the fit: {peak:.3f} GiB (the eager chain's fit: {EAGER_FIT_PEAK_GIB} GiB, "
          f"PERF.md §5; the graph fit may exceed it by {PEAK_SLACK_GIB} GiB)")
    if peak > EAGER_FIT_PEAK_GIB + PEAK_SLACK_GIB:
        raise AssertionError(f"the graph fit peaked at {peak:.3f} GiB")
    want_launches = 2 * -(-len(train.data) // 64)
    print(f"fv launches of the fit: {launches} (2 branches x {want_launches // 2} training batches)")
    if launches != want_launches:
        raise AssertionError(f"the fit launched the fv kernel {launches} times, want {want_launches}")
    if head.W.shape != (65536, 1000) or len(head.blocks) != 8:
        raise AssertionError("the head is not 65,536 x 1,000 in 8 blocks")
    objs = [float(timer.notes[f"objective after epoch {e}"]) for e in range(1, conf.num_iters + 1)]
    print("objective sum_i w_i |r_i|^2 + lam |W|^2 after each epoch: " + ", ".join(f"{o:.6e}" for o in objs))
    if not all(np.isfinite(objs)) or any(b > a * (1 + OBJECTIVE_RTOL) for a, b in zip(objs, objs[1:])):
        raise AssertionError(f"the objective grew across epochs: {objs}")

    t0 = time.perf_counter()
    train_err = evaluate(scored, conf, train, device="cuda")
    test_err = evaluate(scored, conf, test, device="cuda")
    print(f"errors: train top-5 {train_err[0]:.4f}, top-1 {train_err[1]:.4f}; test top-5 {test_err[0]:.4f}, "
          f"top-1 {test_err[1]:.4f} ({time.perf_counter() - t0:.3f} s)")
    # 65,536 features over 8,192 training rows, at lam = 1e-3: the head
    # separates its training set.
    if train_err[1] > TRAIN_ERROR_MAX:
        raise AssertionError(f"train top-1 error {train_err[1]} above {TRAIN_ERROR_MAX}")
    check_last_block(torch, scored, conf, train)

    # Serve what was fitted, carried through convert.py as --params would.
    served = build_serving_pipeline(params_from_numpy(params_to_numpy(scored), "cuda"), conf)
    engine = CompiledPipeline(served, max_batch=64, devices=["cuda"])
    engine.warmup((256, 256, 3))
    direct = scored.and_then(TopKClassifier(conf.top_k)).serving_chain().eval()
    fvo.LAUNCHES = 0  # serving the fitted pipeline starts here
    served_launches = 0
    for n in (1, 64):
        X = test.data[:n]
        before = fvo.LAUNCHES
        t0 = time.perf_counter()
        topk = engine(X)
        ms = 1e3 * (time.perf_counter() - t0)
        served_launches += fvo.LAUNCHES - before  # the direct call below is a check
        with torch.inference_mode():
            want = direct(torch.from_numpy(X).cuda()).cpu().numpy()
        same = np.array_equal(topk, want)
        print(f"fitted pipeline, request of {n}: {ms:.3f} ms, top-5 equal to the direct call: {same}")
        if not same:
            raise AssertionError("the served fitted pipeline disagrees with its direct call")
    return {"launches": launches, "served_launches": served_launches, "scored": scored, "conf": conf,
            "objectives": objs, "test_errors": test_err, "fit_seconds": fit_s}


def serve_precisions(torch, fitted, test) -> None:
    """The precision ladder on the full-width fitted pipeline: an engine
    (images to scores, buckets 1-64) at ``f32``, ``f32h`` and ``bf16``;
    every bucket's graph held bit for bit against the same precision's
    eager chain (``serve_fn``) on the same padded batch; walls of requests
    of 1 and 64 images beside ``f32``'s; and ``qualify``'s report on the
    512 test images against their labels, which must pass, and, without
    them, as agreement with the f32 oracle's top-1, printed as it comes
    (it refuses f32h and bf16: see PERF.md)."""
    import numpy as np

    from keystone_tpu_torch.workflow.serving import CompiledPipeline, PrecisionQualityError

    scored = fitted["scored"]
    for precision in ("f32", "f32h", "bf16"):
        t0 = time.perf_counter()
        engine = CompiledPipeline(scored, max_batch=64, devices=["cuda"], precision=precision)
        engine.warmup((256, 256, 3))
        build = time.perf_counter() - t0
        walls = {}
        for n in (1, 64):
            X = test.data[:n]
            engine(X)
            ms = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = engine(X)
                ms.append(1e3 * (time.perf_counter() - t0))
            walls[n] = statistics.median(ms)
            if out.shape != (n, 1000) or out.dtype != np.float32 or not np.isfinite(out).all():
                raise AssertionError(f"{precision}: scores {out.shape} {out.dtype}")
        differ = [b for b in engine.ladder
                  if not np.array_equal(engine(test.data[:b]),
                                        eager_call(engine.serve_fn, test.data[:b], engine.ladder, torch))]
        print(f"{precision}: graphed scores of buckets {list(engine.ladder)} against the {precision} "
              f"eager chain on the same padded batch: {'bit-equal' if not differ else f'DIFFER at {differ}'}")
        if differ:
            raise AssertionError(f"{precision}: the graphs of buckets {differ} disagree with their eager chain")
        # Against the labels the gate must pass; the agreement-only report
        # is the gate's verdict, printed as it is.
        reports = [engine.qualify(test.data, y=test.labels, metric="multiclass")]
        try:
            reports.append(engine.qualify(test.data, metric="multiclass"))
        except PrecisionQualityError as refused:
            reports.append(f"refused: {refused}")
        print(f"{precision}: built in {build:.3f} s; median wall 1 image {walls[1]:.3f} ms, 64 images "
              f"{walls[64]:.3f} ms; qualify on {len(test.data)} test images, with labels: {reports[0]}; "
              f"against the oracle's top-1: {reports[1]}")
        del engine
        torch.cuda.empty_cache()


def lazy_featurizer(scored):
    """The fitted featurizer of ``scored`` as a lazy pipeline: each gathered
    branch's stages composed with ``and_then``, the branches gathered."""
    from keystone_tpu_torch.workflow import Pipeline

    gather = scored.serving_chain().stages[0]
    branches = []
    for branch in gather.branches:
        p = branch.stages[0].to_pipeline()
        for stage in branch.stages[1:]:
            p = p.and_then(stage)
        branches.append(p)
    return Pipeline.gather(branches)


def counting_fits(classes, into: list):
    """Patches that append each class's name to ``into`` when its ``fit``
    runs."""
    def counted(cls):
        real = cls.fit

        def fit(self, *args, **kw):
            into.append(cls.__name__)
            return real(self, *args, **kw)
        return patch.object(cls, "fit", fit)
    return [counted(c) for c in classes]


def workflow(torch, np, fvo, fitted, test) -> int:
    """The graph layer on the card: the optimizer's plan for the full-width
    graph fit; the node-level solver choice on the 8,192 x 65,536 features
    against the concrete estimator; the host cost of a graph walk per
    request against the fused chain's eager call and the engine; the disk
    fit cache on the reduced fit run twice; the parallel walk against the
    serial one; the auto-cache rule on a prefix with two consumers.
    Returns the Fisher-vector launches of the phase."""
    from contextlib import ExitStack

    from keystone_tpu_torch.config import config
    from keystone_tpu_torch.convert import params_to_numpy
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.nodes.images.external.fisher_vector import GMMFisherVectorEstimator
    from keystone_tpu_torch.nodes.learning.block_least_squares import (
        BlockLeastSquaresEstimator,
        BlockWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.pca import PCAEstimator
    from keystone_tpu_torch.nodes.util.classifiers import TopKClassifier
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as pipe
    from keystone_tpu_torch.workflow import PipelineEnv, on_device, rules
    from keystone_tpu_torch.workflow.disk_cache import DiskFitCache
    from keystone_tpu_torch.workflow.operators import TransformerOperator
    from keystone_tpu_torch.workflow.serving import CompiledPipeline

    t_phase = time.perf_counter()
    conf, scored, train = fitted["conf"], fitted["scored"], fitted["train"]
    featurizer = lazy_featurizer(scored)
    env = PipelineEnv.get()
    images = torch.from_numpy(train.data).cuda()
    targets = ClassLabelIndicators(1000)(torch.from_numpy(train.labels).cuda())
    fvo.LAUNCHES = 0  # the workflow phase's run starts here

    # 1. The optimizer's plan for the full-width graph fit (no execution).
    rules.clear_decisions()
    plan = featurizer.and_then(
        BlockWeightedLeastSquaresEstimator(block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
                                           mixture_weight=conf.mixture_weight),
        images, targets)
    trace = []
    t0 = time.perf_counter()
    g = env.optimizer.execute(plan.graph, [plan.sink], trace)
    opt_ms = 1e3 * (time.perf_counter() - t0)
    labels = [g.operators[n].label() for n in g.reachable([plan.sink])
              if isinstance(g.operators[n], TransformerOperator)]
    print("optimizer plan of the full-width graph fit, operators before -> after each batch: "
          + ", ".join(f"{name} {a} -> {b}" for name, a, b in trace)
          + f"; merged nodes {trace[0][1] - trace[0][2]}; one pass {opt_ms:.3f} ms (host)")
    print("fused chains: " + "; ".join(labels))
    print(f"decision log: {[d.as_dict() for d in rules.optimizer_decisions()]}")
    gathered = [lab for lab in labels if lab.startswith("Gather[Fused(GrayScaler|SIFTExtractor")]
    if len(gathered) != 2:
        raise AssertionError(f"the plan did not lower both featurizer copies to one gathered module: {labels}")
    del plan, g

    # 2. Node-level choice: LeastSquaresEstimator dispatched at optimization
    # time from a 64-image sample of the featurizer, against the concrete
    # estimator it chose, fitted through the same graph.
    rules.clear_decisions()
    ls = LeastSquaresEstimator(lam=conf.lam)
    t0 = time.perf_counter()
    node_fit = featurizer.and_then(ls, images, targets).fit()
    torch.cuda.synchronize()
    node_s = time.perf_counter() - t0
    (decision,) = [d for d in rules.optimizer_decisions() if d.rule == "NodeOptimizationRule"]
    concrete = BlockLeastSquaresEstimator(block_size=ls.block_size, num_iters=ls.num_iters, lam=ls.lam)
    # The concrete estimator has the chosen one's signature, so the session's
    # fit cache would serve it the chosen fit: dropped, so that it fits.
    env.clear_caches()
    t0 = time.perf_counter()
    concrete_fit = featurizer.and_then(concrete, images, targets).fit()
    torch.cuda.synchronize()
    concrete_s = time.perf_counter() - t0
    X64 = torch.from_numpy(test.data[:64]).cuda()
    with torch.inference_mode(), on_device("cuda"):
        same = (torch.equal(node_fit.transformers()[-1].W, concrete_fit.transformers()[-1].W)
                and torch.equal(node_fit(X64).get(), concrete_fit(X64).get()))
    print(f"node-level choice on {decision.cost['shapes']}: {decision.action} ({decision.provenance}: "
          f"{decision.reason}); graph fit {node_s:.3f} s, the concrete estimator's {concrete_s:.3f} s; "
          f"W and test scores bit-equal: {same}")
    if decision.action != "solver=BlockLeastSquaresEstimator" or not same:
        raise AssertionError("the node-level choice is not the block solver's, bit for bit")
    del node_fit, concrete_fit

    # 3. Host cost of the graph: a request through pipeline(X).get() (an
    # optimizer pass and a walk each time), the fused chain called eagerly,
    # and the CUDA-graph engine, all to host numpy.
    served = scored.and_then(TopKClassifier(conf.top_k))
    chain = served.serving_chain().eval()
    engine = CompiledPipeline(served, max_batch=64, devices=["cuda"]).warmup((256, 256, 3))
    host = {}
    for n in (1, 64):
        X = test.data[:n]
        walls = {"pipeline(X).get()": [], "fused chain, eager": [], "CompiledPipeline": []}
        for i in range(2 * REPEATS + 1):
            t0 = time.perf_counter()
            with torch.inference_mode(), on_device("cuda"):
                got = served(X).get().cpu().numpy()
            t1 = time.perf_counter()
            with torch.inference_mode():
                want = chain(torch.from_numpy(X).cuda()).cpu().numpy()
            t2 = time.perf_counter()
            engine(X)
            t3 = time.perf_counter()
            if i:  # the first round warms each path
                for key, dt in zip(walls, (t1 - t0, t2 - t1, t3 - t2)):
                    walls[key].append(1e3 * dt)
            if not np.array_equal(got, want):
                raise AssertionError("the graph walk disagrees with the fused chain's eager call")
        host[n] = {k: statistics.median(v) for k, v in walls.items()}
        print(f"request of {n} images, median walls: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in host[n].items()))
    Xt = torch.from_numpy(test.data[:64]).cuda()
    opt, walk, eager = [], [], []
    with torch.inference_mode():
        for _ in range(2 * REPEATS):
            ds = served(Xt)
            t0 = time.perf_counter()
            g = env.optimizer.execute(ds.graph, [ds.sink])
            t1 = time.perf_counter()
            env.executor.execute(g, ds.sink)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            chain(Xt)
            t4 = time.perf_counter()
            torch.cuda.synchronize()
            opt.append(1e3 * (t1 - t0))
            walk.append(1e3 * (t2 - t1))
            eager.append(1e3 * (t4 - t3))
        device_ms = cuda_ms(lambda: chain(Xt), 5, torch)
    print(f"host ms of a 64-image batch on the card (medians, nothing awaited): optimizer pass "
          f"{statistics.median(opt):.3f}, graph walk {statistics.median(walk):.3f} (launches included), the fused "
          f"chain's eager call {statistics.median(eager):.3f}; device time of the chain {device_ms:.3f} ms")
    del engine

    # 4. The disk fit cache: the reduced fit twice in a temporary cache
    # directory, the session caches dropped between the runs.
    rconf = pipe.resolve_scale(pipe.ImageNetSiftLcsFVConfig(gmm_k=16, pca_dims=16, synthetic_n=256,
                                                            synthetic_classes=16))
    rtrain, rtest = ImageNetLoader.synthetic(n=rconf.synthetic_n, num_classes=16, seed=rconf.seed)
    fits, hits, runs = [], [], []
    real_get = DiskFitCache.get

    def counting_get(self, key):
        value = real_get(self, key)
        hits.append(value is not None)
        return value

    prior = config.cache_dir
    with tempfile.TemporaryDirectory(prefix="keystone-smoke-cache-") as cache_dir, ExitStack() as stack:
        for p in counting_fits((PCAEstimator, GMMFisherVectorEstimator, BlockWeightedLeastSquaresEstimator), fits):
            stack.enter_context(p)
        stack.enter_context(patch.object(DiskFitCache, "get", counting_get))
        config.cache_dir = cache_dir
        try:
            for _ in range(2):
                PipelineEnv.reset()
                fits.clear()
                hits.clear()
                t0 = time.perf_counter()
                s = pipe.fit(rconf, rtrain, 16, device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                with torch.inference_mode(), on_device("cuda"):
                    scores = s(rtest.data).get().cpu().numpy()
                runs.append((secs, list(fits), sum(hits), params_to_numpy(s), scores))
            entries = sorted(os.listdir(cache_dir))
        finally:
            config.cache_dir = prior
            PipelineEnv.reset()
    (s1, f1, h1, p1, sc1), (s2, f2, h2, p2, sc2) = runs
    same = all(np.array_equal(p1[k], p2[k]) for k in p1) and np.array_equal(sc1, sc2)
    print(f"disk fit cache, reduced fit: run 1 {s1:.3f} s, {len(f1)} fits {f1}, {len(entries)} entries written; "
          f"run 2 {s2:.3f} s, {len(f2)} fits, {h2} hits; parameters and test scores bit-equal: {same}")
    if f2 or h2 != 3 or not same:
        raise AssertionError("the rerun did not come whole from the disk fit cache")
    env = PipelineEnv.get()

    # 5. The parallel walk (2 workers) on the featurizer over 64 images,
    # unfused so that the two branches are nodes of their own, against the
    # serial walk unfused and fused.
    outs, secs = {}, {}
    prior_fuse, prior_workers = config.fuse_chains, config.exec_workers
    try:
        for name, fuse, workers in (("serial, fused", True, 0), ("serial, unfused", False, 0),
                                    ("parallel (2 workers), unfused", False, 2)):
            config.fuse_chains, config.exec_workers = fuse, workers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode(), on_device("cuda"):
                outs[name] = featurizer(Xt).get()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
    finally:
        config.fuse_chains, config.exec_workers = prior_fuse, prior_workers
    ref = outs["serial, unfused"]
    equal = {name: torch.equal(out, ref) for name, out in outs.items()}
    print("featurizer over 64 images: " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + f"; bit-equal to the serial unfused walk: {equal}")
    if not all(equal.values()):
        raise AssertionError("the parallel walk disagrees with the serial one")

    # 6. The auto-cache rule on a prefix with two consumers: the featurizer
    # over the 512 test images feeds the head's fit and the scoring.
    Xa = torch.from_numpy(test.data).cuda()
    ya = ClassLabelIndicators(1000)(torch.from_numpy(test.labels).cuda())

    def fit_and_score():
        feats = featurizer(Xa)
        head = BlockWeightedLeastSquaresEstimator(block_size=conf.block_size, num_iters=1, lam=conf.lam,
                                                  mixture_weight=conf.mixture_weight).with_data(feats, ya)
        with on_device("cuda"):
            return head(feats).get()

    rules.clear_decisions()
    off = fit_and_score()
    config.auto_cache = True
    try:
        t0 = time.perf_counter()
        on = fit_and_score()
        torch.cuda.synchronize()
        on_s = time.perf_counter() - t0
    finally:
        config.auto_cache = False
    auto = env.optimizer.batches[2][1][0]
    inserted = [d.node for d in rules.optimizer_decisions() if d.action == "cache-insert"]
    sample_s = sum(p.seconds for _, p in auto.last_profiles)
    print(f"auto-cache: {len(inserted)} cache nodes inserted ({', '.join(inserted)}); sample profile "
          f"{sample_s:.3f} s over {len(auto.last_profiles)} nodes "
          + "(" + ", ".join(f"{lab} {p.seconds:.4f}" for lab, p in auto.last_profiles[:8]) + ", ...)"
          + f"; fit and score with it {on_s:.3f} s; scores equal to those with it off: {torch.equal(on, off)}")
    if not inserted or not torch.equal(on, off):
        raise AssertionError("the auto-cache rule inserted nothing or changed the scores")
    env.clear_caches()
    launches = fvo.LAUNCHES  # the workflow phase's run ends here
    print(f"fv launches of the workflow phase: {launches}; the phase {time.perf_counter() - t_phase:.3f} s (host)")
    return launches


# The streamed solve against the eager one on the same features: the same
# updates in the same order, each inverse formed alone instead of in a
# batch. Objectives per epoch within a relative 1e-3 and test errors within
# 0.02 (10 of 512 images) of the eager fit's.
STREAM_OBJECTIVE_RTOL = 1e-3
STREAM_ERROR_TOL = 0.02
# Streamed TTA scores against the pipeline applied to the views directly,
# relative to the largest |score|: float32 products over other batch sizes.
VIEW_RTOL = 1e-4
# A solve stopped after this many block updates (epoch 2, block 4) and
# resumed from its checkpoints, against the uninterrupted solve: the same
# inverses and the same order, so W within a relative 1e-6.
KILL_AFTER = 12
RESUME_RTOL = 1e-6


class Stop(Exception):
    """Raised by the smoke's hook to stop a solve."""


def host_features(torch, np, featurizer, images):
    """``featurizer`` applied to host ``images`` through ``apply_batches``
    in batches of 256, as ``fit_streamed`` applies it, assembled into one
    host float32 array."""
    from keystone_tpu_torch.loaders.stream import BatchIterator

    out, off = None, 0
    with torch.inference_mode():
        for F, _ in featurizer.apply_batches(BatchIterator.from_arrays(images, None, 256), device="cuda"):
            if out is None:
                out = np.empty((len(images), F.shape[1]), dtype=np.float32)
            out[off : off + len(F)] = F.cpu().numpy()
            off += len(F)
    return out


def streamed_head(torch, A, targets, conf, **estimator_kw):
    """The class-weighted head fitted streamed on host features ``A``:
    (head, stage seconds, timer notes, host wall seconds, peak device bytes
    above the memory held before the fit)."""
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.utils.stages import StageTimer

    est = BlockWeightedLeastSquaresEstimator(
        block_size=conf.block_size, num_iters=conf.num_iters, lam=conf.lam,
        mixture_weight=conf.mixture_weight, device="cuda", stream=True, **estimator_kw,
    )
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StageTimer("cuda") as timer:
        head = est.fit(A, targets)
    secs = timer.seconds()  # synchronises
    wall = time.perf_counter() - t0
    return head, secs, timer.notes, wall, torch.cuda.max_memory_allocated() - base


def epochs_line(secs, n) -> str:
    return " / ".join(f"{secs[f'BCD epoch {e}']:.4f}" for e in range(1, n + 1))


def block_time_medians(rows: list) -> dict:
    """Median prep, copy and update milliseconds of the streamed solve's
    blocks, the update apart for first visits (which form the inverse)."""
    out = {key: statistics.median(r[key] for r in rows) for key in ("prep_ms", "copy_ms")}
    for first, name in ((True, "first_update_ms"), (False, "update_ms")):
        out[name] = statistics.median(r["update_ms"] for r in rows if r["first"] == first)
    return out


def blocks_line(notes) -> str:
    m = block_time_medians(notes["streamed BCD blocks"])
    return (f"prep {m['prep_ms']:.3f} ms (host), copy {m['copy_ms']:.3f} ms, update {m['update_ms']:.3f} ms, "
            f"first-epoch update (with its inverse) {m['first_update_ms']:.3f} ms")


def fit_streamed(torch, train, test, eager) -> dict:
    """The streamed head against the eager one, ``fit_streamed`` and
    ``score_streamed`` end to end, and a stopped and resumed solve, all at
    full width on the full-width phase's images."""
    import os
    import tempfile
    from dataclasses import replace

    import numpy as np

    import keystone_tpu_torch.linalg.bcd as bcd
    import keystone_tpu_torch.nodes.learning.block_least_squares as bls
    import keystone_tpu_torch.ops.fisher_vector as fvo
    from keystone_tpu_torch.loaders.stream import BatchIterator
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as pipe
    from keystone_tpu_torch.utils.metrics import metrics_registry
    from keystone_tpu_torch.utils.stages import StageTimer
    from keystone_tpu_torch.workflow import FusedTransformer

    conf, scored = eager["conf"], eager["scored"]
    chain = scored.serving_chain()
    featurizer = FusedTransformer(chain.stages[:-1])
    n_iters = conf.num_iters

    # 1. The streamed solve against the eager one, on the same features.
    t0 = time.perf_counter()
    with torch.inference_mode():
        # The eager fit's batches, so that the two solves see the same bits.
        A = featurizer.apply_in_batches(train.data, device="cuda").cpu().numpy()
    targets = ClassLabelIndicators(1000)(torch.from_numpy(train.labels).cuda())
    print(f"training features on the host: {A.shape} float32, {A.nbytes / 2**30:.3f} GiB, "
          f"{time.perf_counter() - t0:.3f} s (featurized as the eager fit does, copied back)")
    # apply_batches's pinned double buffer against plain copies, in the same
    # batches: 8 of them, so that each of the 4 staging buffers is reused.
    some = train.data[: 8 * 256]
    with torch.inference_mode():
        direct = featurizer.apply_in_batches(some, batch_size=256, device="cuda").cpu().numpy()
    staged = host_features(torch, np, featurizer, some)
    same = np.array_equal(staged, direct)
    print(f"apply_batches (pinned staging, copy stream) against apply_in_batches, {len(some)} images in "
          f"batches of 256: equal bit for bit {same} (max abs difference {float(np.abs(staged - direct).max()):.3e}); "
          f"batches of 64 against 256: max abs difference {float(np.abs(A[: len(some)] - direct).max()):.3e}")
    if not same:
        raise AssertionError("features staged through pinned memory differ from plain copies")
    del some, direct, staged
    head, secs, notes, wall, peak = streamed_head(torch, A, targets, conf)
    eager_epochs = " / ".join(f"{eager['fit_seconds'][f'BCD epoch {e}']:.4f}" for e in range(1, n_iters + 1))
    print(f"streamed solve: wall {wall:.3f} s; centering {secs['centering']:.4f} s; epochs (s, CUDA events) "
          f"{epochs_line(secs, n_iters)} (eager: factor phase {eager['fit_seconds']['BCD factor phase']:.4f}, "
          f"epochs {eager_epochs})")
    print("streamed solve, per-block medians: " + blocks_line(notes))
    inv_bytes = sum((e - s) ** 2 for s, e in head.blocks) * 4
    bound = A.nbytes + inv_bytes
    print(f"streamed solve: peak device memory above the pre-solve baseline {peak / 2**30:.3f} GiB "
          f"(bound: A {A.nbytes / 2**30:.3f} + inverses {inv_bytes / 2**30:.3f} GiB)")
    if peak >= bound:
        raise AssertionError(f"the streamed solve held {peak} bytes on the card, not below {bound}")
    serial = lambda *a, **k: bcd.block_coordinate_descent_streamed(*a, overlap=False, **k)  # noqa: E731
    with patch.object(bls, "block_coordinate_descent_streamed", serial):
        serial_head, serial_secs, serial_notes, serial_wall, _ = streamed_head(torch, A, targets, conf)
    print(f"serialized (overlap=False): wall {serial_wall:.3f} s; epochs {epochs_line(serial_secs, n_iters)}; "
          f"per-block medians: " + blocks_line(serial_notes))
    same = torch.equal(serial_head.W, head.W) and torch.equal(serial_head.b, head.b)
    print(f"serialized head equal to the double-buffered one bit for bit: {same}")
    if not same:
        raise AssertionError("the serialized streamed solve differs from the double-buffered one")
    objs = [float(notes[f"objective after epoch {e}"]) for e in range(1, n_iters + 1)]
    rel = [abs(o - w) / abs(w) for o, w in zip(objs, eager["objectives"])]
    print("streamed objective after each epoch: " + ", ".join(f"{o:.6e}" for o in objs)
          + " (relative to the eager fit's: " + ", ".join(f"{r:.3e}" for r in rel)
          + f"; tol {STREAM_OBJECTIVE_RTOL})")
    if not max(rel) <= STREAM_OBJECTIVE_RTOL:
        raise AssertionError(f"the streamed objectives disagree with the eager ones: {rel}")
    eager_head = chain.stages[-1]
    w_dist = float(torch.linalg.norm(head.W - eager_head.W) / torch.linalg.norm(eager_head.W))
    print(f"streamed W's distance from the eager W, relative to its norm: {w_dist:.3e}")
    streamed_scored = featurizer.and_then(head)
    check_last_block(torch, streamed_scored, conf, train, features=A)
    test_err = pipe.evaluate(streamed_scored, conf, test, device="cuda")
    print(f"streamed head: test top-5 {test_err[0]:.4f}, top-1 {test_err[1]:.4f} (eager: "
          f"{eager['test_errors'][0]:.4f}, {eager['test_errors'][1]:.4f}; tol {STREAM_ERROR_TOL})")
    if max(abs(a - b) for a, b in zip(test_err, eager["test_errors"])) > STREAM_ERROR_TOL:
        raise AssertionError("the streamed head's test errors differ from the eager head's")

    # 2. fit_streamed and score_streamed end to end, checkpointing.
    saves = []

    def timed_save(fn, kind):
        def save(checkpoint_dir, *args):
            t = time.perf_counter()
            fn(checkpoint_dir, *args)
            path = os.path.join(checkpoint_dir, bcd.SNAPSHOT if kind == "snapshot" else f"epoch_{args[0]}.pt")
            saves.append((kind, time.perf_counter() - t, os.path.getsize(path)))
        return save

    with tempfile.TemporaryDirectory(prefix="keystone-smoke-") as ck:
        sconf = replace(conf, stream=True, stream_batch=256, fit_sample_images=512, checkpoint_dir=ck)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patch.object(bcd, "_save_epoch", timed_save(bcd._save_epoch, "epoch")), \
                patch.object(bcd, "_save_snapshot", timed_save(bcd._save_snapshot, "snapshot")):
            fvo.LAUNCHES = 0  # the streamed fit's run starts here
            with StageTimer("cuda") as timer:
                streamed_fit = pipe.fit_streamed(
                    sconf, train.data[: sconf.fit_sample_images],
                    BatchIterator.from_arrays(train.data, train.labels, sconf.stream_batch), 1000, device="cuda",
                )
            fit_launches = fvo.LAUNCHES  # the streamed fit's run ends here
        fit_secs = timer.seconds()
        fit_wall = time.perf_counter() - t0
        left = sorted(os.listdir(ck))
    print(f"fit_streamed wall {fit_wall:.3f} s; stages (s, CUDA events): "
          + ", ".join(f"{name} {v:.4f}" for name, v in fit_secs.items()) + f"; sum {sum(fit_secs.values()):.4f}")
    print("fit_streamed per-block medians: " + blocks_line(timer.notes))
    print(f"peak device memory of fit_streamed: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for kind in ("epoch", "snapshot"):
        picked = [(t, b) for k, t, b in saves if k == kind]
        print(f"checkpoint {kind} saves: {len(picked)}, "
              + ", ".join(f"{b / 2**30:.3f} GiB in {t:.3f} s" for t, b in picked))
    print(f"checkpoint directory after the solve: {left}")
    if bcd.SNAPSHOT in left or left != [f"epoch_{e}.pt" for e in range(1, n_iters + 1)]:
        raise AssertionError(f"the completed solve left {left}")
    want = 2 * -(-len(train.data) // sconf.stream_batch)
    print(f"fv launches of fit_streamed: {fit_launches} (2 branches x {want // 2} batches of {sconf.stream_batch})")
    if fit_launches != want:
        raise AssertionError(f"fit_streamed launched the fv kernel {fit_launches} times, want {want}")
    # fit_streamed's features again, through the same batches of 256.
    check_last_block(torch, streamed_fit, conf, train,
                     features=host_features(torch, np, FusedTransformer(streamed_fit.serving_chain().stages[:-1]),
                                            train.data))

    # The direct call: the fitted pipeline's serving chain, eagerly.
    streamed_chain = streamed_fit.serving_chain()
    test_batches = BatchIterator.from_arrays(test.data, test.labels, sconf.stream_batch)
    out = {"fit streamed": fit_launches}
    errs = {}
    head_calls = metrics_registry.counters("serve.dispatch[imagenet-score-head]")
    engines = []
    scoring_engine = pipe._scoring_engine

    def recording_engine(*args, **kw):  # the engine score_streamed builds, for its capture time
        engines.append(scoring_engine(*args, **kw))
        return engines[-1]

    for name, c in (("score streamed", sconf), ("score streamed tta", replace(sconf, augment=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatched = sum(head_calls.snapshot().values())
        fvo.LAUNCHES = 0  # this scoring path's run starts here
        with patch.object(pipe, "_scoring_engine", recording_engine):
            scores, labels = pipe.score_streamed(streamed_fit, c, test_batches, train.data.shape[1],
                                                 device="cuda")
        out[name] = fvo.LAUNCHES  # and ends here
        seconds = time.perf_counter() - t0
        dispatched = sum(head_calls.snapshot().values()) - dispatched
        if not c.augment:
            print(f"{name}: the head through _scoring_engine (one graph at bucket {sconf.stream_batch}): "
                  f"{dispatched} calls for {len(list(test_batches))} batches; its warm-up and capture "
                  f"{engines[-1].warmup_seconds:.3f} s of the pass")
            if dispatched != len(list(test_batches)):
                raise AssertionError("the streamed scorer's head did not run through its engine")
            # The direct call on the same first batch: the same features,
            # and the head's graph against the eager head.
            first = sconf.stream_batch
            with torch.inference_mode():
                direct = streamed_chain(torch.from_numpy(test.data[:first]).cuda()).cpu().numpy()
            head_err = float(np.abs(scores[:first] - direct).max())
            print(f"{name}: first batch's {first} scores against the direct call on it, max abs "
                  f"difference {head_err:.3e}, tol {VIEW_RTOL} x max|score| {np.abs(direct).max():.4e}")
            if head_err > VIEW_RTOL * np.abs(direct).max():
                raise AssertionError("the streamed scores disagree with the direct call")
        if c.augment:
            patcher, averager = pipe.build_tta(c, train.data.shape[1])
            sub = max(1, c.stream_batch // patcher.num_views)
            per_batch = [-(-len(X) // sub) for X, _ in test_batches]
            want = 2 * sum(per_batch)
            tta = scores
        else:
            want = 2 * len(list(test_batches))
        topk = np.argsort(-scores, axis=1)[:, : conf.top_k]
        errs[name] = (float(1 - (topk == labels[:, None]).any(axis=1).mean()), float((topk[:, 0] != labels).mean()))
        print(f"{name}: {len(labels)} test images in {seconds:.3f} s (host clock), scores {scores.shape}, "
              f"test top-5 {errs[name][0]:.4f}, top-1 {errs[name][1]:.4f}, fv launches {out[name]} (want {want})")
        if out[name] != want or not np.isfinite(scores).all() or scores.shape != (len(test.data), 1000):
            raise AssertionError(f"{name}: {out[name]} launches, scores {scores.shape}")
    with torch.inference_mode():
        views = patcher(torch.from_numpy(test.data[:64]).cuda())
        direct = averager.average_scores(streamed_chain(views)).cpu().numpy()
    view_err = float(np.abs(tta[:64] - direct).max())
    scale = float(np.abs(direct).max())
    print(f"TTA view accounting, first 64 test images ({views.shape[0]} views of {tuple(views.shape[1:3])}): "
          f"max abs difference {view_err:.3e}, tol {VIEW_RTOL} x max|score| {scale:.4e}")
    if view_err > VIEW_RTOL * scale:
        raise AssertionError("streamed TTA scores disagree with the views scored directly")

    # 3. A solve stopped mid-epoch and resumed from its checkpoints.
    count = [0]
    real_update = bcd._solve_update

    def stopping_update(*args):
        count[0] += 1
        if count[0] > KILL_AFTER:
            raise Stop
        return real_update(*args)

    with tempfile.TemporaryDirectory(prefix="keystone-smoke-") as ck:
        with patch.object(bcd, "_solve_update", stopping_update):
            try:
                streamed_head(torch, A, targets, conf, checkpoint_dir=ck)
            except Stop:
                pass
            else:
                raise AssertionError("the hook did not stop the solve")
        kept = sorted(os.listdir(ck))
        resumed, resumed_secs, _, resume_wall, _ = streamed_head(torch, A, targets, conf, checkpoint_dir=ck)
    rel_w = float(torch.linalg.norm(resumed.W - head.W) / torch.linalg.norm(head.W))
    nb = len(head.blocks)
    print(f"stopped after {KILL_AFTER} block updates (epoch {KILL_AFTER // nb + 1}, block {KILL_AFTER % nb}), leaving {kept}; "
          f"resumed in {resume_wall:.3f} s (epochs {' / '.join(f'{v:.4f}' for k, v in resumed_secs.items() if k.startswith('BCD'))}); "
          f"W's distance from the uninterrupted W relative to its norm {rel_w:.3e} (tol {RESUME_RTOL})")
    if not rel_w <= RESUME_RTOL:
        raise AssertionError("the resumed solve does not give the uninterrupted W")
    return {"launches": out, "A": A, "targets": targets, "objectives": objs}


# The solver's modes on the full-width features, against the float32 solve
# at precision highest. The bounds are tests/test_bf16_mode.py's for
# bfloat16 storage (its solves track the float32 oracle within 5e-2,
# test_bcd_tracks_f32_oracle and test_estimator_prediction_parity): the
# objective after each epoch, and the training scores relative to their
# norm, each within a relative 5e-2 of the float32 solve's. TF32 keeps 10
# of float32's 23 mantissa bits, so it is held to the same bounds.
MODE_RTOL = 5e-2
# The last block's visit, checked in float64 on the operands the solve
# held (captured by a hook here): the block and A_l·w as stored, R and W_l
# as they came in, bfloat16 roundings of W_l and R+ mirrored. What is left
# is the rounding of the float32 gram, inverse and sums, so the bound is
# SOLVE_KAPPA_U times kappa times float32's unit roundoff; for TF32
# products, times TF32's (2^-11).
TF32_UNIT_ROUNDOFF = 2.0**-11


def capture_last_visit(bcd, into: dict):
    """A replacement of ``bcd._solve_update`` that keeps the operands and
    the result of the latest call in ``into``."""
    real = bcd._solve_update

    def update(a_b, aw, inv, R, w_b, precision):
        R_new, w_new = real(a_b, aw, inv, R, w_b, precision)
        into.update(a_b=a_b, aw=aw, R=R, w_b=w_b, w_new=w_new)
        return R_new, w_new

    return update


def check_visit(torch, visit: dict, lam: float, unit_roundoff: float, label: str) -> dict:
    """The captured visit in float64: R+ = R + A_l·W_l (W_l in A's dtype),
    rhs = (A_l·w)' R+ (R+ in A's dtype), G the symmetrized (A_l·w)' A_l + lam I;
    the new W_l must satisfy G W_l = rhs."""
    a, aw = visit["a_b"], visit["aw"]
    store = a.dtype
    with torch.inference_mode():
        a64, aw64 = a.double(), aw.double()
        r_plus = visit["R"].double() + a64 @ visit["w_b"].to(store).double()
        rhs = aw64.T @ r_plus.float().to(store).double()
        gram = aw64.T @ a64
        gram = (gram + gram.T) / 2
        gram.diagonal().add_(lam)
        w_new = visit["w_new"].double()
        residual = float(torch.linalg.norm(gram @ w_new - rhs) / torch.linalg.norm(rhs))
        w64 = torch.cholesky_solve(rhs, torch.linalg.cholesky(gram))
        dist = float(torch.linalg.norm(w_new - w64) / torch.linalg.norm(w64))
        eig = torch.linalg.eigvalsh(gram)
        cond = float(eig[-1] / eig[0])
    tol = SOLVE_KAPPA_U * cond * unit_roundoff
    print(f"{label}: last visit in float64 (A stored {str(store).removeprefix('torch.')}): condition number "
          f"{cond:.3e}; normal-equation residual {residual:.3e}, distance from a float64 solve {dist:.3e} "
          f"(tol {SOLVE_KAPPA_U} x kappa x {unit_roundoff:.3e} = {tol:.3e})")
    if not (residual <= tol and dist <= tol):
        raise AssertionError(f"{label}: the last visit does not solve its normal equations: {residual}, {dist}")
    return {"residual": residual, "distance": dist, "tol": tol}


def solver_modes(torch, eager, streamed, test) -> None:
    """bfloat16 storage (eager and streamed) and TF32 products (eager) against
    the float32 solve at precision highest, on the full-width features; then
    the eager solve with its inverses formed one block at a time."""
    import numpy as np

    import keystone_tpu_torch.linalg.bcd as bcd
    from keystone_tpu_torch.linalg.row_matrix import solver_matmul
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util.classifiers import TopKClassifier
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as pipe
    from keystone_tpu_torch.utils.stages import StageTimer
    from keystone_tpu_torch.workflow import FusedTransformer

    conf, scored = eager["conf"], eager["scored"]
    chain = scored.serving_chain()
    featurizer = FusedTransformer(chain.stages[:-1])
    A, targets = streamed["A"], streamed["targets"]
    labels = targets.argmax(dim=1)
    A_dev = torch.from_numpy(A).cuda()
    n_iters = conf.num_iters
    print(f"features: A {A.shape}, {A.nbytes / 2**30:.3f} GiB as float32 (the full-width phase's, on the card "
          f"and on the host)")
    with torch.inference_mode():
        product = solver_matmul(A_dev[:256, :512].to(torch.bfloat16), torch.ones(512, 4, device="cuda"))
    print(f"a solver product of bfloat16 A on the card (torch.mm with out_dtype): {product.dtype}")
    if product.dtype != torch.float32:
        raise AssertionError(f"a bfloat16 solver product came back as {product.dtype}")

    def solve(stream: bool, **modes):
        est = BlockWeightedLeastSquaresEstimator(
            block_size=conf.block_size, num_iters=n_iters, lam=conf.lam, mixture_weight=conf.mixture_weight,
            device="cuda", stream=stream, **modes)
        visit = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patch.object(bcd, "_solve_update", capture_last_visit(bcd, visit)), StageTimer("cuda") as timer:
            head = est.fit(A if stream else A_dev, targets)
        secs = timer.seconds()  # synchronises
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        objs = [float(timer.notes[f"objective after epoch {e}"]) for e in range(1, n_iters + 1)]
        with torch.inference_mode():
            scores = head(A_dev)
            top = TopKClassifier(conf.top_k)(scores)
            train_err = (float(1 - (top == labels[:, None]).any(dim=1).float().mean()),
                         float((top[:, 0] != labels).float().mean()))
        test_err = pipe.evaluate(featurizer.and_then(head), conf, test, device="cuda")
        return dict(head=head, secs=secs, notes=timer.notes, wall=wall, peak=peak, objs=objs, scores=scores,
                    train_err=train_err, test_err=test_err, visit=visit)

    f32 = solve(False, precision="highest", storage_dtype="float32")
    base_w = f32["head"].W
    print(f"float32, highest (eager): wall {f32['wall']:.3f} s; factor phase {f32['secs']['BCD factor phase']:.4f} s, "
          f"epochs {epochs_line(f32['secs'], n_iters)}; objectives " + ", ".join(f"{o:.6e}" for o in f32["objs"])
          + f"; train top-5/top-1 {f32['train_err'][0]:.4f}/{f32['train_err'][1]:.4f}, test "
          f"{f32['test_err'][0]:.4f}/{f32['test_err'][1]:.4f}; device peak above the features "
          f"{f32['peak'] / 2**30:.3f} GiB (A as solved: {A.nbytes / 2**30:.3f} GiB)")
    check_visit(torch, f32.pop("visit"), conf.lam, F32_UNIT_ROUNDOFF, "float32, highest (eager)")
    for label, stream, modes, u in (
        ("bfloat16 storage (eager)", False, dict(storage_dtype="bfloat16"), F32_UNIT_ROUNDOFF),
        ("bfloat16 storage (streamed)", True, dict(storage_dtype="bfloat16"), F32_UNIT_ROUNDOFF),
        ("float32, high = TF32 (eager)", False, dict(precision="high"), TF32_UNIT_ROUNDOFF),
    ):
        run = solve(stream, **modes)
        rel = [abs(o - w) / abs(w) for o, w in zip(run["objs"], f32["objs"])]
        w_dist = float(torch.linalg.norm(run["head"].W - base_w) / torch.linalg.norm(base_w))
        s_dist = float(torch.linalg.norm(run["scores"] - f32["scores"]) / torch.linalg.norm(f32["scores"]))
        a_bytes = A.nbytes // (2 if "bfloat16" in label else 1)
        print(f"{label}: wall {run['wall']:.3f} s; "
              + (f"factor phase {run['secs']['BCD factor phase']:.4f} s, " if not stream else "")
              + f"epochs {epochs_line(run['secs'], n_iters)}; objectives "
              + ", ".join(f"{o:.6e}" for o in run["objs"])
              + " (relative to float32's: " + ", ".join(f"{r:.3e}" for r in rel) + f"; tol {MODE_RTOL}); "
              f"W's distance from float32's {w_dist:.3e} (relative); training scores' distance {s_dist:.3e} "
              f"(tol {MODE_RTOL}); train top-5/top-1 {run['train_err'][0]:.4f}/{run['train_err'][1]:.4f}, test "
              f"{run['test_err'][0]:.4f}/{run['test_err'][1]:.4f}; device peak above the features "
              f"{run['peak'] / 2**30:.3f} GiB (A as solved: {a_bytes / 2**30:.3f} GiB)")
        if stream:
            print(f"{label}, per-block medians: " + blocks_line(run["notes"]))
        if not (max(rel) <= MODE_RTOL and s_dist <= MODE_RTOL):
            raise AssertionError(f"{label} does not track the float32 solve: objectives {rel}, scores {s_dist}")
        if run["head"].W.dtype != torch.float32:
            raise AssertionError(f"{label}: W is {run['head'].W.dtype}")
        check_visit(torch, run["visit"], conf.lam, u, label)
        del run
    del f32

    # Queue: the streamed objectives 3.8e-4-4.0e-4 from the eager ones. One
    # centered float32 A for all three solves, so that only the forming of
    # the inverses differs.
    w = BlockWeightedLeastSquaresEstimator(mixture_weight=conf.mixture_weight)._weights(targets)
    with torch.inference_mode():
        wsum = w.sum()
        x_mean = (w @ A_dev) / wsum
        A_c = A_dev - x_mean
        Y_c = targets - (w @ targets) / wsum
    del A_dev
    A_c_host = A_c.cpu().numpy()
    real_inverse = bcd.spd_inverse

    def one_at_a_time(grams):
        return torch.stack([real_inverse(g) for g in grams])

    objs = {}
    for label in ("eager, batched inverses", "eager, inverses one block at a time", "streamed"):
        with StageTimer("cuda") as timer:
            if label == "streamed":
                bcd.block_coordinate_descent_streamed(A_c_host, Y_c, 8192, n_iters, lam=conf.lam, row_weights=w)
            elif label.endswith("batched inverses"):
                bcd.block_coordinate_descent(A_c, Y_c, 8192, n_iters, lam=conf.lam, row_weights=w)
            else:
                with patch.object(bcd, "spd_inverse", one_at_a_time):
                    bcd.block_coordinate_descent(A_c, Y_c, 8192, n_iters, lam=conf.lam, row_weights=w)
        timer.seconds()
        objs[label] = [float(timer.notes[f"objective after epoch {e}"]) for e in range(1, n_iters + 1)]
        print(f"same centered A, {label}: objectives " + ", ".join(f"{o:.9e}" for o in objs[label]))

    def gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(objs[a], objs[b]))

    one, batched, between = (gap("eager, inverses one block at a time", "streamed"),
                             gap("eager, batched inverses", "streamed"),
                             gap("eager, inverses one block at a time", "eager, batched inverses"))
    # A comparison, not a check: it measures where the estimators' gap
    # comes from.
    print(f"objective gaps (largest over epochs, relative): streamed vs eager with inverses one at a time "
          f"{one:.3e}, streamed vs eager batched {batched:.3e}, one at a time vs batched {between:.3e}; the "
          f"estimators' streamed vs eager, each centering on its own: " + ", ".join(
              f"{abs(s - e) / abs(e):.3e}" for s, e in zip(streamed["objectives"], eager["objectives"])))


# The real-data phase: a JPEG dataset made from a seed in a temporary
# directory, 1,000 synsets (half as .tar archives, half as directories), 4
# training and 1 test image each, 500x375 RGB at quality 90 (ImageNet's
# typical size, so decode and resize do real work).
REAL_SYNSETS = 1000
REAL_TRAIN_PER, REAL_TEST_PER = 4, 1
REAL_W, REAL_H = 500, 375


def jpeg_dataset(np, root: str, seed: int = 0) -> dict:
    """Each synset's images: the synthetic loader's grating of that class
    (its angle and frequency), drawn at 500x375 with a random phase, tint
    and pixel noise, encoded by PIL; made in threads, one synset a task."""
    import io
    import os
    import tarfile
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    yy, xx = np.mgrid[0:REAL_H, 0:REAL_W].astype(np.float32)
    angles = np.linspace(0, np.pi, REAL_SYNSETS, endpoint=False)
    freqs = 2 + (np.arange(REAL_SYNSETS) % 8)
    with open(os.path.join(root, "labels.txt"), "w") as f:
        f.writelines(f"n{c:08d} {c}\n" for c in range(REAL_SYNSETS))
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split))

    def one(c: int) -> int:
        rng = np.random.default_rng([seed, c])
        proj = (xx * np.cos(angles[c]) + yy * np.sin(angles[c])) * np.float32(2 * np.pi * freqs[c] / 256)
        written = 0
        for split, per in (("train", REAL_TRAIN_PER), ("test", REAL_TEST_PER)):
            synset = f"n{c:08d}"
            blobs = []
            for _ in range(per):
                base = 0.5 + 0.5 * np.sin(proj + np.float32(rng.uniform(0, 2 * np.pi)))
                tint = (0.5 + 0.5 * rng.uniform(size=3)).astype(np.float32)
                pixels = 230 * base[..., None] * tint + rng.integers(0, 25, size=(REAL_H, REAL_W, 3), dtype=np.uint8)
                out = io.BytesIO()
                Image.fromarray(pixels.astype(np.uint8)).save(out, format="JPEG", quality=90)
                blobs.append(out.getvalue())
            if c % 2 == 0:
                with tarfile.open(os.path.join(root, split, f"{synset}.tar"), "w") as tf:
                    for i, blob in enumerate(blobs):
                        info = tarfile.TarInfo(f"{synset}_{i}.JPEG")
                        info.size = len(blob)
                        tf.addfile(info, io.BytesIO(blob))
            else:
                os.makedirs(os.path.join(root, split, synset))
                for i, blob in enumerate(blobs):
                    with open(os.path.join(root, split, synset, f"{synset}_{i}.JPEG"), "wb") as f:
                        f.write(blob)
            written += sum(len(b) for b in blobs)
        return written

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        nbytes = sum(pool.map(one, range(REAL_SYNSETS)))
    return {"data_path": os.path.join(root, "train"), "test_data_path": os.path.join(root, "test"),
            "label_map_path": os.path.join(root, "labels.txt"), "bytes": nbytes}


def fit_real(torch, eager, root: str) -> tuple:
    """Decode against featurize throughput on the card, the first streamed
    batch against ``load``, then ``run_streamed`` end to end on the JPEGs,
    written under ``root``. Returns the Fisher-vector launches of that run
    and the JPEGs' paths."""
    import os

    import numpy as np

    import keystone_tpu_torch.ops.fisher_vector as fvo
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.loaders.labeled_data import decode_pool_workers
    from keystone_tpu_torch.loaders.stream import BatchIterator
    from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as pipe
    from keystone_tpu_torch.utils.stages import StageTimer
    from keystone_tpu_torch.workflow import FusedTransformer

    cores = os.cpu_count() or 1
    workers = decode_pool_workers(None)
    t0 = time.perf_counter()
    paths = jpeg_dataset(np, root)
    n_train, n_test = REAL_SYNSETS * REAL_TRAIN_PER, REAL_SYNSETS * REAL_TEST_PER
    print(f"dataset: {REAL_SYNSETS} synsets (half .tar, half directories), {n_train} training and {n_test} "
          f"test JPEGs of {REAL_W}x{REAL_H} at quality 90, {paths.pop('bytes') / 2**20:.1f} MiB, encoded in "
          f"{time.perf_counter() - t0:.3f} s (host, not part of the phase)")
    label_map = ImageNetLoader.load_label_map(paths["label_map_path"])

    t0 = time.perf_counter()
    train = ImageNetLoader.load(paths["data_path"], label_map)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, n_streamed = None, 0
    for X, y in ImageNetLoader.stream_batches(paths["data_path"], label_map, batch_size=256):
        first = (X, y) if first is None else first
        n_streamed += len(X)
    stream_s = time.perf_counter() - t0
    for name, secs in (("load", load_s), ("stream_batches (batches of 256)", stream_s)):
        print(f"decode, {name}: {n_train} images to 256x256 in {secs:.3f} s = {n_train / secs:.1f} images/s, "
              f"{n_train / secs / cores:.1f} per host core ({cores} cores, {workers} decode threads)")
    same = np.array_equal(first[0], train.data[:256]) and np.array_equal(first[1], train.labels[:256])
    print(f"first streamed batch equal to load's first 256 images bit for bit: {same}")
    if not same or n_streamed != n_train or train.data.shape != (n_train, 256, 256, 3):
        raise AssertionError("stream_batches disagrees with load")

    featurizer = FusedTransformer(eager["scored"].serving_chain().stages[:-1])
    rates = {}
    for name, batches in (
        ("decoded images (host arrays, pinned staging)", lambda: BatchIterator.from_arrays(train.data, train.labels, 256)),
        ("stream_batches (decode and featurize together)", lambda: ImageNetLoader.stream_batches(
            paths["data_path"], label_map, batch_size=256)),
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            n = sum(len(F) for F, _ in featurizer.apply_batches(batches(), device="cuda"))
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t0)
        print(f"featurizing {n} images in batches of 256 from {name}: {rates[name]:.1f} images/s (host clock; "
              "features left on the card)")
    decode_rate = n_train / stream_s
    card_rate = rates["decoded images (host arrays, pinned staging)"]
    print(f"decode keeps up with the card: {decode_rate >= card_rate} (decode {decode_rate:.1f} images/s on "
          f"{cores} cores against featurizing {card_rate:.1f} images/s; ratio {decode_rate / card_rate:.3f})")
    del train, first

    conf = pipe.ImageNetSiftLcsFVConfig(**paths, pca_dims=64, stream=True, stream_batch=256,
                                        fit_sample_images=512)
    scale = pipe.resolve_scale(conf)
    if (scale.gmm_k, scale.num_iters, scale.feature_dim) != (256, 3, 65536):
        raise AssertionError("real data does not resolve to the reference's 65,536 features and 3 epochs")
    fitted = {}
    real_fit = pipe.fit_streamed

    def recording_fit(conf, fit_sample, train_batches, num_classes, device=None):
        fitted.update(num_classes=num_classes, sample=np.shape(fit_sample))
        fitted["scored"] = real_fit(conf, fit_sample, train_batches, num_classes, device)
        return fitted["scored"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with patch.object(pipe, "fit_streamed", recording_fit):
        fvo.LAUNCHES = 0  # the real-data path's run starts here
        with StageTimer("cuda") as timer:
            out = pipe.run(conf, device="cuda")
        launches = fvo.LAUNCHES  # and ends here
    secs = timer.seconds()
    peak = torch.cuda.max_memory_allocated() / 2**30
    head = fitted["scored"].transformers()[-1]
    print(f"run_streamed on the JPEGs: {out['summary']}; feature dim {out['feature_dim']}, {fitted['num_classes']} "
          f"classes, featurizer sample {fitted['sample']}, head W {tuple(head.W.shape)}; {out['seconds']:.3f} s "
          f"(host clock)")
    print("run_streamed stages (s, CUDA events): " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
          + f"; sum {sum(secs.values()):.4f}; peak device memory {peak:.3f} GiB")
    print("run_streamed per-block medians: " + blocks_line(timer.notes))
    want = 2 * (-(-n_train // 256) + -(-n_test // 256))
    print(f"fv launches of run_streamed on real data: {launches} (2 branches x {want // 2} batches of 256: "
          f"training and test)")
    if (out["feature_dim"], fitted["num_classes"], head.W.shape) != (65536, REAL_SYNSETS, (65536, REAL_SYNSETS)):
        raise AssertionError("the real-data fit is not 65,536 features over 1,000 classes")
    if fitted["sample"] != (512, 256, 256, 3) or launches != want:
        raise AssertionError(f"real-data run: sample {fitted['sample']}, {launches} launches (want {want})")
    if not all(np.isfinite([out["top_k_error"], out["top_1_error"]])):
        raise AssertionError("the real-data errors are not finite")
    return launches, paths


# The other image pipelines, at the reference's published widths and their
# datasets' real counts. VOC 2007: 5,011 training and 4,952 test images of
# 20 classes, 128x128 (the loader's size for real images); the synthetic
# loader gives n // 4 test images, so the test split is the training split
# of the next seed (another generator stream). MNIST: 60,000 and 10,000
# rows; CIFAR-10: 50,000 and 10,000 images; both written in their binary
# formats (the synthetic images rounded to bytes) and read back by the
# pipelines' own loaders through ``run``.
VOC_COUNTS = (5011, 4952)
VOC_CLASSES = 20
VOC_SIZE = 128
VOC_M, VOC_K = 841, 16  # descriptors of a 128x128 image at step 4, bin 4; GMM components
MNIST_COUNTS = (60000, 10000)
CIFAR_COUNTS = (50000, 10000)
# Card against CPU, reduced: rows (MNIST) and images (CIFAR) of training
# data; the loaders' n // 4 test split.
REDUCED = {"mnist": 4096, "cifar": 2048}
# Features on the card against the CPU, relative to the largest |feature|:
# float32 FFTs of the same rows; for CIFAR, filters from two float32 ZCA
# fits (eigh on two backends) through 108-term sums.
MNIST_FEATURE_RTOL = 1e-4
CIFAR_FEATURE_RTOL = 1e-3
# The normal equations' residual |(A'A + lam I) W - A'Y| / |A'Y| in float64,
# A as the solver centered it in float32: float32 sums over n rows (the
# gram and A'Y) and the Cholesky solve leave it below
# NE_C x sqrt(n + 3d) x u x ((| |A|'|A| | + lam sqrt(d)) |W| + | |A|'|Y| |) / |A'Y|,
# Frobenius norms (the probabilistic rounding bound, sqrt of the sum length
# in place of its length).
NE_C = 4.0
# The VOC head's test scores through the plain Fisher vector against the
# kernel's, relative to the largest |score|: SCORE_RTOL.
VOC_MAP_MIN = 0.5  # mean AP far above chance (about 0.08 for 20 classes)


def write_idx(path: str, arr) -> None:
    """``arr`` (uint8) as an IDX file, the format MNIST ships in."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


def as_bytes(np, X):
    return np.clip(np.rint(X * 255.0), 0, 255).astype(np.uint8)


def mnist_files(np, root: str, counts=MNIST_COUNTS) -> dict:
    import os

    from keystone_tpu_torch.loaders.mnist import MnistLoader

    train, test = MnistLoader.synthetic(n=counts[0], seed=0)
    paths = {}
    for name, split, n in (("train", train, counts[0]), ("t10k", test, counts[1])):
        path = os.path.join(root, name)
        write_idx(path + "-images-idx3-ubyte", as_bytes(np, split.data[:n]).reshape(n, 28, 28))
        write_idx(path + "-labels-idx1-ubyte", split.labels[:n].astype(np.uint8))
        paths[name] = path
    return paths


def cifar_files(np, root: str, counts=CIFAR_COUNTS) -> dict:
    import os

    from keystone_tpu_torch.loaders.cifar import CifarLoader

    train, test = CifarLoader.synthetic(n=counts[0], seed=0)
    paths = {}
    for name, split, n in (("train", train, counts[0]), ("test", test, counts[1])):
        planes = as_bytes(np, split.data[:n]).transpose(0, 3, 1, 2).reshape(n, -1)
        path = os.path.join(root, f"{name}.bin")
        np.concatenate([split.labels[:n, None].astype(np.uint8), planes], axis=1).tofile(path)
        paths[name] = path
    return paths


def peak_gib(torch, device) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else float("nan")


def reset_peak(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def stages_line(timer) -> str:
    secs = timer.seconds()
    return ", ".join(f"{k} {v:.4f}" for k, v in secs.items()) + f"; sum {sum(secs.values()):.4f}"


def within(worst: dict, label: str) -> None:
    """Prints ``worst`` ({name: (value, tolerance)}) and raises naming every
    entry past its tolerance."""
    print(f"{label}: " + "; ".join(f"{k} {v:.3e} (tol {t})" for k, (v, t) in worst.items()))
    bad = [k for k, (v, t) in worst.items() if not v <= t]
    if bad:
        raise AssertionError(f"{label}: {bad}")


def rel_to_max(torch, got, want) -> float:
    got, want = (torch.as_tensor(a).double().cpu() for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def voc_pipeline(torch, fvo, device="cuda", counts=VOC_COUNTS) -> dict:
    """VOCSIFTFisher at the reference's config on ``counts`` synthetic
    images: fitted and scored through ``fit`` and ``scores`` (the main
    path; Fisher-vector launches counted), its test scores held against the
    same pipeline with the plain Fisher vector. Returns the launches."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch import nn

    from keystone_tpu_torch.loaders.voc import VOCLoader
    from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
    from keystone_tpu_torch.pipelines.images import voc_sift_fisher as voc
    from keystone_tpu_torch.utils.stages import StageTimer

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        train, test = pool.map(
            lambda seed_n: VOCLoader.synthetic(n=seed_n[1], num_classes=VOC_CLASSES, size=VOC_SIZE,
                                               seed=seed_n[0])[0],
            ((0, counts[0]), (1, counts[1])))
    print(f"voc data: {len(train.data)} training and {len(test.data)} test images of {train.data.shape[1:]}, "
          f"{VOC_CLASSES} classes, {train.labels.sum(axis=1).mean():.3f} present a training image; made in "
          f"{time.perf_counter() - t0:.3f} s (host)")
    conf = voc.VOCSIFTFisherConfig(synthetic_classes=VOC_CLASSES)
    reset_peak(torch, device)
    t0 = time.perf_counter()
    fvo.LAUNCHES = 0  # the VOC path's run starts here
    with StageTimer(device) as timer:
        scored = voc.fit(conf, train, device)
        test_scores = voc.scores(scored, test.data, device)
        timer.mark("scoring the test set")
    launches = fvo.LAUNCHES  # and ends here
    out = voc.evaluate(test_scores, test.labels, VOC_CLASSES, time.perf_counter() - t0)
    want = sum(-(-n // 64) for n in counts)
    print(f"voc_sift_fisher: {out['summary']} over {VOC_CLASSES} classes, per-class AP "
          f"{min(out['per_class_ap']):.4f}..{max(out['per_class_ap']):.4f}; feature dim {conf.feature_dim} "
          f"(pca_dims {conf.pca_dims}, gmm_k {conf.gmm_k}); {out['seconds']:.3f} s (host clock); "
          f"peak device memory {peak_gib(torch, device):.3f} GiB")
    print(f"voc_sift_fisher stages (s, CUDA events): {stages_line(timer)}")
    print(f"fv launches of the VOC fit and scoring: {launches} (batches of 64: {want})")
    if device != "cpu" and launches != want:
        raise AssertionError(f"VOC launches {launches}, want {want}")
    if test_scores.shape != (counts[1], VOC_CLASSES) or not np.isfinite(test_scores).all():
        raise AssertionError("VOC test scores are not finite of the expected shape")
    if not out["map"] >= VOC_MAP_MIN:
        raise AssertionError(f"VOC mAP {out['map']} below {VOC_MAP_MIN}")
    n = min(1024, counts[1])
    # A copy of the fitted chain, its Fisher vector swapped for the plain
    # version (the pipeline's own modules stay as they are).
    plain_chain = with_plain_fv(copy.deepcopy(scored.serving_chain()), FisherVector, fvo, nn)
    plain = voc.scores(plain_chain.to_pipeline(), test.data[:n], device)
    within({"test scores through the plain Fisher vector (rel. to max)":
            (rel_to_max(torch, test_scores[:n], plain), SCORE_RTOL)}, f"voc, kernel against plain, {n} test images")
    return {"launches": launches, "map": out["map"], "seconds": out["seconds"]}


def ne_residual(torch, A, Y, W, lam: float) -> dict:
    """The normal equations of ``W`` checked in float64 on A's device: A and
    Y centered in float32 as ``LinearMapEstimator`` centers them; the
    residual against the bound NE_C states, and W's distance from a float64
    solve."""
    n, d = A.shape
    A64 = (A - A.sum(dim=0) / n).double()
    Y64 = (Y - Y.sum(dim=0) / n).double()
    W64 = W.double()
    G = A64.T @ A64
    G.diagonal().add_(lam)
    rhs = A64.T @ Y64
    residual = float(torch.linalg.norm(G @ W64 - rhs) / torch.linalg.norm(rhs))
    absA = A64.abs()
    scale = ((torch.linalg.norm(absA.T @ absA) + lam * d**0.5) * torch.linalg.norm(W64)
             + torch.linalg.norm(absA.T @ Y64.abs())) / torch.linalg.norm(rhs)
    bound = NE_C * (n + 3 * d) ** 0.5 * F32_UNIT_ROUNDOFF * float(scale)
    exact = torch.linalg.solve(G, rhs)
    eig = torch.linalg.eigvalsh(G)
    return {"residual": residual, "bound": bound, "cond": float(eig[-1] / eig[0]),
            "dist": float(torch.linalg.norm(W64 - exact) / torch.linalg.norm(exact)), "exact": exact}


def mnist_pipeline(torch, root: str, device="cuda", counts=MNIST_COUNTS, reduced=REDUCED["mnist"]) -> None:
    """MnistRandomFFT at the reference's config: ``run`` on IDX files of
    ``counts`` rows; then both solvers on its features (seconds, test
    error, peak memory), the normal equations checked in float64 and the
    two solutions' distance; then card against CPU at ``reduced`` rows."""
    import numpy as np

    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
    from keystone_tpu_torch.nodes.util.classifiers import MaxClassifier
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.images import mnist_random_fft as mnist
    from keystone_tpu_torch.utils.stages import StageTimer

    t0 = time.perf_counter()
    paths = mnist_files(np, root, counts)
    print(f"mnist data: {counts[0]} training and {counts[1]} test rows of 784 as IDX files, made in "
          f"{time.perf_counter() - t0:.3f} s (host)")
    conf = mnist.MnistRandomFFTConfig(train_path=paths["train"], test_path=paths["t10k"])
    reset_peak(torch, device)
    with StageTimer(device) as timer:
        out = mnist.run(conf, device)
    print(f"mnist_random_fft: test error {1 - out['test_accuracy']:.4f}, train error "
          f"{1 - out['train_accuracy']:.4f}; load {out['load_seconds']:.3f} s, fit and predict "
          f"{out['fit_predict_seconds']:.3f} s (host clock); peak device memory {peak_gib(torch, device):.3f} GiB")
    print(f"mnist_random_fft stages (s, CUDA events): {stages_line(timer)}")

    train, test = MnistLoader.load(paths["train"]), MnistLoader.load(paths["t10k"])
    featurizer = mnist.build_featurizer(conf, 784, device=device).serving_chain()
    with torch.inference_mode():
        A = featurizer.apply_in_batches(train.data, batch_size=4096, device=device)
        F_test = featurizer.apply_in_batches(test.data, batch_size=4096, device=device)
        Y = ClassLabelIndicators(conf.num_classes)(torch.as_tensor(train.labels).to(device))
        mappers = {}
        for method in ("normal", "tsqr"):
            reset_peak(torch, device)
            with StageTimer(device) as timer:
                mappers[method] = LinearMapEstimator(lam=conf.lam, method=method).fit(A, Y)
            pred = MaxClassifier()(mappers[method](F_test)).cpu().numpy()
            print(f"mnist {method}: A {tuple(A.shape)}; fit {sum(timer.seconds().values()):.4f} s (CUDA events), "
                  f"test error {float((pred != test.labels).mean()):.4f}, peak device memory "
                  f"{peak_gib(torch, device):.3f} GiB")
        t0 = time.perf_counter()
        check = ne_residual(torch, A, Y, mappers["normal"].W, conf.lam)
        Wn, Wt = mappers["normal"].W.double(), mappers["tsqr"].W.double()
        apart = float(torch.linalg.norm(Wn - Wt) / torch.linalg.norm(Wt))
        tsqr_dist = float(torch.linalg.norm(Wt - check["exact"]) / torch.linalg.norm(check["exact"]))
    print(f"mnist normal equations in float64 ({A.shape[0]} rows, {A.shape[1]} features, lam {conf.lam}): ridge "
          f"gram condition number {check['cond']:.3e}; residual {check['residual']:.3e} (tol {check['bound']:.3e}); "
          f"distance from a float64 solve: normal {check['dist']:.3e}, tsqr {tsqr_dist:.3e}; normal against tsqr "
          f"{apart:.3e} ({time.perf_counter() - t0:.3f} s)")
    kappa_tol = SOLVE_KAPPA_U * check["cond"] * F32_UNIT_ROUNDOFF
    print(f"mnist normal equations: distance from a float64 solve {check['dist']:.3e} "
          f"(tol {SOLVE_KAPPA_U} x kappa x u = {kappa_tol:.3e})")
    if not (check["residual"] <= check["bound"] and check["dist"] <= kappa_tol):
        raise AssertionError("the MNIST head does not solve its normal equations")

    train, test = MnistLoader.synthetic(n=reduced, seed=1)
    rconf = mnist.MnistRandomFFTConfig()
    feats, errs = {}, {}
    for dev in (device, "cpu"):
        featurizer = mnist.build_featurizer(rconf, 784, device=dev)
        pipe = mnist.build_pipeline(rconf, train.data, train.labels, dev, featurizer=featurizer)
        with torch.inference_mode():
            feats[dev] = featurizer.serving_chain()(torch.from_numpy(test.data).to(dev)).cpu()
        errs[dev] = float((mnist.predict(pipe, test.data, dev) != test.labels).mean())
    within({"test features (rel. to max)": (rel_to_max(torch, feats[device], feats["cpu"]), MNIST_FEATURE_RTOL),
            "test error (abs)": (abs(errs[device] - errs["cpu"]), FIT_ERROR_TOL)},
           f"mnist, card against cpu, {reduced} training rows (errors {errs[device]:.4f} / {errs['cpu']:.4f})")


def conv_against_float64(torch, device) -> None:
    """The Convolver on 64 CIFAR-sized images at the reference's filter
    shape, against a float64 convolution of the same operands (bfloat16-
    rounded in that mode): each output within gamma_108 of the sum of its
    products' magnitudes, which holds for float32 sums of exact products
    and fails for TF32 products of float32 operands."""
    import torch.nn.functional as F

    from keystone_tpu_torch.nodes.images.convolver import Convolver

    g = torch.Generator().manual_seed(3)
    X = torch.rand(64, 32, 32, 3, generator=g)
    filt = torch.randn(256, 6, 6, 3, generator=g)
    terms = 6 * 6 * 3
    gamma = terms * F32_UNIT_ROUNDOFF / (1 - terms * F32_UNIT_ROUNDOFF)
    worst = {}
    for dtype in (None, "bfloat16"):
        conv = Convolver(filt, compute_dtype=dtype, device=device)
        with torch.inference_mode():
            got = conv(X.to(device)).double().cpu()
        x, w = X, filt
        if dtype:
            x, w = (t.to(torch.bfloat16).double() for t in (X, filt))
        x, w = x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2)
        exact = F.conv2d(x, w).permute(0, 2, 3, 1)
        mags = F.conv2d(x.abs(), w.abs()).permute(0, 2, 3, 1)
        worst[f"{dtype or 'float32'}: max |error| / sum |products|"] = (float(((got - exact).abs() / mags).max()), gamma)
    within(worst, "convolver against a float64 convolution, 64 images x 256 filters 6x6x3")


def cifar_pipelines(torch, root: str, device="cuda", counts=CIFAR_COUNTS, reduced=REDUCED["cifar"]) -> None:
    """RandomPatchCifar (float32 and bfloat16 features) and LinearPixels at
    the reference's configs through ``run`` on CIFAR binary files of
    ``counts`` images; the convolver against float64; then RandomPatchCifar
    card against CPU at ``reduced`` training images."""
    import numpy as np

    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.pipelines.images import linear_pixels as lp
    from keystone_tpu_torch.pipelines.images import random_patch_cifar as rpc
    from keystone_tpu_torch.utils.stages import StageTimer
    from keystone_tpu_torch.workflow import FusedTransformer

    t0 = time.perf_counter()
    paths = cifar_files(np, root, counts)
    print(f"cifar data: {counts[0]} training and {counts[1]} test 32x32x3 images in CIFAR-10's binary format, "
          f"made in {time.perf_counter() - t0:.3f} s (host)")
    for dtype in (None, "bfloat16"):
        conf = rpc.RandomPatchCifarConfig(train_path=paths["train"], test_path=paths["test"], feature_dtype=dtype)
        reset_peak(torch, device)
        with StageTimer(device) as timer:
            out = rpc.run(conf, device)
        print(f"random_patch_cifar ({dtype or 'float32'} features): test error {1 - out['test_accuracy']:.4f}, "
              f"{out['seconds']:.3f} s (host clock, after loading); peak device memory {peak_gib(torch, device):.3f} GiB")
        print(f"random_patch_cifar ({dtype or 'float32'}) stages (s, CUDA events): {stages_line(timer)}")
    reset_peak(torch, device)
    with StageTimer(device) as timer:
        out = lp.run(lp.LinearPixelsConfig(train_path=paths["train"], test_path=paths["test"]), device)
    print(f"linear_pixels: test error {1 - out['test_accuracy']:.4f}, {out['seconds']:.3f} s (host clock, after "
          f"loading); peak device memory {peak_gib(torch, device):.3f} GiB")
    print(f"linear_pixels stages (s, CUDA events): {stages_line(timer)}")
    conv_against_float64(torch, device)

    train, test = CifarLoader.synthetic(n=reduced, seed=1)
    rconf = rpc.RandomPatchCifarConfig()
    feats, errs = {}, {}
    for dev in (device, "cpu"):
        pipe = rpc.fit(rconf, train.data, train.labels, dev)
        with torch.inference_mode():
            feats[dev] = FusedTransformer(list(pipe.serving_chain().stages)[:-2])(
                torch.from_numpy(test.data).to(dev)).cpu()
        errs[dev] = float((rpc.predict(pipe, test.data, dev) != test.labels).mean())
    within({"test features (rel. to max)": (rel_to_max(torch, feats[device], feats["cpu"]), CIFAR_FEATURE_RTOL),
            "test error (abs)": (abs(errs[device] - errs["cpu"]), FIT_ERROR_TOL)},
           f"random_patch_cifar, card against cpu, {reduced} training images (errors {errs[device]:.4f} / "
           f"{errs['cpu']:.4f})")


def other_pipelines(torch, fvo, device="cuda") -> dict:
    """VOCSIFTFisher, MnistRandomFFT, RandomPatchCifar and LinearPixels at
    full width. Returns the VOC path's Fisher-vector launches."""
    import tempfile

    t0 = time.perf_counter()
    voc = voc_pipeline(torch, fvo, device)
    with tempfile.TemporaryDirectory() as root:
        mnist_pipeline(torch, root, device)
        cifar_pipelines(torch, root, device)
    print(f"other pipelines: {time.perf_counter() - t0:.3f} s")
    return voc


# The speech and text pipelines. TIMIT: 440-dim frames (40 x 11, the
# synthetic loader's context splicing) over its 147 phone states, 200,000
# training and 50,000 test frames (a cut of the corpus's frame count),
# written as .npz and read through ``main``, at the CLI's settings (gamma
# 0.055, lam 0.1, blocks of 2,048, 3 epochs) with 16,384 features: A is
# 12.2 GiB, over half the 12 GiB budget, so the head streams from host
# memory. Newsgroups: 20 Newsgroups' by-date split, 11,314 and 7,532
# documents in 20 class directories, about 250 tokens each. Amazon:
# 65,536 and 16,384 reviews (a cut) of 60-120 tokens as JSON lines. The
# texts come from a seeded Zipfian vocabulary (exponent ZIPF_S over
# VOCAB_SIZE word types); each class, or polarity, draws TOPIC_SHARE of
# its tokens from its own TOPIC_WORDS words.
TIMIT_COUNTS = (200000, 50000)
TIMIT_FEATURES = 16384
NEWSGROUPS_COUNTS = (11314, 7532)
NEWSGROUPS_CLASSES = 20
NEWSGROUPS_TOKENS = (200, 300)
AMAZON_COUNTS = (65536, 16384)
AMAZON_TOKENS = (60, 120)
VOCAB_SIZE = 50000
ZIPF_S = 1.07
TOPIC_WORDS = 500
TOPIC_SHARE = 0.04
# The sparse streamed solve on Amazon's features: blocks of 2,048, 2 epochs.
AMAZON_BLS = dict(block_size=2048, num_iters=2, lam=0.1)
# Card against CPU, reduced: TIMIT frames and features; documents of each
# text pipeline (the test split a quarter of it).
REDUCED_TIMIT = (8192, 2048)
REDUCED_TEXTS = 2000
# Scores on the card against the CPU, relative to the largest |score|:
# naive Bayes sums float32 products of the same log-likelihoods; TIMIT's
# head comes from float32 grams and inverses of another summation order;
# logistic regression from 100 L-BFGS steps whose line search decides on
# float32 values that differ in rounding. Predictions differ on at most
# TEXT_DISAGREEMENT of the test rows, and the L-BFGS objectives within a
# relative LBFGS_OBJECTIVE_RTOL.
NB_SCORE_RTOL = 1e-4
TIMIT_SCORE_RTOL = 1e-3
LBFGS_SCORE_RTOL = 1e-2
TEXT_DISAGREEMENT = 1e-3
LBFGS_OBJECTIVE_RTOL = 1e-3
# Quality far above chance on the synthetic data (1/147, 1/20, 0.5).
TIMIT_PER_MAX = 0.5
NEWSGROUPS_ACCURACY_MIN = 0.5
AMAZON_AUC_MIN = 0.8


def pseudo_words(n: int) -> list:
    """``n`` distinct lowercase words of two or three syllables."""
    syllables = [c + v for c in "bcdfghjklmnprstvwxz" for v in "aeiou"]
    s = len(syllables)
    return [syllables[i % s] + syllables[(i // s) % s] + (syllables[i // (s * s)] if i >= s * s else "")
            for i in range(n)]


def zipf_corpus(np, counts, num_classes: int, lengths, seed: int) -> list:
    """One (texts, labels) per entry of ``counts``: each text of
    ``lengths`` tokens from the Zipfian vocabulary, TOPIC_SHARE of them from
    its class's topic words; a few title-cased, some followed by a comma or
    a full stop, so the front end's trim, lower-casing and tokenizer work."""
    rng = np.random.default_rng(seed)
    words = pseudo_words(VOCAB_SIZE)
    rng.shuffle(words)
    vocab = np.array(words, dtype=object)
    titled = np.array([w.title() for w in words], dtype=object)
    cdf = np.cumsum(np.arange(1, VOCAB_SIZE + 1, dtype=np.float64) ** -ZIPF_S)
    topics = np.stack([rng.choice(np.arange(100, 20000), TOPIC_WORDS, replace=False) for _ in range(num_classes)])
    tcdf = np.cumsum(np.arange(1, TOPIC_WORDS + 1, dtype=np.float64) ** -ZIPF_S)
    out = []
    for n in counts:
        labels = rng.integers(0, num_classes, size=n)
        lens = rng.integers(lengths[0], lengths[1] + 1, size=n)
        total = int(lens.sum())
        ids = np.searchsorted(cdf, rng.random(total) * cdf[-1])
        topical = rng.random(total) < TOPIC_SHARE
        cls = np.repeat(labels, lens)[topical]
        ids[topical] = topics[cls, np.searchsorted(tcdf, rng.random(int(topical.sum())) * tcdf[-1])]
        toks = np.where(rng.random(total) < 0.05, titled[ids], vocab[ids])
        marks = rng.random(total)
        toks = np.where(marks < 0.04, toks + ",", np.where(marks > 0.96, toks + ".", toks))
        ends = np.cumsum(lens)
        texts = ["  " + " ".join(toks[e - k:e]) + "\n" for e, k in zip(ends.tolist(), lens.tolist())]
        out.append((texts, labels.astype(np.int32)))
    return out


def write_newsgroups(root: str, name: str, texts, labels) -> str:
    """A directory per class, one file per document; returns its path."""
    import os

    top = os.path.join(root, name)
    for c in range(NEWSGROUPS_CLASSES):
        os.makedirs(os.path.join(top, f"group{c:02d}"))
    for i, (text, c) in enumerate(zip(texts, labels.tolist())):
        with open(os.path.join(top, f"group{c:02d}", f"{i:06d}"), "w") as f:
            f.write(text)
    return top


def write_reviews(np, root: str, name: str, texts, labels, seed: int) -> str:
    """JSON lines with ``reviewText`` and star ratings ``overall``: 4 or 5
    stars for a positive review, 1 to 3 for a negative one."""
    import os

    rng = np.random.default_rng(seed)
    stars = np.where(labels == 1, rng.integers(4, 6, size=len(labels)), rng.integers(1, 4, size=len(labels)))
    path = os.path.join(root, name)
    with open(path, "w") as f:
        for text, s in zip(texts, stars.tolist()):
            f.write(json.dumps({"reviewText": text, "overall": float(s)}) + "\n")
    return path


def agreement(scores, want) -> float:
    return float((scores.argmax(axis=1) == want.argmax(axis=1)).mean())


def lbfgs_line(out: dict) -> str:
    fit = out["stage_seconds"]["fit"]
    return (f"L-BFGS {out['lbfgs_steps']} steps, {out['lbfgs_evaluations']} evaluations, "
            f"{fit / out['lbfgs_steps'] * 1e3:.3f} ms a step (host clock, fit {fit:.3f} s); objective "
            f"{out['objective']:.6e}")


def text_seconds(out: dict) -> str:
    s = out["stage_seconds"]
    return (f"host: front end {s['front_end']:.3f}, vectorizing {s['vectorize']:.3f}, test front end "
            f"{s['front_end_test']:.3f}; device: fit {s['fit']:.3f}, scoring {s['predict']:.3f} (s, host clock, "
            f"synchronized); total {out['seconds']:.3f}")


def timit_full(torch, np, root: str, device) -> None:
    """TIMIT through ``main`` at full width from .npz files."""
    import os

    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu_torch.pipelines.speech import timit
    from keystone_tpu_torch.utils.stages import StageTimer

    t0 = time.perf_counter()
    train, test = TimitFeaturesDataLoader.synthetic(n=TIMIT_COUNTS[0], num_phones=TimitFeaturesDataLoader.NUM_PHONES)
    paths = {}
    for name, split in (("train", train), ("test", test)):
        paths[name] = os.path.join(root, f"timit_{name}.npz")
        np.savez(paths[name], features=split.data, labels=split.labels)
    print(f"timit data: {len(train.data)} training and {len(test.data)} test frames of {train.data.shape[1]}, "
          f"{TimitFeaturesDataLoader.NUM_PHONES} phone states, written as .npz in {time.perf_counter() - t0:.3f} s "
          f"(host)")
    del train, test
    reset_peak(torch, device)
    with StageTimer(device) as timer:
        out = timit.main(["--features", paths["train"], "--test-features", paths["test"],
                          "--num-features", str(TIMIT_FEATURES), "--device", str(device)])
    blocks = timer.notes.get("streamed BCD blocks")
    a_gib = TIMIT_COUNTS[0] * TIMIT_FEATURES * 4 / 2**30
    print(f"timit: PER {out['phone_error_rate']:.4f}, macro-F1 {out['macro_f1']:.4f}; {out['seconds']:.3f} s "
          f"(host clock, after loading); A {TIMIT_COUNTS[0]} x {TIMIT_FEATURES} = {a_gib:.3f} GiB float32, "
          f"head {'streamed from host memory' if blocks else 'solved on the card'}; peak device memory "
          f"{peak_gib(torch, device):.3f} GiB")
    print(f"timit stages (s, CUDA events): {stages_line(timer)}")
    objectives = [float(timer.notes[f"objective after epoch {e}"]) for e in range(1, 4)]
    print(f"timit objectives per epoch: {', '.join(f'{v:.6e}' for v in objectives)}")
    if blocks is None:
        raise AssertionError("TIMIT's head did not stream")
    print(f"timit {blocks_line(timer.notes)}")
    if any(b > a * (1 + OBJECTIVE_RTOL) for a, b in zip(objectives, objectives[1:])):
        raise AssertionError(f"TIMIT objective grew: {objectives}")
    scores = out["scores"]
    if scores.shape != (TIMIT_COUNTS[1], TimitFeaturesDataLoader.NUM_PHONES) or not np.isfinite(scores).all():
        raise AssertionError("TIMIT test scores are not finite of the expected shape")
    if not out["phone_error_rate"] <= TIMIT_PER_MAX:
        raise AssertionError(f"TIMIT PER {out['phone_error_rate']} above {TIMIT_PER_MAX}")


def text_full(torch, np, root: str, device) -> None:
    """Newsgroups (both classifiers) and Amazon through ``main`` from files,
    then the sparse streamed block solver on Amazon's features."""
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
    from keystone_tpu_torch.pipelines.text import amazon_reviews, newsgroups
    from keystone_tpu_torch.evaluation.binary import BinaryClassifierEvaluator
    from keystone_tpu_torch.utils.sparse import SparseBatch
    from keystone_tpu_torch.utils.stages import StageTimer

    t0 = time.perf_counter()
    (tr, te) = zipf_corpus(np, NEWSGROUPS_COUNTS, NEWSGROUPS_CLASSES, NEWSGROUPS_TOKENS, seed=10)
    dirs = [write_newsgroups(root, name, *split) for name, split in (("ng_train", tr), ("ng_test", te))]
    tokens = sum(len(t.split()) for t in tr[0])
    print(f"newsgroups data: {len(tr[0])} training and {len(te[0])} test documents in {NEWSGROUPS_CLASSES} "
          f"directories, {tokens / len(tr[0]):.1f} tokens a training document, from {VOCAB_SIZE} word types; "
          f"written in {time.perf_counter() - t0:.3f} s (host)")
    for classifier in ("naive_bayes", "logistic"):
        reset_peak(torch, device)
        with StageTimer(device) as timer:
            out = newsgroups.main(["--train", dirs[0], "--test", dirs[1], "--classifier", classifier,
                                   "--device", str(device)])
        print(f"newsgroups ({classifier}): accuracy {out['test_accuracy']:.4f}, macro-F1 {out['macro_f1']:.4f}; "
              f"{text_seconds(out)}; peak device memory {peak_gib(torch, device):.3f} GiB")
        print(f"newsgroups ({classifier}) stages (s, CUDA events): {stages_line(timer)}")
        if classifier == "logistic":
            print(f"newsgroups (logistic): {lbfgs_line(out)}")
        if out["scores"].shape != (NEWSGROUPS_COUNTS[1], NEWSGROUPS_CLASSES) or not np.isfinite(out["scores"]).all():
            raise AssertionError("Newsgroups test scores are not finite of the expected shape")
        if not out["test_accuracy"] >= NEWSGROUPS_ACCURACY_MIN:
            raise AssertionError(f"Newsgroups ({classifier}) accuracy {out['test_accuracy']}")

    t0 = time.perf_counter()
    (tr, te) = zipf_corpus(np, AMAZON_COUNTS, 2, AMAZON_TOKENS, seed=20)
    paths = [write_reviews(np, root, name, *split, seed=s)
             for name, split, s in (("amazon_train.jsonl", tr, 21), ("amazon_test.jsonl", te, 22))]
    print(f"amazon data: {len(tr[0])} training and {len(te[0])} test reviews as JSON lines; written in "
          f"{time.perf_counter() - t0:.3f} s (host)")
    reset_peak(torch, device)
    with StageTimer(device) as timer:
        out = amazon_reviews.main(["--train", paths[0], "--test", paths[1], "--device", str(device)])
    X, Xt = out["features"], out["test_features"]
    print(f"amazon (logistic): accuracy {out['accuracy']:.4f}, F1 {out['f1']:.4f}, AUC {out['auc']:.4f}; "
          f"{text_seconds(out)}; peak device memory {peak_gib(torch, device):.3f} GiB")
    print(f"amazon stages (s, CUDA events): {stages_line(timer)}")
    print(f"amazon: {lbfgs_line(out)}; features {X!r} ({X.nnz / len(X):.1f} a review, "
          f"{X.nbytes / 2**20:.1f} MiB as CSR against {X.shape[0] * X.shape[1] * 4 / 2**30:.2f} GiB dense)")
    if not isinstance(X, SparseBatch) or X.dim != 20000:
        raise AssertionError(f"Amazon features are not a 20,000-column SparseBatch: {X!r}")
    if not out["auc"] >= AMAZON_AUC_MIN:
        raise AssertionError(f"Amazon AUC {out['auc']}")

    y = np.asarray(te[1])
    targets = 2.0 * np.eye(2, dtype=np.float32)[tr[1]] - 1.0
    reset_peak(torch, device)
    with StageTimer(device) as timer:
        t0 = time.perf_counter()
        model = BlockLeastSquaresEstimator(**AMAZON_BLS, device=device).fit(X, targets)
        scores = model(Xt).cpu().numpy()
        wall = time.perf_counter() - t0
    metrics = BinaryClassifierEvaluator.evaluate(scores.argmax(axis=1), y, scores=scores[:, 1] - scores[:, 0])
    print(f"amazon, sparse block least squares ({AMAZON_BLS}): {wall:.3f} s (host clock, fit and scoring); "
          f"accuracy {metrics.accuracy:.4f}, AUC {metrics.auc:.4f} (logistic regression: {out['accuracy']:.4f}, "
          f"{out['auc']:.4f}); peak device memory {peak_gib(torch, device):.3f} GiB")
    print(f"amazon, sparse block least squares stages (s, CUDA events): {stages_line(timer)}")
    print(f"amazon, sparse block least squares {blocks_line(timer.notes)}")
    if not np.isfinite(scores).all() or not metrics.auc >= AMAZON_AUC_MIN:
        raise AssertionError(f"Amazon's sparse block solve: AUC {metrics.auc}")


def text_card_against_cpu(torch, np, root: str, device) -> None:
    """Each pipeline at a reduced size on the card and on the CPU."""
    from keystone_tpu_torch.pipelines.speech import timit
    from keystone_tpu_torch.pipelines.text import amazon_reviews, newsgroups

    conf = timit.TimitConfig(synthetic_n=REDUCED_TIMIT[0], num_features=REDUCED_TIMIT[1], num_phones=147)
    runs = {dev: timit.run(conf, dev) for dev in (device, "cpu")}
    within({"test scores (rel. to max)": (rel_to_max(torch, runs[device]["scores"], runs["cpu"]["scores"]),
                                         TIMIT_SCORE_RTOL),
            "prediction disagreement": (1 - agreement(runs[device]["scores"], runs["cpu"]["scores"]),
                                        TEXT_DISAGREEMENT)},
           f"timit, card against cpu, {REDUCED_TIMIT[0]} frames, {REDUCED_TIMIT[1]} features "
           f"(PER {runs[device]['phone_error_rate']:.4f} / {runs['cpu']['phone_error_rate']:.4f})")
    n, m = REDUCED_TEXTS, REDUCED_TEXTS // 4
    (tr, te) = zipf_corpus(np, (n, m), NEWSGROUPS_CLASSES, NEWSGROUPS_TOKENS, seed=30)
    dirs = [write_newsgroups(root, name, *split) for name, split in (("ng_small_train", tr), ("ng_small_test", te))]
    for classifier, rtol in (("naive_bayes", NB_SCORE_RTOL), ("logistic", LBFGS_SCORE_RTOL)):
        conf = newsgroups.NewsgroupsConfig(train_path=dirs[0], test_path=dirs[1], classifier=classifier)
        runs = {dev: newsgroups.run(conf, dev) for dev in (device, "cpu")}
        worst = {"test scores (rel. to max)": (rel_to_max(torch, runs[device]["scores"], runs["cpu"]["scores"]),
                                              rtol),
                 "prediction disagreement": (1 - agreement(runs[device]["scores"], runs["cpu"]["scores"]),
                                             TEXT_DISAGREEMENT)}
        if classifier == "logistic":
            a, b = runs[device]["objective"], runs["cpu"]["objective"]
            worst["L-BFGS objective (rel.)"] = (abs(a - b) / abs(b), LBFGS_OBJECTIVE_RTOL)
        within(worst, f"newsgroups ({classifier}), card against cpu, {n} + {m} documents (accuracy "
                      f"{runs[device]['test_accuracy']:.4f} / {runs['cpu']['test_accuracy']:.4f})")
    (tr, te) = zipf_corpus(np, (n, m), 2, AMAZON_TOKENS, seed=40)
    paths = [write_reviews(np, root, name, *split, seed=s)
             for name, split, s in (("amazon_small_train.jsonl", tr, 41), ("amazon_small_test.jsonl", te, 42))]
    conf = amazon_reviews.AmazonReviewsConfig(train_path=paths[0], test_path=paths[1])
    runs = {dev: amazon_reviews.run(conf, dev) for dev in (device, "cpu")}
    a, b = runs[device]["objective"], runs["cpu"]["objective"]
    within({"test scores (rel. to max)": (rel_to_max(torch, runs[device]["scores"], runs["cpu"]["scores"]),
                                         LBFGS_SCORE_RTOL),
            "prediction disagreement": (1 - agreement(runs[device]["scores"], runs["cpu"]["scores"]),
                                        TEXT_DISAGREEMENT),
            "L-BFGS objective (rel.)": (abs(a - b) / abs(b), LBFGS_OBJECTIVE_RTOL)},
           f"amazon, card against cpu, {n} + {m} reviews, features {runs['cpu']['features']!r} (AUC "
           f"{runs[device]['auc']:.4f} / {runs['cpu']['auc']:.4f})")


def speech_and_text(torch, fvo, device="cuda") -> int:
    """TIMIT, Newsgroups and Amazon at full width, then each against the
    CPU at a reduced size. Returns the Fisher-vector launches of the
    full-width runs (none of them runs the kernel)."""
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        fvo.LAUNCHES = 0  # the speech and text paths start here
        timit_full(torch, np, root, device)
        text_full(torch, np, root, device)
        launches = fvo.LAUNCHES  # and end here
        text_card_against_cpu(torch, np, root, device)
    print(f"fv launches of the speech and text pipelines: {launches}")
    print(f"speech and text pipelines: {time.perf_counter() - t0:.3f} s")
    return launches


# The learning nodes, descriptors and native host library (the phase
# "learning suite, descriptors, native"). Kernel ridge regression on
# TIMIT's 440-dim frames (the speech phase's generator and seed), a cut of
# its 200,000 training frames to 50,000 so that 200 CG iterations fit the
# time limit (K would be 50,000² float32 = 9.3 GiB and is never formed),
# and the first 10,000 test frames; 147 classes one-hot; gamma from the
# median heuristic over KRR_GAMMA_ROWS rows (TIMIT's random-feature gamma on
# these frames gives K ≈ I, which makes CG trivial); lam, max_iters and tol
# the reference's defaults. The relative residual |(K + lam I)a - Y| / |Y|,
# in float64 with K from torch.cdist (not the port's kernel code), must be
# at most KRR_RESIDUAL_MAX for each solver (a few times the H100's 1.13e-2
# after CG's 200 steps and 5.3e-5 after PCG's 97; 0 gives 1), and test
# accuracy at least KRR_ACCURACY_MIN (1.0 there).
KRR_COUNTS = (50000, 10000)
KRR_SOLVE = dict(lam=1e-3, max_iters=200, tol=1e-5)
KRR_LANDMARKS = 1024
KRR_GAMMA_ROWS = 1000
KRR_RESIDUAL_MAX = {"CG": 5e-2, "PCG": 1e-3}
KRR_ACCURACY_MIN = 0.9
# LeastSquaresEstimator on the smoke's shapes: (n, d, k) and the solver the
# cost model must choose. 4,096 x 1,024 float32 is exactly 16 MiB, at the
# local threshold (n·d·4 < 16 MiB), so it goes to the normal equations;
# 4,000 rows stay local. MNIST's features come from its featurizer on
# 60,000 synthetic digits; ImageNet's are the full-width training features
# of the streamed phase.
LS_SHAPES = (((4000, 1024, 10), "local"), ((4096, 1024, 10), "normal"))
LS_LAM = 1e-3
# LDA on TIMIT's 200,000 training frames, 147 classes, 146 directions; the
# card against the CPU on the first LDA_CPU_ROWS frames, column by column
# up to sign (eigh picks its signs per solver), relative to each column's
# largest |value|. Only the best direction is held, within LDA_TOP_RTOL (7
# times the H100's 1.4e-4): the later ones may rotate among near-equal
# eigenvalues.
LDA_CPU_ROWS = 20000
LDA_TOP_RTOL = 1e-3
# HOG (cells of 8, 9 bins) and DAISY (defaults) on the full-width phase's
# 8,192 256x256 images in batches of 64; the card against the CPU port on
# DESCRIPTOR_CPU_IMAGES of them within DESCRIPTOR_ATOL (unit-norm
# descriptors, sums in another order).
DESCRIPTOR_BATCH = 64
DESCRIPTOR_CPU_IMAGES = 8
DESCRIPTOR_ATOL = 1e-5
# ``auto`` decode on the first DECODE_IMAGES training JPEGs of the real-data
# phase.
DECODE_IMAGES = 2000
# Native SIFT against the device's on VOC's images: the reference's
# descriptor tolerance (tests/test_descriptors.py:136-145). Native Fisher
# vectors at VOC's shape, on the GMM the native EM fits to VOC's
# descriptors (variances at the 1e-4 floor), against the CUDA kernel at
# tests/test_native.py's tolerance (its native-against-jnp check); the
# kernel against its plain version there at FV_RTOL, FV_ATOL.
NATIVE_SIFT_TOL = 2e-4
NATIVE_FV_RTOL, NATIVE_FV_ATOL = 1e-3, 1e-4
VOC_GMM_SAMPLE = 100_000


def krr_residual(torch, X, Y, alpha, gamma: float, lam: float, rows: int = 2048) -> float:
    """|(K + lam I) alpha - Y| / |Y| in float64, K's rows made in chunks
    from ``torch.cdist``, apart from the port's kernel code."""
    X64, a64, Y64 = X.double(), alpha.double(), Y.double()
    sq = 0.0
    for s in range(0, len(X64), rows):
        K = torch.exp(-gamma * torch.cdist(X64[s:s + rows], X64).square())
        r = K @ a64 + lam * a64[s:s + rows] - Y64[s:s + rows]
        sq += float((r * r).sum())
    return (sq / float((Y64 * Y64).sum())) ** 0.5


def kernel_ridge_full(torch, np, train, test, device) -> None:
    from keystone_tpu_torch.config import config
    from keystone_tpu_torch.nodes.learning import kernel_ridge as kr
    from keystone_tpu_torch.nodes.learning.kernels import pairwise_sq_dists

    n, n_test = KRR_COUNTS
    C = int(train.labels.max()) + 1
    X = torch.from_numpy(train.data[:n]).to(device)
    X_test = torch.from_numpy(test.data[:n_test]).to(device)
    Y = torch.nn.functional.one_hot(torch.from_numpy(train.labels[:n]).long(), C).float().to(device)
    d = X.shape[1]
    rows = np.sort(np.random.default_rng(0).choice(n, KRR_GAMMA_ROWS, replace=False))
    S = X[torch.from_numpy(rows).to(device)]
    sq = pairwise_sq_dists(S, S)
    iu = torch.triu_indices(len(rows), len(rows), 1, device=device)
    gamma = 1.0 / float(sq[iu[0], iu[1]].median())
    print(f"kernel ridge: {n} training and {n_test} test TIMIT frames of {d}, {C} classes one-hot; gamma "
          f"{gamma:.6e} (1 / median squared distance over {KRR_GAMMA_ROWS} rows); lam {KRR_SOLVE['lam']}, "
          f"max_iters {KRR_SOLVE['max_iters']}, tol {KRR_SOLVE['tol']}")
    chunk = kr._chunk_rows(n, config.kernel_block_bytes)
    v = torch.randn(n, C, generator=torch.Generator().manual_seed(0)).to(device)
    ms = cuda_ms(lambda: kr._kernel_matvec(X, gamma, KRR_SOLVE["lam"], v, chunk), 3, torch)
    ops = 2.0 * n * n * d + 2.0 * n * n * C + n * n  # the distances' gemm, K @ v, the exponentials
    moved = 4.0 * (n * d + 2 * n * C)
    bound = max(ops / F32_PEAK_FLOPS, moved / HBM_BYTES_PER_S) * 1e3
    print(f"kernel ridge matvec (K + lam I)v, n={n} d={d} k={C}: {ms:.3f} ms (CUDA events; {-(-n // chunk)} chunks "
          f"of {chunk} rows, {chunk * n * 4 / 2**30:.3f} GiB a block); bound {bound:.3f} ms (operations: "
          f"{ops / 1e12:.3f} TFLOP at float32's 67 TFLOP/s) = {bound / ms:.1%} of the measured time")
    for name, landmarks in (("CG", None), ("PCG", KRR_LANDMARKS)):
        est = kr.KernelRidgeRegression(gamma=gamma, precond_landmarks=landmarks, device=device, **KRR_SOLVE)
        reset_peak(torch, device)
        t0 = time.perf_counter()
        model = est.fit(X, Y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = peak_gib(torch, device)
        resid = krr_residual(torch, X, Y, model.alpha, gamma, KRR_SOLVE["lam"])
        with torch.inference_mode():
            pred = model(X_test).argmax(dim=1).cpu().numpy()
        acc = float((pred == test.labels[:n_test]).mean())
        print(f"kernel ridge, {name}{f', {landmarks} landmarks' if landmarks else ''}: {est.last_cg_iters} "
              f"iterations in {secs:.3f} s (host clock, synced), {secs / max(est.last_cg_iters, 1) * 1e3:.2f} ms an "
              f"iteration; relative residual {resid:.3e} (float64, tol {KRR_RESIDUAL_MAX[name]}); test accuracy "
              f"{acc:.4f} (min {KRR_ACCURACY_MIN}); peak device memory {peak:.3f} GiB")
        if not (torch.isfinite(model.alpha).all() and resid <= KRR_RESIDUAL_MAX[name] and acc >= KRR_ACCURACY_MIN):
            raise AssertionError(f"kernel ridge {name}: residual {resid}, accuracy {acc}")


def ls_residual(torch, A, Y, W, lam: float) -> float:
    """The centered ridge normal equations of W in float64, without forming
    the gram: |Acᵀ(Ac W - Yc) + lam W| / |AcᵀYc|."""
    A64, Y64, W64 = A.double(), Y.double(), W.double()
    A64 -= A64.mean(dim=0)
    Y64 -= Y64.mean(dim=0)
    rhs = A64.T @ Y64
    return float(torch.linalg.norm(A64.T @ (A64 @ W64 - Y64) + lam * W64) / torch.linalg.norm(rhs))


def least_squares_full(torch, np, streamed, device) -> None:
    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
    from keystone_tpu_torch.nodes.learning.local_least_squares import LocalLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.images import mnist_random_fft as mnist

    g = torch.Generator().manual_seed(1)
    cases = []
    for (n, d, k), want in LS_SHAPES:
        A = torch.randn(n, d, generator=g)
        Y = torch.nn.functional.one_hot((A @ torch.randn(d, k, generator=g)).argmax(1), k).float()
        cases.append((f"random {n} x {d}", A.to(device), Y.to(device), want))
    train, _ = MnistLoader.synthetic(n=MNIST_COUNTS[0])
    conf = mnist.MnistRandomFFTConfig()
    with torch.inference_mode():
        featurizer = mnist.build_featurizer(conf, 784, device=device).serving_chain()
        A = featurizer.apply_in_batches(train.data, batch_size=4096, device=device)
        Y = ClassLabelIndicators(conf.num_classes)(torch.as_tensor(train.labels).to(device))
    cases.append((f"MNIST features {A.shape[0]} x {A.shape[1]}", A, Y, "normal"))
    A = torch.as_tensor(streamed["A"]).to(device)
    Y = torch.as_tensor(streamed["targets"]).to(device)
    cases.append((f"ImageNet features {A.shape[0]} x {A.shape[1]}", A, Y, "block"))
    concrete = {
        "local": lambda: LocalLeastSquaresEstimator(LS_LAM, device=device),
        "normal": lambda: LinearMapEstimator(LS_LAM, device=device),
        "block": lambda: BlockLeastSquaresEstimator(block_size=4096, num_iters=3, lam=LS_LAM, device=device),
    }
    for label, A, Y, want in cases:
        est = LeastSquaresEstimator(lam=LS_LAM, device=device)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est.fit(A, Y)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            direct = concrete[est.last_choice.name]().fit(A, Y)
            same = torch.equal(model.W, direct.W) and torch.equal(model(A[:512]), direct(A[:512]))
            resid = ls_residual(torch, A, Y, model.W, LS_LAM)
        print(f"least squares, {label}, {Y.shape[1]} classes: chose {est.last_choice.name} "
              f"({est.last_choice.reason}); {secs:.3f} s (host clock, synced); float64 normal-equations residual "
              f"{resid:.3e}; equal to {type(direct).__name__} called directly: {same}")
        if est.last_choice.name != want or not same:
            raise AssertionError(f"least squares on {label}: chose {est.last_choice.name} (want {want}), same {same}")


def lda_full(torch, np, train, device) -> None:
    from keystone_tpu_torch.nodes.learning.lda import LinearDiscriminantAnalysis

    C = int(train.labels.max()) + 1
    X = torch.from_numpy(train.data).to(device)
    y = torch.from_numpy(train.labels).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lda = LinearDiscriminantAnalysis(dims=C - 1, device=device).fit(X, y)
    torch.cuda.synchronize()
    print(f"lda: {X.shape[0]} x {X.shape[1]} frames, {C} classes, {C - 1} directions in "
          f"{time.perf_counter() - t0:.3f} s on the card (host clock, synced)")
    cut = train.data[:LDA_CPU_ROWS]
    z = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        fitted = LinearDiscriminantAnalysis(dims=C - 1, device=dev).fit(cut, train.labels[:LDA_CPU_ROWS])
        with torch.inference_mode():
            z[dev] = fitted(torch.from_numpy(cut).to(dev)).double().cpu()
        print(f"lda on {LDA_CPU_ROWS} frames, {dev}: {time.perf_counter() - t0:.3f} s (host clock)")
    sign = torch.sign((z[device] * z["cpu"]).sum(dim=0))
    err = ((z[device] * sign - z["cpu"]).abs().max(dim=0).values / z["cpu"].abs().max(dim=0).values).numpy()
    print(f"lda, card against cpu up to sign, per direction relative to its largest |value|: best direction "
          f"{err[0]:.3e} (tol {LDA_TOP_RTOL}), directions 1-8 max {err[:8].max():.3e}, median {np.median(err):.3e}, "
          f"max {err.max():.3e}")
    if not (torch.isfinite(z[device]).all() and err[0] <= LDA_TOP_RTOL):
        raise AssertionError(f"lda: the best direction differs by {err[0]} between card and cpu")


def descriptors_full(torch, np, images, device) -> None:
    from keystone_tpu_torch.nodes.images.daisy import DaisyExtractor
    from keystone_tpu_torch.nodes.images.hog import HogExtractor

    n = len(images)
    for node in (HogExtractor(cell_size=8, num_bins=9), DaisyExtractor()):
        name = type(node).__name__
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        device_ms_sum, dims = 0.0, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for i in range(0, n, DESCRIPTOR_BATCH):
                X = torch.from_numpy(images[i:i + DESCRIPTOR_BATCH]).to(device)
                start.record()
                out = node(X)
                end.record()
                end.synchronize()
                device_ms_sum += start.elapsed_time(end)
                dims = tuple(out.shape[1:])
        secs = time.perf_counter() - t0
        batches = -(-n // DESCRIPTOR_BATCH)
        cpu_in = torch.from_numpy(images[:DESCRIPTOR_CPU_IMAGES])
        with torch.inference_mode():
            err = float((node(cpu_in.to(device)).cpu() - node(cpu_in)).abs().max())
        print(f"{name}: {n} images of {images.shape[1:]} in {secs:.3f} s = {n / secs:.1f} images/s (host clock, "
              f"copies included); device {device_ms_sum / batches:.3f} ms a batch of {DESCRIPTOR_BATCH} (CUDA "
              f"events); output {dims} an image; card against cpu on {DESCRIPTOR_CPU_IMAGES} images: max abs "
              f"{err:.3e} (tol {DESCRIPTOR_ATOL})")
        if not err <= DESCRIPTOR_ATOL:
            raise AssertionError(f"{name} on the card disagrees with the cpu: {err}")


def auto_decode(np, paths) -> None:
    """``KEYSTONE_JPEG_BACKEND=auto`` on the real-data phase's JPEGs: the
    decode pool where it is built, else PIL. No batch may go to the other
    route, nor be handed to PIL after a native failure."""
    import os

    from keystone_tpu_torch import native
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.utils.metrics import ingest_counters

    label_map = ImageNetLoader.load_label_map(paths["label_map_path"])
    before = ingest_counters.snapshot()
    with patch.dict(os.environ, {"KEYSTONE_JPEG_BACKEND": "auto"}):
        t0 = time.perf_counter()
        ImageNetLoader.load(paths["data_path"], label_map, limit=DECODE_IMAGES)
        secs = time.perf_counter() - t0
    after = ingest_counters.snapshot()
    nat, pil, handed = ((after.get(k, 0) - before.get(k, 0))
                        for k in ("native_batches", "pil_batches", "pil_fallback_batches"))
    built = native.jpeg_available()
    why = "" if built else f" ({native.build_error() or 'jpeg_probe.cpp does not link with -ljpeg'})"
    cores = os.cpu_count() or 1
    print(f"decode, auto: {DECODE_IMAGES} JPEGs of {REAL_W}x{REAL_H} in {secs:.3f} s = {DECODE_IMAGES / secs:.1f} "
          f"images/s, {DECODE_IMAGES / secs / cores:.1f} per host core ({cores} cores); decode pool built: "
          f"{built}{why}; {nat} native and {pil} PIL batches, {handed} handed to PIL after a native failure")
    used, other = (nat, pil) if built else (pil, nat)
    if used < 1 or other != 0 or handed != 0:
        raise AssertionError(f"auto decode: {nat} native, {pil} PIL, {handed} handed over (pool built: {built})")


def native_host(torch, np, fvo, voc_xla, device) -> dict:
    """Native SIFT, GMM EM and Fisher vectors against the device's, then
    VOCSIFTFisher end to end with native SIFT. Returns that run's launches
    and the kernel's largest difference from its plain version here."""
    from concurrent.futures import ThreadPoolExecutor

    from keystone_tpu_torch import native
    from keystone_tpu_torch.loaders.voc import VOCLoader
    from keystone_tpu_torch.nodes.images.external.fisher_vector import GMMFisherVectorEstimator
    from keystone_tpu_torch.nodes.learning.pca import PCAEstimator
    from keystone_tpu_torch.nodes.stats.samplers import sample_rows
    from keystone_tpu_torch.ops.sift import dense_sift
    from keystone_tpu_torch.pipelines.images import voc_sift_fisher as voc
    from keystone_tpu_torch.utils.image import grayscale

    with ThreadPoolExecutor(2) as pool:
        train, test = pool.map(
            lambda seed_n: VOCLoader.synthetic(n=seed_n[1], num_classes=VOC_CLASSES, size=VOC_SIZE,
                                               seed=seed_n[0])[0],
            ((0, VOC_COUNTS[0]), (1, VOC_COUNTS[1])))
    gray = grayscale(torch.from_numpy(train.data))[..., 0].numpy()
    t0 = time.perf_counter()
    host = native.dense_sift(gray)
    native_s = time.perf_counter() - t0
    with torch.inference_mode():
        dense_sift(torch.from_numpy(gray[:64]).to(device))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = torch.cat([dense_sift(torch.from_numpy(gray[i:i + 64]).to(device)) for i in range(0, len(gray), 64)])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    err = float((on_card.cpu() - torch.from_numpy(host)).abs().max())
    print(f"native sift: {len(gray)} VOC images of {VOC_SIZE}x{VOC_SIZE}, {host.shape[1]} descriptors each, "
          f"{len(gray) / native_s:.1f} images/s on the host ({native_s:.3f} s) against {len(gray) / card_s:.1f} "
          f"images/s on the card ({card_s:.3f} s, host copies included, batches of 64); max abs difference "
          f"{err:.3e} (tol {NATIVE_SIFT_TOL})")
    if not err <= NATIVE_SIFT_TOL:
        raise AssertionError(f"native sift against the device's: {err}")

    flat = sample_rows(host.reshape(-1, host.shape[-1]), VOC_GMM_SAMPLE, seed=0)
    pca = PCAEstimator(dims=64, device=device).fit(flat)
    with torch.inference_mode():
        sample = pca(torch.from_numpy(flat).to(device))
    gmms, secs = {}, {}
    for backend in ("native", "tpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gmms[backend] = GMMFisherVectorEstimator(k=VOC_K, em_iters=20, sample_size=VOC_GMM_SAMPLE, seed=0,
                                                 device=device, gmm_backend=backend).fit(sample)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0

    def loglik(g):
        w, mu, var = (t.double() for t in (g.weights, g.means, g.variances))
        x = sample.double()
        quad = ((x[:, None, :] - mu) ** 2 / var).sum(-1)
        logp = torch.log(w) - 0.5 * (torch.log(var).sum(-1) + x.shape[1] * np.log(2 * np.pi)) - 0.5 * quad
        return float(torch.logsumexp(logp, dim=1).mean())

    lls = {b: loglik(g) for b, g in gmms.items()}
    mu_n, mu_t = gmms["native"].means.double(), gmms["tpu"].means.double()
    nearest = torch.cdist(mu_n, mu_t).min(dim=1).values.max()
    print(f"native gmm EM against the port's torch EM, k={VOC_K} on {len(sample)} PCA'd VOC descriptors of 64, 20 "
          f"iterations: native {secs['native']:.3f} s (host), torch {secs['tpu']:.3f} s (card, synced); mean "
          f"log-likelihood {lls['native']:.4f} against {lls['tpu']:.4f}; farthest native mean from its nearest torch "
          f"mean {float(nearest):.4f} (mean norm {float(mu_t.norm(dim=1).mean()):.4f})")
    if not all(np.isfinite(list(lls.values()))):
        raise AssertionError("a fitted mixture's likelihood is not finite")

    g = gmms["native"]
    with torch.inference_mode():
        descs = pca(on_card[:64]).contiguous()
        ops = fvo.fv_operands(g.weights, g.means, g.variances)
        got = fvo.fisher_vectors(descs, ops).cpu()
        plain = fvo.fisher_vectors_plain(descs, g.weights, g.means, g.variances).cpu()
        exact = fvo.fisher_vectors_plain(descs.double(), *(t.double() for t in (g.weights, g.means, g.variances)))
    host_desc = descs.cpu().numpy()
    w, mu, var = (t.cpu().numpy() for t in (g.weights, g.means, g.variances))
    t0 = time.perf_counter()
    host_fv = torch.from_numpy(np.stack([native.fisher_vector(x, w, mu, var) for x in host_desc]))
    fv_s = time.perf_counter() - t0

    def outside(a, b):
        return int(((a - b).abs() > NATIVE_FV_ATOL + NATIVE_FV_RTOL * b.abs()).sum())

    exact = exact.cpu()
    print(f"native fisher vectors against the cuda kernel at VOC's shape (B=64, m={host.shape[1]}, d=64, "
          f"k={VOC_K}), GMM by the native EM (smallest variance {float(var.min()):.3e}, "
          f"{int((var <= 1e-4 * (1 + 1e-6)).sum())} of {var.size} at the floor): max abs difference "
          f"{float((got - host_fv).abs().max()):.3e}, {outside(got, host_fv)} of {got.numel()} entries outside "
          f"rtol {NATIVE_FV_RTOL}, atol {NATIVE_FV_ATOL}; native {fv_s * 1e3:.2f} ms on the host. Against the "
          f"float64 plain version: native {float((host_fv - exact).abs().max()):.3e}, kernel "
          f"{float((got - exact).abs().max()):.3e}, float32 plain {float((plain - exact).abs().max()):.3e}")
    if outside(got, host_fv):
        raise AssertionError("native fisher vectors disagree with the kernel")
    fv_err = held_against_plain(torch, got, plain, "at VOC's shape on the native EM's mixture")

    conf = voc.VOCSIFTFisherConfig(synthetic_classes=VOC_CLASSES, sift_backend="native")
    reset_peak(torch, device)
    fvo.LAUNCHES = 0  # the native-SIFT VOC path starts here
    t0 = time.perf_counter()
    scored = voc.fit(conf, train, device)
    test_scores = voc.scores(scored, test.data, device)
    launches = fvo.LAUNCHES  # and ends here
    out = voc.evaluate(test_scores, test.labels, VOC_CLASSES, time.perf_counter() - t0)
    print(f"voc_sift_fisher, native sift: {out['summary']} in {out['seconds']:.3f} s (host clock) against the xla "
          f"run's mAP {voc_xla['map']:.4f} in {voc_xla['seconds']:.3f} s; {launches} fv launches; peak device memory "
          f"{peak_gib(torch, device):.3f} GiB")
    want = sum(-(-n // 64) for n in VOC_COUNTS)
    if launches != want or not out["map"] >= VOC_MAP_MIN:
        raise AssertionError(f"native-sift VOC: {launches} launches (want {want}), mAP {out['map']}")
    return launches, fv_err


def learning_suite(torch, np, fvo, images, jpeg_paths, streamed, voc_xla, device="cuda") -> dict:
    """The phase "learning suite, descriptors, native". Returns the
    Fisher-vector launches of each of its paths and the kernel's largest
    difference from its plain version in the phase."""
    from keystone_tpu_torch import build, native
    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader

    t_phase = time.perf_counter()
    launches = {}
    fvo.LAUNCHES = 0  # the learning nodes' and descriptors' paths start here
    train, test = TimitFeaturesDataLoader.synthetic(n=TIMIT_COUNTS[0], num_phones=TimitFeaturesDataLoader.NUM_PHONES)
    kernel_ridge_full(torch, np, train, test, device)
    least_squares_full(torch, np, streamed, device)
    lda_full(torch, np, train, device)
    del train, test
    descriptors_full(torch, np, images, device)
    launches["learning nodes and descriptors"] = fvo.LAUNCHES  # and end here

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native library did not build: {native.build_error()}")
    print(f"native library: built in {build.NATIVE_BUILD['seconds']:.3f} s (host, {time.perf_counter() - t0:.3f} s "
          f"with the probe and loading), decode pool built: {native.jpeg_available()}")
    auto_decode(np, jpeg_paths)
    launches["voc, native sift"], fv_err = native_host(torch, np, fvo, voc_xla, device)
    print(f"learning suite, descriptors, native: {time.perf_counter() - t_phase:.3f} s")
    return launches, fv_err


def main() -> int:
    # CUPTI stays attached between profiles, so that a graph captured after
    # one is traced kernel by kernel in the next (torch's profiler does the
    # same for the CUDA graphs it knows of).
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from keystone_tpu_torch import build
    import keystone_tpu_torch.ops.fisher_vector as fvo

    phase("device")
    print(gpu_name_and_limit())  # name, power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase("build")
    seconds = build.build()
    for name, s in seconds.items():
        print(f"built {name}.cu in {s:.3f} s")
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    blocks = fvo.resident_blocks(FULL["d"])
    print(f"fisher_vector kernel at d={FULL['d']}: {blocks} block(s) resident per SM")
    if blocks < 1:
        raise AssertionError("the fisher_vector kernel's block does not fit on an SM")

    phase("kernel vs plain")
    d, k = FULL["d"], FULL["k"]
    max_err = max(
        check_fv(torch, fvo, FULL["B"], FULL["m"], d, k, seed=1),
        check_fv(torch, fvo, 1, FULL["m"], d, k, seed=2),
        check_fv(torch, fvo, 3, 1000, d, k, seed=3),
        check_fv(torch, fvo, 2, 37, d, k, seed=4),
        # Variances near the 1e-4 floor, as a fitted GMM reaches, with the
        # means a few standard deviations apart.
        check_fv(torch, fvo, 3, FULL["m"], d, k, seed=6, var_range=(1e-4, 1e-3), mu_scale=0.05),
        # Variances at the floor and means of scale 0.5, fifty standard
        # deviations from 0: where sums of r·x² lose the result in float32.
        check_fv(torch, fvo, 2, FULL["m"], d, k, seed=8, var_range=(1e-4, 1e-4), mu_scale=0.5),
        check_fitted_floor(torch, fvo),
    )
    check_repeat(torch, fvo)
    timings = {B: time_fv(torch, fvo, B, FULL["m"], d, k) for B in BUCKETS}
    # The streamed paths' shapes: training batches of 256 images, and TTA
    # sub-batches of 25 images' 10 views of 224x224 (m = 53² = 2,809).
    streamed_shapes = {(256, FULL["m"]): None, (250, TTA_M): None}
    for B, m in streamed_shapes:
        streamed_shapes[B, m] = time_fv(torch, fvo, B, m, d, k)
    max_err = max(max_err, *(t["max_abs_err"] for t in [*timings.values(), *streamed_shapes.values()]))
    timing = timings[BUCKETS[-1]]

    phase("serve")
    served = serve(torch)

    phase("fit, reduced: card against cpu")
    fit_reduced(torch)

    phase("fit, full width")
    import numpy as np

    t0 = time.perf_counter()
    train, test = full_width_data(np)
    print(f"data: {len(train.data)} training and {len(test.data)} test images of "
          f"{train.data.shape[1:]} over 1000 classes, made in {time.perf_counter() - t0:.3f} s (host)")
    fitted = fit_full(torch, train, test)
    fitted["train"] = train

    phase("workflow")
    print(gpu_name_and_limit())
    workflow_launches = workflow(torch, np, fvo, fitted, test)

    phase("serve, precision ladder")
    serve_precisions(torch, fitted, test)

    phase("fit, streamed")
    streamed = fit_streamed(torch, train, test, fitted)

    phase("solver modes")
    solver_modes(torch, fitted, streamed, test)
    images = train.data  # kept for the descriptors of the last phase
    del train

    jpeg_root = tempfile.TemporaryDirectory(prefix="keystone-smoke-jpeg-")
    try:
        phase("fit, real data")
        real_launches, jpeg_paths = fit_real(torch, fitted, jpeg_root.name)

        phase("other pipelines")
        voc = other_pipelines(torch, fvo)
        # The kernel at VOCSIFTFisher's shape: 841 descriptors of a 128x128
        # image, d = 64, k = 16, in the fit's and scorer's batches of 64 and
        # for one image. The kernel pads components to 256, so it does the
        # logits product of k = 256; the bound is that of k = 16.
        voc_shape = {B: time_fv(torch, fvo, B, VOC_M, d, VOC_K) for B in (64, 1)}
        for B, t in voc_shape.items():
            padded = 3 * 4.0 * B * VOC_M * k * d / TF32_PEAK_FLOPS * 1e3
            print(f"fv kernel at VOC's shape, B={B}: {t['ms']:.4f} ms on the device; bound at k={VOC_K} "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), 3xTF32 bound of the padded k={k} work {padded:.4f} ms")
        max_err = max(max_err, *(t["max_abs_err"] for t in voc_shape.values()))

        phase("speech and text pipelines")
        speech_text_launches = speech_and_text(torch, fvo)

        phase("learning suite, descriptors, native")
        print(gpu_name_and_limit())
        suite_launches, suite_err = learning_suite(torch, np, fvo, images, jpeg_paths, streamed, voc)
        max_err = max(max_err, suite_err)
    finally:
        jpeg_root.cleanup()

    phase("kernels")
    kernels = [{
        "name": "fisher_vector",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fisher_vector.cu",
        "replaces": "keystone_tpu/ops/fisher_vector_pallas.py:108",
        "launches": (served["launches"] + served["service_launches"] + fitted["launches"]
                     + fitted["served_launches"] + workflow_launches + sum(streamed["launches"].values())
                     + real_launches
                     + voc["launches"] + sum(suite_launches.values())),
        "launches_by_path": {
            "serve, graphs": served["launches"],
            "service": served["service_launches"],
            "fit": fitted["launches"],
            "serve fitted": fitted["served_launches"],
            "workflow": workflow_launches,
            **streamed["launches"],
            "fit streamed, real data": real_launches,
            "voc": voc["launches"],
            # No TPU kernel lies on these paths: the kernel must not run there.
            "speech and text pipelines": speech_text_launches,
            **suite_launches,
        },
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "call_ms": timing["call_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "batch": BUCKETS[-1],
        "ms_by_batch": {str(B): t["ms"] for B, t in timings.items()},
        "bound_ms_by_batch": {str(B): t["bound_ms"] for B, t in timings.items()},
        "f32_bound_ms": timing["f32_bound_ms"],
        "ms_streamed_shapes": {f"B={B} m={m}": t["ms"] for (B, m), t in streamed_shapes.items()},
        "bound_ms_streamed_shapes": {f"B={B} m={m}": t["bound_ms"] for (B, m), t in streamed_shapes.items()},
        "ms_voc_shape": {f"B={B} m={VOC_M} k={VOC_K}": t["ms"] for B, t in voc_shape.items()},
        "plain_ms_voc_shape": {f"B={B} m={VOC_M} k={VOC_K}": t["plain_ms"] for B, t in voc_shape.items()},
        "bound_ms_voc_shape": {f"B={B} m={VOC_M} k={VOC_K}": t["bound_ms"] for B, t in voc_shape.items()},
    }]
    by_path = dict(kernels[0]["launches_by_path"])
    for path in ("speech and text pipelines", "learning nodes and descriptors"):
        if by_path.pop(path) != 0:
            raise AssertionError(f"fisher_vector was launched on the {path}")
    if min(by_path.values()) < 1:
        raise AssertionError("fisher_vector was not launched on every image path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
