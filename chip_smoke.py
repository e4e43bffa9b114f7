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
   card at full width (B=4, m=3721, d=64, k=256), at B=1, at ragged m and
   with variances near the 1e-4 floor, checks that two launches give the
   same bits, and at every serving bucket a request of 1, 3, 16 or 64
   images reaches (B = 1, 4, 16, 64) holds it against the plain version
   again and times both;
4. serves 256×256 synthetic images through the 65,536-feature
   ImageNetSiftLcsFV pipeline with 1,000 classes and seeded random
   parameters (``CompiledPipeline(max_batch=64)``, requests of 1, 3, 16 and
   64 images), counting kernel launches on that path, and checks the
   scores against the same pipeline with the plain Fisher-vector version on
   the card and against the port on the CPU;
5. one JSON line with every kernel's launches, error and times: ``ms`` is
   the kernel's device time per call at B=64 (``torch.profiler``),
   ``call_ms`` the same call between CUDA events, host included.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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

FULL = dict(B=4, m=3721, d=64, k=256)
REQUESTS = (1, 3, 16, 64)
BUCKETS = (1, 4, 16, 64)  # the serving buckets those requests reach
REPEATS = 5  # calls of each request size


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
    flops = 8.0 * B * m * k * d  # two logit products + rᵀx and rᵀx²
    nbytes = 4.0 * (B * m * d + k + 2 * k * d + B * 2 * k * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = flops / F32_PEAK_FLOPS * 1e3
    t_3xtf32 = 3 * flops / TF32_PEAK_FLOPS * 1e3  # the arithmetic the kernel does
    bound_ms = max(t_3xtf32, t_bytes)
    print(
        f"fv timing B={B} m={m}: kernel {ms:.4f} ms on the device (call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms; bounds: 3xTF32 {t_3xtf32:.4f} ms, float32 CUDA cores "
        f"{t_f32:.4f} ms, bytes {t_bytes:.4f} ms; share of the 3xTF32 bound {bound_ms / ms:.3f}; "
        f"{flops / ms / 1e9:.3f} TFLOP/s of the float32 work"
    )
    return {
        "max_abs_err": max_abs,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_3xtf32 >= t_bytes else "bytes",
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


def profile_requests(engine, images, torch, calls: int = 3) -> None:
    """Device busy and idle share of ``calls`` back-to-back requests from a
    ``torch.profiler`` trace: the union of the device intervals of every
    kernel and copy, over the host wall time of the window, and the device
    time of the costliest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = images.shape[0]
    engine(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine(images)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        print(f"profile of {calls} requests of {n} images: device time not measured "
              "(the trace holds no device activity)")
        return
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
    print(
        f"profile of {calls} requests of {n} images: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}; costliest on the device: "
        + "; ".join(f"{name[:70]} {us / 1e3 / calls:.4f} ms/request" for name, us in top)
    )


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
    from keystone_tpu_torch.workflow import Pipeline
    from keystone_tpu_torch.workflow.serving import CompiledPipeline

    conf = ImageNetSiftLcsFVConfig(gmm_k=256, pca_dims=64, top_k=5)
    classes = 1000
    t0 = time.perf_counter()
    raw = seeded_params(seed=0, gmm_k=256, pca_dims=64, num_classes=classes, device="cuda", conf=conf)
    params = params_from_numpy(raw, "cuda")
    pipe = build_serving_pipeline(params, conf)
    if params.head.W.shape != (conf.feature_dim, classes) or conf.feature_dim != 65536:
        raise AssertionError(f"head {tuple(params.head.W.shape)}, want (65536, {classes})")
    engine = CompiledPipeline(pipe, max_batch=64, device="cuda")
    print(f"params and pipeline: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    engine.warmup((256, 256, 3))
    print(f"warmup of buckets {list(engine.ladder)}: {time.perf_counter() - t0:.3f} s")

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
        print(
            f"request of {n} images: median {statistics.median(wall[n]):.3f} ms, "
            f"min {min(wall[n]):.3f} ms over {REPEATS}, fv launches 2 per call"
        )
    launches = fvo.LAUNCHES  # the main path's run ends here
    print(f"fv launches on the main path: {launches}; calls by bucket {dict(engine.calls_by_bucket)}")
    print(f"peak device memory while serving: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # Where the time goes: device time of each stage at the bucket of the
    # smallest and the largest request, beside the request's wall time.
    for n in (REQUESTS[0], REQUESTS[-1]):
        rows = stage_ms(pipe, outs[n][0], torch)
        device = sum(ms for _, ms in rows)
        median = statistics.median(wall[n])
        print(
            f"stages of a {n}-image request (device ms): "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in rows)
            + f"; sum {device:.4f} of median wall {median:.4f} ms "
            f"(device idle share about {1 - device / median:.3f})"
        )
        profile_requests(engine, outs[n][0], torch)

    # Scores of one request: kernel on the card vs the plain version on the
    # card, and vs the port on the CPU for its first image.
    X3 = torch.from_numpy(outs[3][0]).cuda()
    scorer = Pipeline(list(pipe.stages)[:-1]).eval()
    with torch.inference_mode():
        s_kernel = scorer(X3)
        if not torch.isfinite(s_kernel).all() or s_kernel.shape != (3, classes):
            raise AssertionError("scores not finite or of the wrong shape")
        scale = float(s_kernel.abs().max())
        cpu_params = params_from_numpy({k: v.cpu() if torch.is_tensor(v) else v for k, v in raw.items()}, "cpu")
        cpu_scorer = Pipeline(list(build_serving_pipeline(cpu_params, conf).stages)[:-1]).eval()
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
    return {"launches": launches}


def main() -> int:
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
    )
    check_repeat(torch, fvo)
    timings = {B: time_fv(torch, fvo, B, FULL["m"], d, k) for B in BUCKETS}
    max_err = max(max_err, *(t["max_abs_err"] for t in timings.values()))
    timing = timings[BUCKETS[-1]]

    phase("serve")
    served = serve(torch)

    phase("kernels")
    kernels = [{
        "name": "fisher_vector",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fisher_vector.cu",
        "replaces": "keystone_tpu/ops/fisher_vector_pallas.py:108",
        "launches": served["launches"],
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
    }]
    if served["launches"] < 1:
        raise AssertionError("fisher_vector was not launched on the main path")
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
