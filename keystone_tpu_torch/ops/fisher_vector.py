"""Fisher-vector encoding: the Hopper kernel's wrapper and its plain version.

Counterpart of ``keystone_tpu/ops/fisher_vector_pallas.py`` (the Pallas TPU
kernel) and of ``nodes/images/external/fisher_vector.py::_fv_tpu`` (its XLA
twin). ``fisher_vectors`` takes (B, m, d) descriptor sets to (B, 2·k·d) raw
Fisher vectors laid out ``[gmu | gvar]``, each k-major. Both versions sum
the statistics in centred form, Σ r (x − μ) and Σ r (x − μ)², where the
reference expands them (see ``fisher_vectors_plain``); the plain version
forms the quadratic form of the logits from x − μ too, and the kernel
expands it on the tensor cores in 3xTF32:

- on a CUDA tensor it launches ``csrc/fisher_vector.cu`` or raises;
- on a CPU tensor it runs ``fisher_vectors_plain``, the plain PyTorch
  version, which the CPU tests hold against the JAX package.

``LAUNCHES`` counts the kernel's launches (one per call on a CUDA tensor),
so a run can show that its main path went through the kernel. Inside a
CUDA graph being captured, a call records the kernel into the graph and
launches nothing: it adds one to the capturing thread's
``captured_launches()`` instead of to ``LAUNCHES``. The serving engine
(``workflow/serving.py``) reads how many launches each captured graph
holds, and each replay of that graph adds them to ``LAUNCHES`` through
``count_replay``, so a replayed bucket counts its two launches (partial
sums and reduce of each branch's call) as an eager call does.

``counting_flops`` is how ``torch.utils.flop_counter.FlopCounterMode``
sees this op (the workflow profiler's FLOP count): inside it, a call adds
``fisher_vector_flops`` to the scope's count and runs with the dispatch
modes off, so the count is the same formula on both devices, whether the
kernel (which the counter cannot see) or the plain version (whose own
products it would count) does the work.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from contextlib import contextmanager
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from keystone_tpu_torch import build
from keystone_tpu_torch.ops.fv_common import fv_constants

LAUNCHES = 0
_captured = threading.local()
_count_lock = threading.Lock()

# A split covers at least this many tiles, so that a block's constant load
# (128 KB at d=64, k=256) and partial write are spread over enough rows; a
# block's fixed cost is priced at this many tiles' work.
_MIN_SPLIT_TILES = 2
_BLOCK_OVERHEAD_TILES = 1
# Differences x − μ the plain version holds at once: 256 MiB of float32.
_CENTRED_CHUNK = 1 << 26


class FVOperands(NamedTuple):
    """A fitted GMM and the per-component constants the kernel reads,
    computed once per model (``fv_operands``). All float32, one device."""

    weights: torch.Tensor  # (k,) as fitted
    means: torch.Tensor  # (k, d)
    variances: torch.Tensor  # (k, d)
    w_floor: torch.Tensor  # (k,) weights clamped at WEIGHT_FLOOR
    inv: torch.Tensor  # (k, d) 1/var
    sigma: torch.Tensor  # (k, d) sqrt(var)
    inv_t: torch.Tensor  # (d, k) 1/var, transposed
    m2_t: torch.Tensor  # (d, k) -2·mu/var, transposed
    bias: torch.Tensor  # (k,) log w + log-normaliser - 0.5·Σ mu²/var


def captured_launches() -> int:
    """Calls this thread has recorded into CUDA graphs under capture."""
    return getattr(_captured, "n", 0)


def count_replay(launches: int) -> None:
    """Adds the launches of one replay of a captured graph to ``LAUNCHES``."""
    global LAUNCHES
    with _count_lock:
        LAUNCHES += launches


def fv_operands(weights, means, variances) -> FVOperands:
    weights = weights.to(torch.float32).contiguous()
    means = means.to(torch.float32).contiguous()
    variances = variances.to(torch.float32).contiguous()
    # m only enters cm/cv, which the kernel computes itself from w_floor.
    w, inv, logw_norm, _cm, _cv = fv_constants(weights, means, variances, 1)
    c2 = (means * means * inv).sum(dim=1)
    return FVOperands(
        weights=weights,
        means=means,
        variances=variances,
        w_floor=w.contiguous(),
        inv=inv.contiguous(),
        sigma=torch.sqrt(variances).contiguous(),
        inv_t=inv.t().contiguous(),
        m2_t=(-2.0 * means * inv).t().contiguous(),
        bias=(logw_norm - 0.5 * c2).contiguous(),
    )


def _chunks(X, k: int):
    """Component ranges whose differences X − μ (B, m, c, d) hold at most
    ``_CENTRED_CHUNK`` elements."""
    B, m, d = X.shape
    step = max(1, _CENTRED_CHUNK // max(1, B * m * d))
    return [(s, min(k, s + step)) for s in range(0, k, step)]


def centred_quad(X, mu, inv):
    """Σ_f (x_if − μ_jf)² / var_jf, (B, m, k), from the differences."""
    parts = []
    for s, e in _chunks(X, mu.shape[0]):
        diff = X[:, :, None, :] - mu[s:e]  # (B, m, c, d)
        parts.append((diff * diff * inv[s:e]).sum(dim=-1))
    return torch.cat(parts, dim=-1)


def centred_statistics(r, X, mu):
    """g1 = Σ_i r (x_i − μ_j) and c2 = Σ_i r (x_i − μ_j)², each (B, k, d),
    from r (B, m, k), X (B, m, d) and μ (k, d). The differences are formed
    before any sum, as the kernel forms them."""
    g1, c2 = [], []
    for s, e in _chunks(X, mu.shape[0]):
        diff = X[:, :, None, :] - mu[s:e]  # (B, m, c, d)
        rd = r[..., s:e, None] * diff
        g1.append(rd.sum(dim=1))
        c2.append((rd * diff).sum(dim=1))
    return torch.cat(g1, dim=1), torch.cat(c2, dim=1)


def fisher_vectors_plain(X, weights, means, variances) -> torch.Tensor:
    """(B, m, d) → (B, 2·k·d): the plain PyTorch version of the kernel, the
    function ``_fv_tpu`` computes. It sums the quadratic form and the
    statistics from the differences x − μ, where ``_fv_tpu`` expands them
    (x²/σ² − 2xμ/σ² + μ²/σ², and rᵀx² − 2μ rᵀx + rs μ²). In float32 the
    expanded forms lose the result once variances sit at the 1e-4 floor far
    from 0, as on a GMM fitted to real descriptors; elsewhere the two differ
    in rounding only."""
    B, m, d = X.shape
    w, inv, logw_norm, cm, cv = fv_constants(weights, means, variances, m)
    r = torch.softmax(logw_norm - 0.5 * centred_quad(X, means, inv), dim=-1)  # (B, m, k)
    g1, c2 = centred_statistics(r, X, means)
    rsum = r.sum(dim=1)  # (B, k)
    gmu = g1 / torch.sqrt(variances)
    gvar = c2 * inv - rsum[..., None]
    return torch.cat(
        [(gmu * cm).reshape(B, -1), (gvar * cv).reshape(B, -1)], dim=-1
    ).to(torch.float32)


_flop_scope = threading.local()


def fisher_vector_flops(B: int, m: int, d: int, k: int) -> int:
    """Floating-point operations of one call: the logits' product (2·B·m·k·d)
    and the centred statistics, five per term (5·B·m·k·d)."""
    return 7 * B * m * k * d


@contextmanager
def counting_flops():
    """Within the block, each call of ``fisher_vectors`` on this thread adds
    its ``fisher_vector_flops`` to the yielded one-item list and hides its
    own operations from any dispatch mode (a ``FlopCounterMode``)."""
    prior = getattr(_flop_scope, "acc", None)
    acc = [0]
    _flop_scope.acc = acc
    try:
        yield acc
    finally:
        _flop_scope.acc = prior


def fisher_vectors(X: torch.Tensor, ops: FVOperands) -> torch.Tensor:
    """(B, m, d) descriptor sets → (B, 2·k·d) raw Fisher vectors."""
    acc = getattr(_flop_scope, "acc", None)
    if acc is not None:
        B, m, d = X.shape
        acc[0] += fisher_vector_flops(B, m, d, ops.means.shape[0])
        with _disable_current_modes():
            return _fisher_vectors(X, ops)
    return _fisher_vectors(X, ops)


def _fisher_vectors(X: torch.Tensor, ops: FVOperands) -> torch.Tensor:
    if X.device.type == "cpu":
        return fisher_vectors_plain(X, ops.weights, ops.means, ops.variances)
    if X.device.type != "cuda":
        raise ValueError(f"fisher_vectors runs on cpu or cuda tensors, got {X.device}")
    return _fisher_vectors_cuda(X, ops)


_library_ready = False


def _library() -> ctypes.CDLL:
    global _library_ready
    lib = build.library("fisher_vector")
    if _library_ready:
        return lib
    with _count_lock:
        lib.keystone_fv_encode.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.keystone_fv_encode.restype = ctypes.c_int
        for fn in (lib.keystone_fv_tile_rows, lib.keystone_fv_max_components):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.keystone_fv_resident_blocks.argtypes = [ctypes.c_int]
        lib.keystone_fv_resident_blocks.restype = ctypes.c_int
        _library_ready = True
    return lib


def resident_blocks(d: int) -> int:
    """Blocks of the kernel that the runtime keeps resident on one SM of the
    current card at descriptor width ``d`` (-1 for a width it does not take)."""
    return _library().keystone_fv_resident_blocks(d)


# The plan is a host loop over every split length, run twice a request.
@functools.lru_cache(maxsize=None)
def split_plan(B: int, m: int, tile_rows: int, sm_count: int):
    """(S, rows_per_split): cut each image's m rows into S splits of whole
    tiles, each at least ``_MIN_SPLIT_TILES`` tiles long (unless the image
    is shorter), choosing the split length whose B·S blocks (one resident
    per SM) finish soonest: waves × (tiles per split + the
    ``_BLOCK_OVERHEAD_TILES`` a block spends on its constants and partials),
    the longest such split on a tie, so that fewer partials are written."""
    tiles = -(-m // tile_rows)
    best = None
    for per in range(min(_MIN_SPLIT_TILES, tiles), tiles + 1):
        S = -(-tiles // per)
        cost = -(-B * S // sm_count) * (per + _BLOCK_OVERHEAD_TILES)
        if best is None or cost <= best[0]:
            best = (cost, S, per)
    _, S, per = best
    return S, per * tile_rows


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want float32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _fisher_vectors_cuda(X: torch.Tensor, ops: FVOperands) -> torch.Tensor:
    global LAUNCHES
    if X.ndim != 3:
        raise ValueError(f"X must be (B, m, d), got shape {tuple(X.shape)}")
    B, m, d = X.shape
    k = ops.weights.shape[0]
    lib = _library()
    if d not in (8, 16, 32, 64):
        raise ValueError(f"the kernel takes d in (8, 16, 32, 64), got {d}")
    if not 1 <= k <= lib.keystone_fv_max_components():
        raise ValueError(f"the kernel takes 1..{lib.keystone_fv_max_components()} components, got {k}")
    if B < 1 or m < 1:
        raise ValueError(f"empty descriptor batch {tuple(X.shape)}")
    dev = X.device
    _check("X", X, (B, m, d), dev)
    for name in ("inv_t", "m2_t"):
        _check(name, getattr(ops, name), (d, k), dev)
    for name in ("means", "sigma", "inv"):
        _check(name, getattr(ops, name), (k, d), dev)
    for name in ("bias", "w_floor"):
        _check(name, getattr(ops, name), (k,), dev)

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    S, rows_per_split = split_plan(B, m, lib.keystone_fv_tile_rows(), sm_count)
    part = torch.empty((B, S, 2, k, d), dtype=torch.float32, device=dev)
    part_rs = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    out = torch.empty((B, 2 * k * d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.keystone_fv_encode(
            X.data_ptr(), ops.inv_t.data_ptr(), ops.m2_t.data_ptr(),
            ops.bias.data_ptr(), ops.means.data_ptr(), ops.sigma.data_ptr(),
            ops.inv.data_ptr(), ops.w_floor.data_ptr(), part.data_ptr(),
            part_rs.data_ptr(), out.data_ptr(), B, m, d, k, S, rows_per_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fisher_vector kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        _captured.n = captured_launches() + 1
    else:
        with _count_lock:
            LAUNCHES += 1
    return out

