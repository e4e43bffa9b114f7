"""Fisher-vector encoding: the Hopper kernel's wrapper and its plain version.

Counterpart of ``keystone_tpu/ops/fisher_vector_pallas.py`` (the Pallas TPU
kernel) and of ``nodes/images/external/fisher_vector.py::_fv_tpu`` (its XLA
twin). ``fisher_vectors`` takes (B, m, d) descriptor sets to (B, 2·k·d) raw
Fisher vectors laid out ``[gmu | gvar]``, each k-major:

- on a CUDA tensor it launches ``csrc/fisher_vector.cu`` or raises;
- on a CPU tensor it runs ``fisher_vectors_plain``, the plain PyTorch
  version, which the CPU tests hold against the JAX package.

``LAUNCHES`` counts the kernel's launches (one per call on a CUDA tensor),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from keystone_tpu_torch import build
from keystone_tpu_torch.ops.fv_common import fv_constants

LAUNCHES = 0

# A split covers at least this many tiles, so that a block's constant load
# (128 KB at d=64, k=256) and partial write are spread over enough rows; a
# block's fixed cost is priced at this many tiles' work.
_MIN_SPLIT_TILES = 2
_BLOCK_OVERHEAD_TILES = 1


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


def fisher_vectors_plain(X, weights, means, variances) -> torch.Tensor:
    """(B, m, d) → (B, 2·k·d): the plain PyTorch version of ``_fv_tpu``."""
    B, m, d = X.shape
    w, inv, logw_norm, cm, cv = fv_constants(weights, means, variances, m)
    mu = means
    quad = (
        torch.einsum("bmd,kd->bmk", X * X, inv)
        - 2.0 * torch.einsum("bmd,kd->bmk", X, mu * inv)
        + (mu * mu * inv).sum(dim=1)
    )
    log_r = logw_norm - 0.5 * quad  # (B, m, k)
    r = torch.softmax(log_r, dim=-1)
    sigma = torch.sqrt(variances)
    rx = torch.einsum("bmk,bmd->bkd", r, X)
    rsum = r.sum(dim=1)  # (B, k)
    gmu = (rx - rsum[..., None] * mu) / sigma
    rx2 = torch.einsum("bmk,bmd->bkd", r, X * X)
    gvar = (rx2 - 2.0 * mu * rx + rsum[..., None] * (mu * mu)) * inv - rsum[..., None]
    return torch.cat(
        [(gmu * cm).reshape(B, -1), (gvar * cv).reshape(B, -1)], dim=-1
    ).to(torch.float32)


def fisher_vectors(X: torch.Tensor, ops: FVOperands) -> torch.Tensor:
    """(B, m, d) descriptor sets → (B, 2·k·d) raw Fisher vectors."""
    if X.device.type == "cpu":
        return fisher_vectors_plain(X, ops.weights, ops.means, ops.variances)
    if X.device.type != "cuda":
        raise ValueError(f"fisher_vectors runs on cpu or cuda tensors, got {X.device}")
    return _fisher_vectors_cuda(X, ops)


def _library() -> ctypes.CDLL:
    lib = build.library("fisher_vector")
    if lib.keystone_fv_encode.argtypes is None:
        lib.keystone_fv_encode.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.keystone_fv_encode.restype = ctypes.c_int
        for fn in (lib.keystone_fv_tile_rows, lib.keystone_fv_max_components):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.keystone_fv_resident_blocks.argtypes = [ctypes.c_int]
        lib.keystone_fv_resident_blocks.restype = ctypes.c_int
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
    LAUNCHES += 1
    return out

