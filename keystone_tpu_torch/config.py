"""Numeric defaults, the solver's modes and device resolution for the port.

Precision follows the JAX reference on the CPU, which is float32 throughout.
On the card both of PyTorch's TF32 switches matter:

- ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default),
  set again by ``resolve_device`` whenever it hands out a CUDA device; the
  solver turns it on around its own products only, and only at the
  ``high`` and ``default`` precisions (``linalg/row_matrix.py``);
- ``torch.backends.cudnn.allow_tf32`` defaults to True, so every
  convolution of the port sets it around its own call (``cudnn_tf32``):
  off for the SIFT convolutions (``ops/sift.py``), where the JAX code asks
  for ``Precision.HIGHEST`` on purpose, and for the ``Convolver`` in
  float32; on for the ``Convolver``'s bfloat16 mode
  (``nodes/images/convolver.py``).

The solver's modes are the reference's ``config.solver_precision`` and
``config.solver_storage_dtype`` (``keystone_tpu/config.py:95-126``). Here
they are arguments of a solve; ``solver_precision`` and
``solver_storage_dtype`` resolve an argument left at None from the
reference's environment variables, with its choices, and refuse a value
outside them.

The serving knobs are the reference's (``keystone_tpu/config.py:245-300``,
``:333``, ``:400-415``), fields of ``config`` read from the same
``KEYSTONE_SERVE_*`` variables with the same defaults when the module is
imported: the bucket ladder, its top, the serving precision, the replica
pool's width, the in-flight window, the pending-queue bound, the default
deadline and the planner switch. ``text_sparse_threshold`` is the
reference's (``:357``), a plain field; ``kernel_block_bytes`` is the port's
own (the reference's kernel rows come a device's row shard at a time). The
workflow knobs are the reference's (``:303-361``, ``:417``):
``exec_workers`` (``KEYSTONE_EXEC_WORKERS``, the parallel walk's pool),
``auto_cache`` (the auto-cache rule), ``fingerprint_max_bytes``,
``cache_dir`` (the disk fit cache; ``KEYSTONE_CACHE_DIR`` wins, read live
by ``resolved_cache_dir``) and ``fuse_chains`` (``KEYSTONE_NO_FUSE``).
``resolved_serve_buckets`` reads
``KEYSTONE_SERVE_BUCKETS`` live, so an exported ladder pins the engine's
even when exported after import. The fault-injection knobs of
``utils/reliability.py`` live here too (the reference's ``:360-389``).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch

default_dtype = torch.float32

SOLVER_PRECISIONS = ("highest", "high", "default")
SERVE_PRECISIONS = ("f32", "f32h", "bf16")
SOLVER_STORAGE_DTYPES = ("float32", "bfloat16")

# The memory a solve may plan for (the reference's config.hbm_budget_bytes):
# it sizes the feature blocks, decides whether their inverses are cached and
# whether an estimator streams its features from the host. The serving
# planner budgets against it where the device reports no memory (the CPU).
HBM_BUDGET_BYTES = 12 * (1 << 30)


@contextmanager
def cudnn_tf32(enabled: bool):
    """Sets cuDNN's TF32 switch for the block and restores it after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _choice(name: str, value: Optional[str], choices: tuple, default: str) -> str:
    """``value``, or else the environment variable ``name`` (case and
    surrounding blanks ignored; unset or empty gives ``default``)."""
    if value is None:
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return default
        val = raw.strip().lower()
        if val not in choices:
            raise ValueError(f"{name}={raw!r}: expected one of {choices}")
        return val
    if value not in choices:
        raise ValueError(f"{value!r}: expected one of {choices}")
    return value


def solver_precision(precision: Optional[str] = None) -> str:
    """The precision of the solver's float32 products: ``highest`` (float32,
    TF32 off), ``high`` or ``default`` (TF32 on the card). None reads
    ``KEYSTONE_SOLVER_PRECISION``, ``highest`` when unset."""
    return _choice("KEYSTONE_SOLVER_PRECISION", precision, SOLVER_PRECISIONS, "highest")


def solver_storage_dtype(dtype: Optional[str] = None) -> str:
    """The dtype the solver stores its feature matrix A in: ``float32``, or
    ``bfloat16`` (half the bytes; every product that touches A multiplies
    bfloat16 operands into float32). None reads ``KEYSTONE_SOLVER_DTYPE``,
    ``float32`` when unset."""
    return _choice("KEYSTONE_SOLVER_DTYPE", dtype, SOLVER_STORAGE_DTYPES, "float32")


def _env_int(name: str, default: int) -> int:
    """An integer environment knob; a bad value raises naming the variable."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None


def _env_float(name: str, default: float) -> float:
    """A float environment knob; a bad value raises naming the variable."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number") from None


def pow2_ladder(max_batch: int) -> tuple:
    """Power-of-two bucket ladder up to (and always including) max_batch."""
    if max_batch <= 0:
        raise ValueError(f"max_batch must be positive, got {max_batch}")
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def _env_buckets() -> tuple:
    """``KEYSTONE_SERVE_BUCKETS``: unset or empty gives (), ``pow2`` the
    power-of-two ladder up to ``KEYSTONE_SERVE_MAX_BATCH``, else a
    comma-separated list of positive bucket sizes (sorted, deduplicated)."""
    raw = os.environ.get("KEYSTONE_SERVE_BUCKETS")
    if raw is None or not raw.strip():
        return ()
    if raw.strip().lower() == "pow2":
        return pow2_ladder(_env_int("KEYSTONE_SERVE_MAX_BATCH", 1024))
    try:
        vals = tuple(sorted({int(tok) for tok in raw.split(",") if tok.strip()}))
    except ValueError:
        raise ValueError(
            f"KEYSTONE_SERVE_BUCKETS={raw!r}: expected 'pow2' or comma-separated integers"
        ) from None
    if not vals or vals[0] <= 0:
        raise ValueError(f"KEYSTONE_SERVE_BUCKETS={raw!r}: buckets must be positive")
    return vals


def resolved_serve_buckets() -> Optional[tuple]:
    """The live value of ``KEYSTONE_SERVE_BUCKETS`` when it is exported and
    not empty, else None: an exported ladder pins the serving engine's."""
    if "KEYSTONE_SERVE_BUCKETS" in os.environ:
        return _env_buckets() or None
    return None


@dataclass
class Config:
    """The port's process-wide knobs, each read from its environment
    variable when the module is imported; code may set a field."""

    # The serving ladder; () lets the engine use pow2 up to serve_max_batch.
    serve_buckets: tuple = field(default_factory=_env_buckets)
    # Top of the default (power-of-two) serving ladder.
    serve_max_batch: int = field(default_factory=lambda: _env_int("KEYSTONE_SERVE_MAX_BATCH", 1024))
    # The precision every bucket is captured at: f32, f32h or bf16.
    serve_precision: str = field(
        default_factory=lambda: _choice("KEYSTONE_SERVE_PRECISION", None, SERVE_PRECISIONS, "f32")
    )
    # Replicas of the serving engine: 0 = every local CUDA device.
    serve_devices: int = field(default_factory=lambda: _env_int("KEYSTONE_SERVE_DEVICES", 0))
    # Launches a replica may have in flight before the dispatcher waits.
    serve_inflight: int = field(default_factory=lambda: _env_int("KEYSTONE_SERVE_INFLIGHT", 2))
    # Requests PipelineService holds pending before submit() fails fast.
    serve_max_pending: int = field(default_factory=lambda: _env_int("KEYSTONE_SERVE_MAX_PENDING", 1024))
    # Default per-request deadline in ms (0 = none).
    serve_deadline_ms: float = field(default_factory=lambda: _env_float("KEYSTONE_SERVE_DEADLINE_MS", 0.0))
    # Whether the engine sizes an unpinned ladder against device memory.
    plan_resources: bool = field(
        default_factory=lambda: os.environ.get("KEYSTONE_PLAN_RESOURCES", "").lower()
        not in ("0", "false", "no")
    )
    # Fault injection ('site:value,...') and its seed (utils/reliability.py).
    faults: str = field(default_factory=lambda: os.environ.get("KEYSTONE_FAULTS", ""))
    faults_seed: int = field(default_factory=lambda: _env_int("KEYSTONE_FAULTS_SEED", 0))
    # Vocabulary size at which the text vectorizers give a host CSR
    # ``SparseBatch`` in place of a dense (n, vocab) array (the reference's
    # config.text_sparse_threshold).
    text_sparse_threshold: int = 16384
    # Bytes of one kernel block in kernel ridge regression's operator: its
    # (K + λI)v takes K's rows in chunks of at most this many float32
    # bytes, so the n×n matrix is never formed (``kernel_ridge.py``).
    kernel_block_bytes: int = 1 << 30
    # Worker threads of the executor's parallel walk (workflow/executor.py
    # _ParallelWalk); 0 = the serial walk. Outputs are bit-equal at any
    # count. Env: KEYSTONE_EXEC_WORKERS, read live by resolved_exec_workers.
    exec_workers: int = field(default_factory=lambda: _env_int("KEYSTONE_EXEC_WORKERS", 0))
    # Whether the optimizer's auto-cache rule profiles a sample run and
    # inserts cache nodes (workflow/rules.py AutoCacheRule).
    auto_cache: bool = False
    # Arrays and tensors above this size are fingerprinted from a sample
    # of chunks, not in full (workflow/fingerprint.py).
    fingerprint_max_bytes: int = 128 << 20
    # Directory of the cross-process fitted-prefix store (None = off);
    # KEYSTONE_CACHE_DIR, when exported, wins (resolved_cache_dir).
    cache_dir: Optional[str] = None
    # Whether the optimizer fuses chains of device transformers into one
    # module (workflow/optimizer.py ChainFusionRule). KEYSTONE_NO_FUSE set
    # to anything but "", "0", "false" or "no" turns it off.
    fuse_chains: bool = field(
        default_factory=lambda: os.environ.get("KEYSTONE_NO_FUSE", "").strip().lower()
        in ("", "0", "false", "no")
    )


config = Config()


def resolved_cache_dir() -> Optional[str]:
    """The disk fit cache's directory: ``KEYSTONE_CACHE_DIR`` when it is
    exported (an empty value turns the store off), else
    ``config.cache_dir``."""
    if "KEYSTONE_CACHE_DIR" in os.environ:
        return os.environ["KEYSTONE_CACHE_DIR"] or None
    return config.cache_dir


def resolved_exec_workers() -> int:
    """The parallel walk's worker count: ``KEYSTONE_EXEC_WORKERS`` when it
    is exported, read live, else ``config.exec_workers``."""
    if "KEYSTONE_EXEC_WORKERS" in os.environ:
        return _env_int("KEYSTONE_EXEC_WORKERS", 0)
    return config.exec_workers


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    absent — nothing falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def as_input(data, device=None) -> torch.Tensor:
    """``data`` as a float32 tensor for a fit: a tensor stays on its device;
    anything else (a host array) goes to ``resolve_device(device)``, so
    ``cuda`` unless the caller names another."""
    if isinstance(data, torch.Tensor):
        resolve_device(data.device)
        return data.to(default_dtype)
    return torch.as_tensor(data, dtype=default_dtype, device=resolve_device(device))
