"""ctypes binding of the port's native host library (counterpart of
keystone_tpu/native/__init__.py).

The library is the port's own copy of the reference's C++ (``csrc/native/``:
dense SIFT, GMM EM, Fisher vectors, the libjpeg decode pool), built by
``build.native_library`` with ``g++`` into ``_build/`` at first use. The API
and the argtypes are the reference's, with its ABI-2 check: ``available``,
``jpeg_available``, ``build_error``, ``sift_num_keypoints``, ``dense_sift``,
``gmm_fit``, ``decode_jpeg_batch`` and ``fisher_vector``, on host numpy
arrays.

Where the reference swallows a failed build into ``available() == False``,
the port keeps that answer for ``auto`` choices only: every function here
raises when the library is unavailable, with the compiler's output in the
message, and so does every backend a caller names ``native`` explicitly.
A failed build is not retried in the same process.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from keystone_tpu_torch import build

ABI_VERSION = 2

_load_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_has_jpeg: bool = False


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _bind(path: str, has_jpeg: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ks_abi_version.restype = ctypes.c_int
    lib.ks_abi_version.argtypes = []
    if lib.ks_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native ABI {lib.ks_abi_version()} at {path}, expected {ABI_VERSION}")
    lib.ks_sift_num_keypoints.restype = ctypes.c_int
    lib.ks_sift_num_keypoints.argtypes = [ctypes.c_int] * 4
    lib.ks_dense_sift.restype = ctypes.c_int
    lib.ks_dense_sift.argtypes = [f32p] + [ctypes.c_int] * 5 + [f32p]
    lib.ks_gmm_fit.restype = ctypes.c_int
    lib.ks_gmm_fit.argtypes = [f32p] + [ctypes.c_int] * 4 + [ctypes.c_uint64, f32p, f32p, f32p]
    lib.ks_fisher_vector.restype = ctypes.c_int
    lib.ks_fisher_vector.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, ctypes.c_int, f32p]
    if has_jpeg:
        lib.ks_decode_jpeg_batch.restype = ctypes.c_int
        lib.ks_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
            ctypes.c_int,
            f32p,
        ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error, _has_jpeg
    with _load_lock:  # decode threads may ask first, together
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path, has_jpeg = build.native_library()
            lib = _bind(str(path), has_jpeg)
        except (RuntimeError, OSError, AttributeError) as e:
            # RuntimeError: the compiler's output or an ABI mismatch; OSError:
            # a library that does not load; AttributeError: a missing symbol.
            _build_error = str(e)
            return None
        _lib, _has_jpeg = lib, has_jpeg
        return _lib


def available() -> bool:
    return _load() is not None


def jpeg_available() -> bool:
    """True when the library was built against libjpeg."""
    return _load() is not None and _has_jpeg


def build_error() -> Optional[str]:
    _load()
    return _build_error


def require() -> ctypes.CDLL:
    """The loaded library, or a RuntimeError carrying the build's output."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sift_num_keypoints(h: int, w: int, step: int, bin_size: int) -> int:
    n = require().ks_sift_num_keypoints(h, w, step, bin_size)
    if n < 0:
        raise ValueError("bad SIFT grid parameters")
    return n


def dense_sift(images: np.ndarray, step: int = 4, bin_size: int = 4) -> np.ndarray:
    """(n, h, w) grayscale in [0,1] → (n, num_keypoints, 128) float32."""
    lib = require()
    images = _f32(images)
    n, h, w = images.shape
    nkp = sift_num_keypoints(h, w, step, bin_size)
    out = np.empty((n, nkp, 128), dtype=np.float32)
    rc = lib.ks_dense_sift(_ptr(images), n, h, w, step, bin_size, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"ks_dense_sift failed ({rc})")
    return out


def gmm_fit(X: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, d) → (weights (k,), means (k, d), vars (k, d))."""
    lib = require()
    X = _f32(X)
    n, d = X.shape
    weights = np.empty(k, dtype=np.float32)
    means = np.empty((k, d), dtype=np.float32)
    variances = np.empty((k, d), dtype=np.float32)
    rc = lib.ks_gmm_fit(_ptr(X), n, d, k, iters, seed, _ptr(weights), _ptr(means), _ptr(variances))
    if rc != 0:
        raise RuntimeError(f"ks_gmm_fit failed ({rc})")
    return weights, means, variances


def decode_jpeg_batch(bufs, size: int) -> np.ndarray:
    """list of JPEG byte strings → (n, size, size, 3) float32 NHWC in [0,1]:
    libjpeg's DCT-scaled decode and a bilinear resize, OpenMP across
    images. Raises ValueError naming the first image that fails."""
    lib = require()
    if not _has_jpeg:
        raise RuntimeError("native library was built without libjpeg")
    n = len(bufs)
    if n == 0:
        return np.empty((0, size, size, 3), dtype=np.float32)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    for i, b in enumerate(bufs):
        offsets[i + 1] = offsets[i] + len(b)
    data = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    out = np.empty((n, size, size, 3), dtype=np.float32)
    rc = lib.ks_decode_jpeg_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        size,
        _ptr(out),
    )
    if rc != 0:
        raise ValueError(f"jpeg decode failed at image {-rc - 1}")
    return out


def fisher_vector(X: np.ndarray, weights: np.ndarray, means: np.ndarray, variances: np.ndarray) -> np.ndarray:
    """Descriptor set (n, d) against a GMM (k) → raw FV (2·k·d,)."""
    lib = require()
    X = _f32(X)
    weights = _f32(weights)
    means = _f32(means)
    variances = _f32(variances)
    n, d = X.shape
    k = weights.shape[0]
    out = np.empty(2 * k * d, dtype=np.float32)
    rc = lib.ks_fisher_vector(_ptr(X), n, d, _ptr(weights), _ptr(means), _ptr(variances), k, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"ks_fisher_vector failed ({rc})")
    return out
