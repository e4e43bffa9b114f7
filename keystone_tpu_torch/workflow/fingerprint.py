"""Content-stable signatures and digests — cross-process cache keys.

The port's copy of ``keystone_tpu/workflow/fingerprint.py``. A
``torch.Tensor`` digests as the numpy bytes of the same values, on any
device, so the same data gives the same digest in both packages. A tensor
on the card is not copied whole to the host: under
``config.fingerprint_max_bytes`` its bytes come over once; above it only
the sampled chunks and probe elements do. A tensor's fingerprint is
memoized on the tensor itself (its identity, ``data_ptr``, ``_version``,
shape and dtype), so an unchanged parameter is digested once however many
keys fold it in.

The in-process prefix memoization (workflow/graph.py structural_hash) keys on
Python ``hash()`` of signature trees, which is per-process (string hashing is
salted, and id()-based fallbacks are only meaningful while the object lives).
To persist fitted prefixes ACROSS processes — the reference's prefix-state
reuse surviving reruns (SURVEY.md §2.1 auto-caching + §5 checkpoint rows
[unverified]) — we need keys derived purely from content.

Two pieces:

- ``stable_value`` canonicalizes an arbitrary hyperparameter tree into
  primitives. Values it cannot stabilize become ``("unstable", id(v),
  UNSTABLE)`` — still unique in-process (so the session cache keeps working)
  but *poisoned* for persistence.
- ``digest_tree`` folds a canonical tree into a hex blake2b digest, returning
  ``None`` when the tree is poisoned. Operators fold dependency digests
  through ``prefix_digest`` exactly the way ``prefix_hash`` folds hashes, so
  fused and unfused chains produce identical digests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from typing import Any, Optional

import numpy as np
import torch


class _Unstable:
    """Singleton marking a signature subtree that has no content identity."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<UNSTABLE>"


UNSTABLE = _Unstable()


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for a tensor's dtype (``float32``, ``int64``, ``bool``)."""
    return str(t.dtype).replace("torch.", "")


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a contiguous host numpy array (bfloat16, which
    numpy lacks, as its raw 16-bit words)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.cpu().numpy())


#: id(tensor) -> (weakref, data_ptr, _version, shape, dtype, fingerprint).
_TENSOR_MEMO_CAP = 1024
_tensor_memo: dict = {}
_tensor_memo_lock = threading.Lock()


def tensor_version(t: torch.Tensor):
    """A tensor's in-place write counter; None for an inference tensor,
    which keeps none."""
    try:
        return t._version
    except RuntimeError:
        return None


def _tensor_key(t: torch.Tensor) -> tuple:
    from keystone_tpu_torch.config import config

    return (t.data_ptr(), tensor_version(t), tuple(t.shape), t.dtype, t.stride(), t.device,
            config.fingerprint_max_bytes)


def tensor_fingerprint(t: torch.Tensor) -> tuple:
    """``array_fingerprint`` of a tensor's values, memoized per live tensor
    and invalidated by any in-place write (``_version``)."""
    key = _tensor_key(t)
    with _tensor_memo_lock:
        hit = _tensor_memo.get(id(t))
        if hit is not None and hit[0]() is t and hit[1] == key:
            return hit[2]
    fp = _fingerprint(t)
    with _tensor_memo_lock:
        while len(_tensor_memo) >= _TENSOR_MEMO_CAP:
            _tensor_memo.pop(next(iter(_tensor_memo)))
        try:
            _tensor_memo[id(t)] = (weakref.ref(t), key, fp)
        except TypeError:
            pass
    return fp


def array_fingerprint(a) -> tuple:
    """Content identity of a numeric array: shape, dtype, blake2b of bytes.

    Above ``config.fingerprint_max_bytes`` the digest covers a deterministic
    sample (64 evenly-spaced 1 MiB chunks plus head and tail) instead of the
    full buffer — bounded cost for multi-GB fit inputs, at the engineering
    risk (same as the solver checkpoint fingerprints' row probes) that a
    change confined entirely to unsampled bytes goes unseen. Real data never
    changes that way; adversarial inputs shouldn't share a cache dir.

    ``a`` may be a ``torch.Tensor`` on any device: it digests as
    ``np.asarray`` of its values would (``tensor_fingerprint``).
    """
    if isinstance(a, torch.Tensor):
        return tensor_fingerprint(a)
    return _fingerprint(a)


def _fingerprint(a) -> tuple:
    """The digest of ``array_fingerprint``, for a numpy array or a tensor."""
    from keystone_tpu_torch.config import config

    tensor = isinstance(a, torch.Tensor)
    shape = tuple(a.shape)
    dtype = _dtype_name(a) if tensor else str(a.dtype)
    nbytes = a.numel() * a.element_size() if tensor else a.nbytes
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(shape).encode())
    h.update(dtype.encode())
    limit = config.fingerprint_max_bytes
    if nbytes <= limit:
        c = _host_bytes(a) if tensor else np.ascontiguousarray(a)  # bounded by limit even when it copies
        h.update(memoryview(c).cast("B"))
        return ("ndarray", shape, dtype, h.hexdigest())
    # Over-limit: TWO independent deterministic samples, so a change must
    # dodge both lattices to collide. Pass 1 walks ~64 row-block chunks of
    # ~1 MiB via axis-0 slices (views; each chunk is made contiguous and
    # hashed through a hard per-chunk cap, so a handful of huge rows —
    # n0 < 64 with multi-MiB rows — can no longer turn the "bounded" path
    # into a full-buffer hash). Per-chunk byte counts fold into the digest.
    h.update(str(nbytes).encode())
    n0 = shape[0]
    row_bytes = max(nbytes // max(n0, 1), 1)
    rows_per = max(1, (1 << 20) // row_bytes)
    stride = max(n0 // 64, rows_per)
    cap = 1 << 20  # hashed bytes per chunk, regardless of row size
    budget = 96 << 20  # whole-call ceiling, small-n0 case included
    spent = 0
    starts = list(range(0, n0, stride))
    tail_start = max(n0 - rows_per, 0)
    if tail_start not in starts:
        starts.append(tail_start)
    for s in starts:
        if spent >= budget:
            break
        chunk = _host_bytes(a[s : s + rows_per]) if tensor else np.ascontiguousarray(a[s : s + rows_per])
        mv = memoryview(chunk).cast("B")[:cap]
        h.update(str(chunk.nbytes).encode())
        h.update(mv)
        spent += len(mv)
    # Pass 2: a strided ELEMENT probe across the whole array in logical
    # C-order (``a.flat`` fancy-indexing — a ~65k-element gather that works
    # for ANY memory layout and hashes every byte of each probed element),
    # at a step derived from a prime probe count so it stays incommensurate
    # with pass 1's row-block lattice. Logical order also keeps the digest
    # layout-independent: the same matrix C- or F-contiguous hashes equal.
    size = a.numel() if tensor else a.size
    step = max(size // 65521, 1)
    idx = np.arange(0, size, step)
    if tensor:
        # The probe gathered on the tensor's device: only its elements come
        # to the host, in the same logical C order as ``a.flat``.
        where = tuple(torch.from_numpy(ix).to(a.device) for ix in np.unravel_index(idx, shape))
        probe = _host_bytes(a[where])
    else:
        probe = np.ascontiguousarray(a.flat[idx])
    h.update(b"p2" + str(step).encode())
    h.update(memoryview(probe).cast("B"))
    return ("ndarray-sampled", shape, dtype, h.hexdigest())


def text_fingerprint(seq) -> Optional[tuple]:
    """Content identity of a text corpus (list/tuple of str) — the dataset
    payload of every NLP pipeline. Full hash up to the size budget, then a
    strided item sample (same engineering tradeoff as array_fingerprint).
    None if any element isn't a str."""
    from keystone_tpu_torch.config import config

    h = hashlib.blake2b(digest_size=16)
    n = len(seq)
    total = 0  # chars — a ≤4× under-count of UTF-8 bytes, used ONLY to
    for s in seq:  # pick full-vs-sampled mode, never as the work bound
        if not isinstance(s, str):
            return None
        total += len(s)
    h.update(str(n).encode())
    h.update(str(total).encode())  # total size is part of the identity
    limit = config.fingerprint_max_bytes
    if total <= limit:
        for s in seq:
            b = s.encode()
            h.update(str(len(b)).encode())
            h.update(b)
        return ("text", n, h.hexdigest())
    # Sampled mode: every sampled item contributes its exact byte length,
    # but hashed CONTENT is hard-capped (≤1 MiB per item, ≤64 MiB overall)
    # so corpus size never unbounds the first structural hash.
    step = max(1, n // 1024)
    budget = 64 << 20
    spent = 0
    for i in range(0, n, step):
        b = seq[i].encode()
        h.update(str(len(b)).encode())
        if spent < budget:
            take = min(len(b), budget - spent, 1 << 20)
            h.update(b[:take])
            spent += take
    return ("text-sampled", n, h.hexdigest())


def stable_value(v: Any) -> Any:
    """Canonicalize ``v`` into a tree of primitives; unknown objects keep
    their id (in-process uniqueness) but carry the UNSTABLE poison."""
    if v is None or isinstance(v, (bool, int, float, str, bytes, _Unstable)):
        return v
    if isinstance(v, type):
        return ("class", v.__module__, v.__qualname__)
    if isinstance(v, (tuple, list)):
        return ("seq", tuple(stable_value(x) for x in v))
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            return ("unstable", id(v), UNSTABLE)
        return (
            "dict",
            tuple((k, stable_value(v[k])) for k in sorted(v)),
        )
    if isinstance(v, torch.Tensor):
        if v.is_sparse or v.layout != torch.strided:
            return ("unstable", id(v), UNSTABLE)
        return array_fingerprint(v)  # sampled on the device past the size limit
    if isinstance(v, (torch.device, torch.dtype)):
        return ("torch", type(v).__name__, str(v))
    if isinstance(v, np.ndarray):
        if v.dtype.kind in "biufc":
            return array_fingerprint(v)
        return ("unstable", id(v), UNSTABLE)
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return ("npscalar", str(v.dtype), v.item())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (
            "dataclass",
            stable_value(type(v)),
            tuple(
                (f.name, stable_value(getattr(v, f.name)))
                for f in dataclasses.fields(v)
            ),
        )
    return ("unstable", id(v), UNSTABLE)


def is_stable(tree: Any) -> bool:
    if isinstance(tree, _Unstable):
        return False
    if isinstance(tree, tuple):
        return all(is_stable(x) for x in tree)
    return True


def _encode(v: Any, h) -> bool:
    """Fold ``v`` into hasher ``h`` with type tags; False when poisoned."""
    if isinstance(v, _Unstable):
        return False
    if v is None:
        h.update(b"N")
    elif isinstance(v, bool):
        h.update(b"b1" if v else b"b0")
    elif isinstance(v, int):
        h.update(b"i" + str(v).encode())
    elif isinstance(v, float):
        h.update(b"f" + repr(v).encode())
    elif isinstance(v, str):
        b = v.encode()
        h.update(b"s" + str(len(b)).encode() + b":" + b)
    elif isinstance(v, bytes):
        h.update(b"y" + str(len(v)).encode() + b":" + v)
    elif isinstance(v, tuple):
        h.update(b"T" + str(len(v)).encode() + b":")
        for x in v:
            if not _encode(x, h):
                return False
    elif isinstance(v, type):
        return _encode(stable_value(v), h)
    elif isinstance(v, np.ndarray):
        return _encode(array_fingerprint(v), h)
    elif isinstance(v, torch.Tensor):
        return _encode(stable_value(v), h)
    elif isinstance(v, (np.integer, np.floating, np.bool_)):
        return _encode(stable_value(v), h)
    else:
        # Raw signature trees may carry objects stable_value knows about.
        sv = stable_value(v)
        if isinstance(sv, tuple) and sv and sv[0] == "unstable":
            return False
        return _encode(sv, h)
    return True


def digest_tree(tree: Any) -> Optional[str]:
    """Hex digest of a canonical tree, or None if any part is unstable."""
    h = hashlib.blake2b(digest_size=20)
    if not _encode(tree, h):
        return None
    return h.hexdigest()
