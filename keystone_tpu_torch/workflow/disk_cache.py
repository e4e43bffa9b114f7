"""On-disk fitted-prefix store — prefix-state reuse across processes.

The port's copy of ``keystone_tpu/workflow/disk_cache.py``. Entries hold
tensors as numpy arrays: ``put`` pickles each tensor (a module's buffers
and parameters included) as ``_tensor_from_numpy`` of its host values, its
dtype and whether it was a parameter. PyTorch's own pickling of a tensor
rebuilds its storage through ``torch.load`` with ``weights_only=False``,
which would run any pickle an entry planted, so the restricted unpickler
admits no torch callable at all; it admits classes from
``keystone_tpu_torch``, ``numpy`` and ``collections``, from ``torch`` only
``torch.device``, ``torch.Size``, ``nn.ModuleList``, ``nn.ModuleDict``
and the dtypes, and of callables exactly
numpy's reconstructors and ``_tensor_from_numpy``. Tensors load on the
host; the executor moves a fitted module read back onto the env's device
(``PipelineEnv.device``).

The reference's fitted pipelines persist their prefix state so a rerun skips
refits (SURVEY.md §2.1 auto-caching + §5 checkpoint/resume rows [unverified]).
Here the store is content-addressed: the key is the structural digest of the
estimator node's prefix (class + hyperparams + data fingerprints, see
workflow/fingerprint.py), so a hit is byte-level evidence the same fit would
recompute the same transformer — no invalidation logic needed, stale entries
are simply never addressed.

Enabled by ``KEYSTONE_CACHE_DIR`` (or ``config.cache_dir``); corrupt or
unreadable entries degrade to cache misses, never errors.

Trust boundary: entries are pickles, and unpickling runs code. The cache
directory MUST be private to the user — it is created mode 0o700, and loads
go through a restricted unpickler that only resolves classes from an
allowlist of module prefixes (keystone_tpu_torch / torch / numpy / stdlib containers),
so a planted entry cannot smuggle in ``os.system``-style callables. Entries
that reference anything else degrade to misses. Set
``KEYSTONE_CACHE_TRUST_ALL=1`` to disable the allowlist for caches holding
user-defined transformer classes outside these prefixes.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch


def _tensor_state(t: torch.Tensor) -> tuple:
    """A tensor as (host numpy values, dtype name, is-a-parameter);
    bfloat16, which numpy lacks, as its raw 16-bit words."""
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return (a.contiguous().numpy(), str(t.dtype), isinstance(t, torch.nn.Parameter))


def _tensor_from_numpy(values: np.ndarray, dtype: str, parameter: bool) -> torch.Tensor:
    """The inverse of ``_tensor_state``: a host tensor (a parameter that
    needs no gradient when it was one)."""
    t = torch.from_numpy(np.array(values))
    if dtype == "torch.bfloat16":
        t = t.view(torch.bfloat16)
    return torch.nn.Parameter(t, requires_grad=False) if parameter else t


class _TensorPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_from_numpy, _tensor_state(obj)
        return NotImplemented

logger = logging.getLogger("keystone_tpu_torch")

#: Exact non-class reconstruction callables array pickles need (measured by
#: recording find_class over real fitted-transformer pickles). Everything
#: else callable is denied — broad module prefixes would leave gadget chains
#: (e.g. ``functools.partial(numpy.load, allow_pickle=True)`` re-enters
#: unrestricted pickle), so functions are enumerated, never pattern-matched.
_SAFE_CALLABLES = frozenset(
    {
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.multiarray", "scalar"),
        ("keystone_tpu_torch.workflow.disk_cache", "_tensor_from_numpy"),
        ("collections", "OrderedDict"),
    }
)

#: Module roots whose *classes* (types only — never functions) may appear in
#: an entry: array/dtype containers and stdlib collections. A type's
#: constructor runs on unpickle, but these are data containers, not
#: exec/eval/system-shaped.
_SAFE_CLASS_ROOTS = ("keystone_tpu_torch", "torch", "numpy", "collections")

#: The handful of builtins pickles legitimately need for container types.
_SAFE_BUILTINS = frozenset(
    {
        "complex", "frozenset", "set", "slice", "range", "bytearray",
        "list", "dict", "tuple", "int", "float", "bool", "str", "bytes",
        "object",
    }
)


def _class_root_ok(root: str, obj: type) -> bool:
    """Per-root class rules. numpy is the sharp edge: ndarray SUBCLASSES
    include ``numpy.memmap``, whose constructor creates/truncates arbitrary
    files during REDUCE — so exactly ``ndarray`` itself plus the dtype and
    scalar hierarchies are admitted, nothing derived."""
    import numpy as _np
    import torch as _torch

    if root == "numpy":
        return obj is _np.ndarray or issubclass(obj, (_np.dtype, _np.generic))
    if root == "torch":
        # Devices, shapes and the module containers a fused chain holds its
        # stages in; tensors come through _tensor_from_numpy.
        return obj in (_torch.device, _torch.Size, _torch.nn.ModuleList, _torch.nn.ModuleDict)
    return True


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins":
            if name in _SAFE_BUILTINS:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"disk fit cache: builtins.{name} not allowlisted"
            )
        if (module, name) in _SAFE_CALLABLES:
            return super().find_class(module, name)
        root = module.split(".", 1)[0]
        # Resolution itself imports the module and runs its top-level code,
        # so outside the known roots the module must ALREADY be imported —
        # an attacker-named module (including a planted .py on sys.path)
        # never gets imported by a cache read.
        import sys as _sys

        if root not in _SAFE_CLASS_ROOTS and module not in _sys.modules:
            raise pickle.UnpicklingError(
                f"disk fit cache: module {module!r} not imported; refusing "
                "to import it on behalf of a cache entry"
            )
        obj = super().find_class(module, name)
        if root == "torch" and isinstance(obj, torch.dtype):
            return obj
        if root in _SAFE_CLASS_ROOTS:
            if isinstance(obj, type) and _class_root_ok(root, obj):
                return obj
            raise pickle.UnpicklingError(
                f"disk fit cache: {module}.{name} is not an allowlisted "
                "class or reconstructor"
            )
        # User-defined transformers live outside the roots but are the
        # store's whole purpose: require an actual subclass of the framework
        # bases — ``os.system`` (not a class) and ``subprocess.Popen`` (a
        # class, but not a Transformer) both fail.
        from keystone_tpu_torch.workflow.pipeline import Estimator, LabelEstimator, Transformer

        if isinstance(obj, type) and issubclass(
            obj, (Transformer, Estimator, LabelEstimator)
        ):
            return obj
        raise pickle.UnpicklingError(
            f"disk fit cache: {module}.{name} not allowlisted "
            "(set KEYSTONE_CACHE_TRUST_ALL=1 for caches holding arbitrary "
            "user-defined state)"
        )


def _load_entry(f) -> Any:
    # Strict "=1" on purpose (NOT env_flag): this knob disables the
    # restricted unpickler entirely, so a mistyped spelling ("off",
    # "disabled", ...) must fail closed (keep the allowlist), not open.
    if os.environ.get("KEYSTONE_CACHE_TRUST_ALL") == "1":
        return pickle.load(f)
    return _RestrictedUnpickler(f).load()


class DiskCache:
    """Key-addressed atomic pickle store — the durability substrate shared
    by the fitted-prefix cache (``DiskFitCache``) and the streaming
    solvers' checkpoint/resume state (linalg/normal_equations.py,
    linalg/bcd.py).

    Crash-safety contract: ``put`` writes to a temp file in the cache root
    and ``os.replace``s it into place, so a process killed mid-write can
    never leave a truncated entry that poisons later ``get``s — the reader
    sees either the old entry or the new one, both complete. Temp files
    orphaned by a mid-write kill are swept (age-gated, so a concurrent
    writer's in-flight temp survives) on the next construction. Reads go
    through the restricted unpickler above; corrupt or unreadable entries
    degrade to misses, never errors.
    """

    #: Entry filename suffix — namespaces co-resident stores (trim and the
    #: stale-temp sweep only ever touch their own suffix).
    SUFFIX = ".pkl"

    #: Orphaned temp files older than this are removed at construction; the
    #: age gate keeps a live concurrent writer's temp out of the sweep.
    _TMP_MAX_AGE_S = 3600.0

    def __init__(
        self,
        root: str,
        max_bytes: Optional[int] = None,
        suffix: Optional[str] = None,
    ):
        self.root = root
        self.suffix = suffix if suffix is not None else self.SUFFIX
        if max_bytes is None:
            raw = os.environ.get("KEYSTONE_CACHE_MAX_BYTES", "")
            try:
                max_bytes = int(raw) if raw else 10 << 30
            except ValueError:  # malformed knob: default, don't abort runs
                logger.warning(
                    "ignoring malformed KEYSTONE_CACHE_MAX_BYTES=%r", raw
                )
                max_bytes = 10 << 30
        self.max_bytes = max_bytes
        # Approximate directory size, refreshed by each sweep: puts only pay
        # the full listdir+stat sweep when the estimate crosses the budget —
        # but at most _SWEEP_EVERY puts go by between real sweeps, because
        # the estimate only counts THIS process's writes and a shared
        # directory grows under everyone's.
        self._approx_total: Optional[int] = None
        self._puts_since_sweep = 0
        # 0o700 on creation: pickled entries execute on load, so the dir
        # must not be writable (or readable) by other users. Pre-existing
        # dirs keep their mode — tightening a deliberately shared cache
        # behind the owner's back would break it silently.
        os.makedirs(root, mode=0o700, exist_ok=True)
        self._sweep_stale_tmps()

    _SWEEP_EVERY = 32

    def _owns(self, name: str, extra: str = "") -> bool:
        """Suffix scoping for directory sweeps. ``endswith`` alone is
        hierarchical ('.fit.pkl' ends with '.pkl'), so additionally the
        part before the suffix must be dot-free — true of every key this
        layer writes (digests, snapshot names, mkstemp stems), false for
        a longer co-resident suffix's files."""
        tail = f"{self.suffix}{extra}"
        return name.endswith(tail) and "." not in name[: -len(tail)]

    def _sweep_stale_tmps(self) -> None:
        """Remove temp files orphaned by a writer killed between mkstemp
        and os.replace — they hold partial pickles nothing will ever
        complete. Age-gated so an in-flight concurrent write survives,
        and suffix-scoped (temps are named <suffix>.tmp) so this store
        never touches a co-resident store's in-flight writes."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        now = time.time()  # lint: ok(KL005) compared against st_mtime, which is wall-clock
        for name in names:
            if not self._owns(name, extra=".tmp"):
                continue
            path = os.path.join(self.root, name)
            try:
                if now - os.stat(path).st_mtime > self._TMP_MAX_AGE_S:
                    os.remove(path)
            except OSError:
                continue  # racing sweeper/writer: theirs to handle

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}{self.suffix}")

    def _trim(self) -> None:
        """Evict least-recently-USED entries (get() refreshes mtime) until
        under the size budget — content-addressed entries are always safe to
        drop (pure misses). Per-file errors skip and continue: a concurrent
        trimmer racing us must not abort the whole sweep."""
        if (
            self._approx_total is not None
            and self._approx_total <= self.max_bytes
            and self._puts_since_sweep < self._SWEEP_EVERY
        ):
            return
        self._puts_since_sweep = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        entries = []
        total = 0
        for name in names:
            if not self._owns(name):
                continue
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # removed by a concurrent trimmer
            entries.append((st.st_mtime, st.st_size, path))
            total += st.st_size
        if total <= self.max_bytes:
            self._approx_total = total
            return
        entries.sort()
        for _mtime, size, path in entries:
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            if total <= self.max_bytes:
                break
        self._approx_total = total

    def delete(self, key: str) -> None:
        """Remove one entry; missing is fine. The checkpoint stores call
        this on successful solve completion — a consumed snapshot left
        behind could silently resume a LATER solve over changed data whose
        fingerprint probe happens to match."""
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def get(self, key: str) -> Optional[Any]:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                fitted = _load_entry(f)
        except FileNotFoundError:
            return None
        except Exception as e:  # lint: broad-ok corrupt/unpicklable entry (any unpickling error): miss, don't die
            logger.warning("disk fit cache: dropping unreadable %s (%s)", path, e)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path)  # refresh recency: eviction is LRU, not FIFO
        except OSError:
            pass
        logger.info("disk fit cache: hit %s", key)
        return fitted

    def put(self, key: str, fitted: Any, overwrite: bool = False) -> None:
        """Persist one entry atomically (temp file + ``os.replace``).

        ``overwrite=False`` (content-addressed use: the bytes behind a key
        never change) skips keys that already exist; ``overwrite=True``
        (checkpoint use: the same key is rewritten every K chunks)
        replaces the entry — still atomically, so a kill mid-rewrite
        leaves the PREVIOUS complete checkpoint, never a truncated one.
        """
        path = self._path(key)
        if not overwrite and os.path.exists(path):
            return
        try:
            fd, tmp = tempfile.mkstemp(
                dir=self.root, suffix=f"{self.suffix}.tmp"
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    # Protocol 4: at 5 numpy pickles arrays through
                    # _frombuffer, which the allowlist does not admit.
                    _TensorPickler(f, protocol=4).dump(fitted)
                os.replace(tmp, path)  # atomic: concurrent writers race safely
                self._puts_since_sweep += 1
                if self._approx_total is not None:
                    try:
                        self._approx_total += os.path.getsize(path)
                    except OSError:
                        self._approx_total = None  # force a real sweep
                self._trim()
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except Exception as e:  # lint: broad-ok persistence is best-effort; a failed put must never fail the fit
            logger.warning("disk fit cache: could not persist %s (%s)", key, e)


class DiskFitCache(DiskCache):
    """The cross-process fitted-prefix store (module docstring above): a
    ``DiskCache`` whose keys are structural digests of estimator prefixes,
    so entries are content-addressed and never overwritten."""

    SUFFIX = ".fit.pkl"
