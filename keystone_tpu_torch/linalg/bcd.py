"""Block coordinate descent over feature blocks, on one device.

Counterpart of ``keystone_tpu/linalg/bcd.py``: ``block_coordinate_descent``
(``:485-620``), ``block_coordinate_descent_streamed`` (``:1003-1293``) and
their checkpoints, with the math of ``_local_ridge_gram`` (``:54-64``),
``_batched_spd_inv`` (``:160-206``) and ``_local_solve_update``
(``:82-90``). It solves

    min_W  Σ_i w_i ‖(A W − B)_i‖² + λ ‖W‖²

(w_i = 1 without row weights) block by block, with a Python loop over
epochs and blocks. Visiting block b:

    R⁺ = R + A_b W_b;   W_b = (A_bᵀ diag(w) A_b + λI)⁻¹ A_bᵀ diag(w) R⁺;   R = R⁺ − A_b W_b

The ridge gram is epoch-invariant. With ``cache_grams`` (the reference's
auto rule: more than one epoch, and the inverses within a quarter of the
memory budget) each block's inverse is formed once, before the first epoch,
by ``torch.linalg.cholesky`` and ``torch.cholesky_inverse`` batched over
the blocks of equal width; an epoch is then gemms only. Without it each
visit factors its gram again and solves with ``torch.cholesky_solve``.
These are library calls, as the reference leaves them to XLA.

The solver's modes (``config.py``) are arguments of both solves:

- ``precision`` of the float32 products (``highest``, ``high``,
  ``default``; ``row_matrix.solver_matmul``);
- the storage dtype of A: the dense solve takes A's own dtype, the
  streamed one prepares its blocks in ``storage_dtype``. With bfloat16, A
  and the row weights are stored in bfloat16 (the reference casts its
  ``w_rows`` to A's dtype), every product that touches A rounds its other
  operand (W_b, R) to bfloat16 and accumulates into float32, and W, R, the
  grams, inverses and objectives stay float32. A streamed block is
  centered in float32 and then rounded, once.

The streamed solve keeps A in host memory, the caller's array or a CSR
``SparseBatch`` (``bcd.py:1019-1050``), and sends one column block at a
time to the device: a prefetch thread prepares the blocks (a contiguous
copy, centered by ``col_center``; a sparse block densified) into pinned
buffers two ahead, and block i+1's copy runs on a copy stream while block
i updates (``utils/staging.py``). Its first epoch forms each block's inverse as it
visits it (the reference's ``_first_epoch_update_fn``) and keeps it; later
epochs reuse it.

Checkpoints, in the port's own format (``torch.save`` to a temporary file,
then ``os.replace``), bound to a fingerprint of the problem:

- ``epoch_{N}.pt`` after every epoch (W and R), which the dense and the
  streamed solve resume from each other;
- in the streamed solve, ``bcd_stream.pt`` every ``checkpoint_every``
  blocks (W, R, the inverses formed so far and the block cursor), deleted
  when the solve completes. A resume takes whichever is further along (the
  snapshot on a tie, for its inverses); a checkpoint of another problem is
  ignored with a warning.

An active ``StageTimer`` gets the "BCD factor phase" and each "BCD epoch"
as stages, the objective after each epoch as a note and, in the streamed
solve, each block's prep, copy and update milliseconds.
"""

from __future__ import annotations

import os
import re
import tempfile
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.config import solver_precision
from keystone_tpu_torch.linalg.row_matrix import HBM_BUDGET_BYTES, solver_matmul
from keystone_tpu_torch.linalg.row_matrix import storage_dtype as storage_dtype_of
from keystone_tpu_torch.loaders.stream import PREFETCH_DEPTH, PrefetchIterator
from keystone_tpu_torch.utils.sparse import SparseBatch
from keystone_tpu_torch.utils.stages import active, elapsed_s, mark, note, stamp
from keystone_tpu_torch.utils.staging import HostStager

# Blocks between the streamed solve's mid-epoch snapshots (the reference's
# config.checkpoint_every).
CHECKPOINT_EVERY = 8
SNAPSHOT = "bcd_stream.pt"
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt")


def ridge_gram(a_b: torch.Tensor, aw: torch.Tensor, lam: float, precision: str = "highest") -> torch.Tensor:
    """(A_b·w)ᵀ A_b + λI in float32, symmetrized as the reference's
    ``jnp.linalg.cholesky`` symmetrizes its input: the factorisation reads
    one triangle only, and with A in bfloat16 the rounded A_b·w makes the
    product visibly unsymmetric."""
    gram = solver_matmul(aw.T, a_b, precision)
    gram = (gram + gram.T).mul_(0.5)
    gram.diagonal().add_(lam)
    return gram


def spd_inverse(grams: torch.Tensor) -> torch.Tensor:
    """Inverse of each SPD matrix of a (…, b, b) stack, through its
    Cholesky factor."""
    return torch.cholesky_inverse(torch.linalg.cholesky(grams))


def _weighted(a_b, row_weights):
    return a_b if row_weights is None else a_b * row_weights[:, None]


def _solve_update(a_b, aw, inv, R, w_b, precision):
    """One visit with the block's ridge inverse: (R, W_b) after it."""
    r_plus = R + solver_matmul(a_b, w_b, precision)
    w_new = solver_matmul(inv, solver_matmul(aw.T, r_plus, precision), precision)
    return r_plus - solver_matmul(a_b, w_new, precision), w_new


def _first_update(a_b, aw, R, w_b, lam, precision):
    """A visit that forms the block's ridge inverse first: (R, W_b, inverse).
    The gram is freed once factored, so that at most two (b, b) temporaries
    live beside the inverses."""
    factor = torch.linalg.cholesky(ridge_gram(a_b, aw, lam, precision))
    inv = torch.cholesky_inverse(factor)
    del factor
    R, w_b = _solve_update(a_b, aw, inv, R, w_b, precision)
    return R, w_b, inv


def objective(R: torch.Tensor, W: List[torch.Tensor], lam: float, row_weights=None):
    """Σ_i w_i ‖R_i‖² + λ‖W‖² as a 0-d tensor, for the residual R = B − A W."""
    rr = (R * R).sum(dim=1)
    data = rr.sum() if row_weights is None else (row_weights * rr).sum()
    return data + lam * sum((w * w).sum() for w in W)


def _end_epoch(epoch, R, W, lam, row_weights, checkpoint_dir, fingerprint) -> None:
    mark(f"BCD epoch {epoch + 1}")
    note(f"objective after epoch {epoch + 1}", lambda: objective(R, W, lam, row_weights))
    if checkpoint_dir is not None:
        _save_epoch(checkpoint_dir, epoch + 1, W, R, fingerprint)


# -- checkpoints ---------------------------------------------------------


_PROBES = ("a_probe", "b_probe")


def _fingerprint(n, d, k, block_size, lam, weighted, a_dtype, a_probe, B) -> dict:
    """The problem a checkpoint belongs to (the reference's
    ``_make_fingerprint`` without its mesh keys). ``a_dtype`` is the dtype A
    is stored in. The probes sum the first and last rows of the matrix the
    solve sees (A after centering) and of B."""
    return {
        "n": int(n), "d": int(d), "k": int(k), "block_size": int(block_size),
        "lam": float(lam), "weighted": bool(weighted), "a_dtype": str(a_dtype).removeprefix("torch."),
        "a_probe": float(a_probe), "b_probe": float(B[0].sum() + B[-1].sum()),
    }


def _same_problem(saved, expected) -> bool:
    """Every key equal, λ included; the probes, sums of floats that the two
    solves round differently, within a relative 1e-3."""
    if set(saved) != set(expected):
        return False
    for key, val in expected.items():
        if key in _PROBES:
            if abs(float(saved[key]) - val) > 1e-3 * max(1.0, abs(val)):
                return False
        elif saved[key] != val:
            return False
    return True


def _atomic_save(obj, path: str) -> None:
    """``obj`` written whole at ``path`` or not at all."""
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _load(path: str, fingerprint: dict, device):
    """The checkpoint at ``path`` if it belongs to this problem, else None
    (with a warning)."""
    state = torch.load(path, map_location=device, weights_only=True)
    if not _same_problem(state["fingerprint"], fingerprint):
        warnings.warn(f"checkpoint {path} holds a different solve; ignoring it")
        return None
    return state


def _latest_epoch(checkpoint_dir: str, fingerprint: dict, device):
    if not os.path.isdir(checkpoint_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_EPOCH_FILE.fullmatch, os.listdir(checkpoint_dir)) if m]
    if not epochs:
        return None
    return _load(os.path.join(checkpoint_dir, f"epoch_{max(epochs)}.pt"), fingerprint, device)


def _save_epoch(checkpoint_dir, epoch, W, R, fingerprint) -> None:
    _atomic_save(
        {"epoch": epoch, "W": [w.cpu() for w in W], "R": R.cpu(), "fingerprint": fingerprint},
        os.path.join(checkpoint_dir, f"epoch_{epoch}.pt"),
    )


def _save_snapshot(checkpoint_dir, fingerprint, epoch, block, W, R, invs) -> None:
    """``block`` blocks of ``epoch`` are done."""
    _atomic_save(
        {
            "fingerprint": fingerprint, "epoch": int(epoch), "block": int(block),
            "W": [w.cpu() for w in W], "R": R.cpu(),
            "invs": {i: v.cpu() for i, v in enumerate(invs) if v is not None},
        },
        os.path.join(checkpoint_dir, SNAPSHOT),
    )


# -- dense ----------------------------------------------------------------


def block_coordinate_descent(
    A: torch.Tensor,
    B: torch.Tensor,
    block_size: int,
    num_iters: int,
    lam: float = 0.0,
    row_weights: Optional[torch.Tensor] = None,
    cache_grams: Optional[bool] = None,
    checkpoint_dir: Optional[str] = None,
    precision: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[Tuple[int, int]]]:
    """Returns (per-block weights, block column ranges). ``A`` (n, d), in
    its storage dtype (float32 or bfloat16), and ``B`` (n, k), float32, lie
    on one device; ``A`` is only read (its column blocks are views). With
    ``checkpoint_dir`` the solve resumes from the latest epoch saved there
    for this problem and saves every epoch."""
    precision = solver_precision(precision)
    n, d = A.shape
    k = B.shape[1]
    if B.shape[0] != n:
        raise ValueError(f"A has {n} rows, B {B.shape[0]}")
    blocks = [(s, min(s + block_size, d)) for s in range(0, d, block_size)]
    f32 = dict(dtype=torch.float32, device=A.device)
    if cache_grams is None:
        factor_bytes = sum((e - s) ** 2 for s, e in blocks) * 4
        cache_grams = num_iters > 1 and factor_bytes < HBM_BUDGET_BYTES // 4
    w_rows = None if row_weights is None else row_weights.to(A.dtype)
    W = [torch.zeros((e - s, k), **f32) for s, e in blocks]
    R = B.clone()
    start_epoch, fingerprint = 0, None
    if checkpoint_dir is not None:
        a_probe = float(A[0].float().sum() + A[-1].float().sum())
        fingerprint = _fingerprint(n, d, k, block_size, lam, row_weights is not None, A.dtype, a_probe, B)
        state = _latest_epoch(checkpoint_dir, fingerprint, A.device)
        if state is not None:
            start_epoch, W, R = state["epoch"], list(state["W"]), state["R"]

    invs = None
    if cache_grams and start_epoch < num_iters:
        invs = []
        # Equal-width blocks are factored as one batch; a ragged last block
        # on its own.
        for width in sorted({e - s for s, e in blocks}, reverse=True):
            idx = [i for i, (s, e) in enumerate(blocks) if e - s == width]
            grams = torch.empty((len(idx), width, width), **f32)
            for j, i in enumerate(idx):
                a_b = A[:, blocks[i][0]:blocks[i][1]]
                grams[j] = ridge_gram(a_b, _weighted(a_b, w_rows), lam, precision)
            invs.extend(zip(idx, spd_inverse(grams)))
            del grams
        invs = [inv for _, inv in sorted(invs, key=lambda t: t[0])]
        mark("BCD factor phase")

    for epoch in range(start_epoch, num_iters):
        for i, (s, e) in enumerate(blocks):
            a_b = A[:, s:e]
            aw = _weighted(a_b, w_rows)
            if invs is not None:
                R, W[i] = _solve_update(a_b, aw, invs[i], R, W[i], precision)
            else:
                r_plus = R + solver_matmul(a_b, W[i], precision)
                rhs = solver_matmul(aw.T, r_plus, precision)
                W[i] = torch.cholesky_solve(rhs, torch.linalg.cholesky(ridge_gram(a_b, aw, lam, precision)))
                R = r_plus - solver_matmul(a_b, W[i], precision)
        _end_epoch(epoch, R, W, lam, row_weights, checkpoint_dir, fingerprint)
    return W, blocks


# -- streamed -------------------------------------------------------------


def host_matrix(A):
    """``A`` (a host array or a CPU tensor) as a float32 CPU tensor, without
    a copy when it is float32 already; a ``SparseBatch`` as it is."""
    if isinstance(A, SparseBatch):
        return A
    if isinstance(A, torch.Tensor):
        if A.device.type != "cpu":
            raise ValueError(f"a streamed solve takes A in host memory, not on {A.device}")
        return A.to(torch.float32)
    arr = np.asarray(A, dtype=np.float32)
    with warnings.catch_warnings():
        # Read-only arrays are welcome: nothing here writes to A.
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)


# Rows of a block prepared at a time: 16 MiB of float32 input. The host's
# float32-to-bfloat16 subtraction runs several times slower over a whole
# 256 MiB block than in panels of this size; float32 output takes about the
# same time either way.
_PREP_PANEL_BYTES = 16 << 20


def prepare_block(A, center: Optional[torch.Tensor], s: int, e: int, out: torch.Tensor) -> None:
    """Writes columns ``s:e`` of the float32 host matrix ``A``, minus
    ``center[s:e]``, into ``out`` in ``out``'s dtype: centered in float32,
    then rounded once. Rounding first would leave the centered values with
    the rounding error of the uncentered magnitude. A ``SparseBatch``'s
    block is densified into ``out`` (zeros, then its entries)."""
    if isinstance(A, SparseBatch):
        if center is not None:
            raise ValueError("a sparse A is not centered (its intercept is a ones column)")
        rows, cols, vals = (torch.from_numpy(a) for a in A.block_entries(s, e))
        out.zero_()
        out[rows, cols.long()] = vals.to(out.dtype)
        return
    rows = max(1, _PREP_PANEL_BYTES // (4 * (e - s)))
    for r in range(0, A.shape[0], rows):
        if center is None:
            out[r : r + rows].copy_(A[r : r + rows, s:e])
        else:
            torch.sub(A[r : r + rows, s:e], center[s:e], out=out[r : r + rows])


def block_coordinate_descent_streamed(
    A_host,
    B: torch.Tensor,
    block_size: int,
    num_iters: int,
    lam: float = 0.0,
    row_weights: Optional[torch.Tensor] = None,
    checkpoint_dir: Optional[str] = None,
    col_center=None,
    checkpoint_every: int = CHECKPOINT_EVERY,
    overlap: bool = True,
    precision: Optional[str] = None,
    storage_dtype: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[Tuple[int, int]]]:
    """The solve of ``block_coordinate_descent`` with ``A_host`` (n, d) left
    in host memory, uncopied and unmodified, and B, W, R, the row weights and
    the inverses on ``B``'s device. Each block is prepared in the storage
    dtype (``prepare_block``), with ``col_center`` (d,) subtracted when
    given. ``overlap=False`` prepares, copies and updates one block at a
    time, waiting for each, to measure what the double buffer buys; the two
    give the same bits."""
    precision = solver_precision(precision)
    dtype = storage_dtype_of(storage_dtype)
    A = host_matrix(A_host)
    n, d = A.shape
    if B.shape[0] != n:
        raise ValueError(f"A rows ({n}) must match B rows ({B.shape[0]})")
    device, k = B.device, B.shape[1]
    center = None if col_center is None else torch.as_tensor(col_center, dtype=torch.float32).cpu()
    blocks = [(s, min(s + block_size, d)) for s in range(0, d, block_size)]
    nb = len(blocks)

    w_rows = None if row_weights is None else row_weights.to(dtype)
    W = [B.new_zeros((e - s, k)) for s, e in blocks]
    R = B.clone()
    invs: List[Optional[torch.Tensor]] = [None] * nb
    start_epoch = start_block = 0
    fingerprint = None
    if checkpoint_dir is not None:
        if isinstance(A, SparseBatch):
            a_probe = A.row_sum(0) + A.row_sum(n - 1)
        else:
            shift = 0.0 if center is None else 2.0 * float(center.sum())
            a_probe = float(A[0].sum() + A[-1].sum()) - shift
        fingerprint = _fingerprint(n, d, k, block_size, lam, row_weights is not None, dtype, a_probe, B)
        state = _latest_epoch(checkpoint_dir, fingerprint, device)
        if state is not None:
            start_epoch, W, R = state["epoch"], list(state["W"]), state["R"]
        snap_path = os.path.join(checkpoint_dir, SNAPSHOT)
        snap = _load(snap_path, fingerprint, device) if os.path.exists(snap_path) else None
        if snap is not None:
            epoch, block = snap["epoch"], snap["block"]
            if block >= nb:  # the snapshot landed on an epoch boundary
                epoch, block = epoch + 1, 0
            if (epoch, block) >= (start_epoch, 0):
                start_epoch, start_block = epoch, block
                W, R = list(snap["W"]), snap["R"]
                for i, inv in snap["invs"].items():
                    invs[int(i)] = inv
    visits = [
        (epoch, i)
        for epoch in range(start_epoch, num_iters)
        for i in range(start_block if epoch == start_epoch else 0, nb)
    ]

    timer = active()
    stager = HostStager(device, buffers=PREFETCH_DEPTH + 2, timed=timer is not None)

    def prep(i: int):
        s, e = blocks[i]
        return stager.fill((n, e - s), dtype, lambda out: prepare_block(A, center, s, e, out))

    src = PrefetchIterator((prep(i) for _, i in visits)) if overlap and visits else None
    times = []
    try:
        nxt = stager.upload(next(src)) if src is not None else None
        for j, (epoch, i) in enumerate(visits):
            if src is not None:
                cur = nxt
                stager.reclaim()
                if j + 1 < len(visits):
                    nxt = stager.upload(next(src))
            else:
                cur = stager.upload(prep(i))
            a_b = stager.ready(cur)
            first = invs[i] is None
            t0 = stamp(device)
            aw = _weighted(a_b, w_rows)
            if first:
                R, W[i], invs[i] = _first_update(a_b, aw, R, W[i], lam, precision)
            else:
                R, W[i] = _solve_update(a_b, aw, invs[i], R, W[i], precision)
            del aw  # a block's bytes, freed before the next block is allocated
            if timer is not None:
                times.append((epoch, i, first, cur._replace(tensor=None), t0, stamp(device)))
            if src is None:
                stager.reclaim()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            done = j + 1
            if (
                checkpoint_dir is not None and checkpoint_every > 0
                and done % checkpoint_every == 0 and done < len(visits)
            ):
                _save_snapshot(checkpoint_dir, fingerprint, epoch, i + 1, W, R, invs)
            if i == nb - 1:
                _end_epoch(epoch, R, W, lam, row_weights, checkpoint_dir, fingerprint)
    finally:
        stager.close()
        if src is not None:
            src.close()
    if timer is not None:
        note("streamed BCD blocks", lambda: _block_times(device, times))
    if checkpoint_dir is not None and os.path.exists(os.path.join(checkpoint_dir, SNAPSHOT)):
        os.unlink(os.path.join(checkpoint_dir, SNAPSHOT))
    return W, blocks


def _block_times(device, times) -> list:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return [
        {"epoch": epoch, "block": i, "first": first, "prep_ms": 1e3 * up.prep_s,
         "copy_ms": up.copy_ms(), "update_ms": 1e3 * elapsed_s(t0, t1)}
        for epoch, i, first, up, t0, t1 in times
    ]
