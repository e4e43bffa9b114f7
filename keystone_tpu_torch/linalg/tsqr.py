"""Ridge least squares through the QR factor of [A | B], on one device.

Counterpart of ``keystone_tpu/linalg/tsqr.py``: ``_solve_from_augmented_r``
(:55-69) and ``solve_least_squares_tsqr`` (:72-88). On one device the
reference's tree of local QRs is one ``torch.linalg.qr(mode="r")`` of the
whole augmented matrix (cuSOLVER's on the card). R is unique up to the
signs of its rows, and the solution does not depend on them. The sharded
``tsqr_r`` is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def qr_r(A: torch.Tensor) -> torch.Tensor:
    """The (d, d) R factor of an (n, d) A; zero rows complete it when
    n < d, as the reference pads each shard's R."""
    R = torch.linalg.qr(A, mode="r").R
    return F.pad(R, (0, 0, 0, A.shape[1] - R.shape[0]))


def _solve_from_augmented_r(r_aug: torch.Tensor, d: int, lam: float) -> torch.Tensor:
    """Given R of [A | B] and the ridge lam, solve min ‖AW − B‖² + lam‖W‖²:
    √lam·I stacked under [R11 | R12] (the ridge rows appended to A), the
    small system QR'd again, then R11' W = R12' solved."""
    k = r_aug.shape[1] - d
    eye = math.sqrt(lam) * torch.eye(d, dtype=r_aug.dtype, device=r_aug.device)
    bot = torch.cat([eye, torch.zeros((d, k), dtype=r_aug.dtype, device=r_aug.device)], dim=1)
    rr = torch.linalg.qr(torch.cat([r_aug[:d], bot], dim=0), mode="r").R
    return torch.linalg.solve_triangular(rr[:d, :d], rr[:d, d : d + k], upper=True)


def solve_least_squares_tsqr(A: torch.Tensor, B: torch.Tensor, lam: float = 0.0) -> torch.Tensor:
    """argmin_W ‖AW − B‖² + lam‖W‖² from the R of [A | B]: the condition
    number enters once (κ), not squared as in the normal equations."""
    if A.shape[0] != B.shape[0]:
        raise ValueError(f"A has {A.shape[0]} rows and B {B.shape[0]}")
    return _solve_from_augmented_r(qr_r(torch.cat([A, B.to(A.dtype)], dim=1)), A.shape[1], lam)
