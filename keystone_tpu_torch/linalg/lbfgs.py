"""L-BFGS with a zoom line search, on flat float32 tensors.

The port's counterpart of what ``keystone_tpu/nodes/learning/
logistic_regression.py`` runs through ``optax.lbfgs()`` (optax's defaults):

- memory 10: the last ten (s, y) pairs, s the step in x and y the step in
  the gradient, each weighted by ρ = 1/(sᵀy) (0 where sᵀy = 0), applied
  by the two-loop recursion;
- the initial inverse Hessian γI with γ = sᵀy / yᵀy of the newest pair (1
  where yᵀy = 0), and γ = min(1, 1/‖g‖) at the first step;
- a zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6, as
  optax's ``zoom_linesearch``): first trial step 1, doubled until an
  interval is found, then narrowed by cubic, quadratic or bisection
  steps, for at most 20 evaluations; accepted when the strong Wolfe
  conditions hold (c1 = 1e-4, c2 = 0.9) with optax's approximate form of
  the decrease condition (Hager and Zhang, relative tolerance 1e-6); when
  it runs out of evaluations or the interval shrinks below 1e-5, the best
  step seen that decreases enough, else the last one tried.

``minimize`` runs exactly ``max_iters`` steps, with no early stop, as the
reference's ``lax.scan`` does. Vectors stay on their device; each
evaluation reads two scalars (the value and the slope along the search
direction) on the host, where the line search decides. Decisions and
interpolations run in float64 on the host where optax's run in float32 on
the device, so the two take the same steps only while rounding does not
separate them: they agree near the optimum, not iterate by iterate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np
import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

MEMORY = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4  # c1, sufficient decrease
CURV_RTOL = 0.9  # c2, curvature
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0


@dataclass
class LbfgsResult:
    x: torch.Tensor
    value: float  # at x
    values: List[float] = field(default_factory=list)  # after each step
    evaluations: int = 0  # of value_and_grad, the first one included


def _cubicmin(a, fa, fpa, b, fb, c, fc) -> float:
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN where there is none."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = (np.float64(v) for v in (a, fa, fpa, b, fb, c, fc))
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1, r2 = fb - fa - fpa * db, fc - fa - fpa * dc
        A = (dc**2 * r1 - db**2 * r2) / denom
        B = (-(dc**3) * r1 + db**3 * r2) / denom
        return float(a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb) -> float:
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = (np.float64(v) for v in (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db**2)
        return float(a - fpa / (2.0 * B))


def _decrease_error(t, value, slope, value0, slope0) -> float:
    err = value - value0 - SLOPE_RTOL * t * slope0
    approx = max(slope - (2 * SLOPE_RTOL - 1.0) * slope0, value - value0 - APPROX_DEC_RTOL * abs(value0))
    err = max(min(approx, err), 0.0)
    return math.inf if math.isnan(err) else err


def _curvature_error(slope, slope0) -> float:
    err = max(abs(slope) - CURV_RTOL * abs(slope0), 0.0)
    return math.inf if math.isnan(err) else err


def zoom_linesearch(value_and_grad: ValueAndGrad, x, u, value0: float, grad0):
    """A step t along ``u`` from ``x``: (t, value, gradient at x + t·u,
    evaluations)."""
    slope0 = float(torch.dot(u, grad0))

    def at(t):
        v, g = value_and_grad(x + t * u)
        v, s = torch.stack([v.to(g.dtype), torch.dot(g, u)]).tolist()
        return v, g, s

    t, value, grad, slope = 0.0, value0, grad0, slope0
    low, value_low, slope_low = 0.0, value0, slope0
    high, value_high, slope_high = 0.0, value0, slope0
    cubic_ref, value_cubic_ref = 0.0, value0
    safe = (0.0, value0, grad0)
    interval_found = done = failed = False
    dec = math.inf
    count = 0
    while not (done or failed):
        if not interval_found:
            new = 1.0 if count == 0 else INCREASE_FACTOR * t
            v, g, s = at(new)
            dec = _decrease_error(new, v, s, value0, slope0)
            err = max(dec, _curvature_error(s, slope0))
            if dec <= 0.0:
                safe = (new, v, g)
            set_high = dec > 0.0 or (v >= value and count > 0)
            set_low = s >= 0.0 and not set_high
            if set_low:
                low, value_low, slope_low, high, value_high, slope_high = new, v, s, t, value, slope
            else:
                low, value_low, slope_low, high, value_high, slope_high = t, value, slope, new, v, s
            cubic_ref, value_cubic_ref = low, value_low
            interval_found = set_high or set_low or err <= 0.0
            done = err <= 0.0
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
            t, value, grad, slope = new, v, g, s
        else:
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            mid = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref, value_cubic_ref)
            if not left + 0.2 * delta < mid < right - 0.2 * delta:
                mid = _quadmin(low, value_low, slope_low, high, value_high)
                if not left + 0.1 * delta < mid < right - 0.1 * delta:
                    mid = (low + high) / 2.0
            v, g, s = at(mid)
            dec = _decrease_error(mid, v, s, value0, slope0)
            err = max(dec, _curvature_error(s, slope0))
            if dec <= 0.0 and v < safe[1]:
                safe = (mid, v, g)
            done = err <= 0.0
            high_to_mid = dec > 0.0 or v >= value_low
            high_to_low = s * (high - low) >= 0.0 and not high_to_mid
            if high_to_mid or high_to_low:
                cubic_ref, value_cubic_ref = high, value_high
            else:
                cubic_ref, value_cubic_ref = low, value_low
            if high_to_mid:
                high, value_high, slope_high = mid, v, s
            elif high_to_low:
                high, value_high, slope_high = low, value_low, slope_low
            if not high_to_mid:
                low, value_low, slope_low = mid, v, s
            failed = (count + 1 >= MAX_LINESEARCH_STEPS
                      or (delta <= INTERVAL_THRESHOLD and safe[0] > 0.0)) and not done
            t, value, grad, slope = mid, v, g, s
        count += 1
        if failed and (safe[0] > 0.0 or math.isinf(dec)):
            t, value, grad = safe
    return t, value, grad, count


def _two_loop(g, pairs, gamma):
    """H·g for the L-BFGS inverse Hessian of ``pairs`` [(s, y, ρ)], oldest
    first, on γI."""
    q = g.clone()
    alphas = []
    for s, y, rho in reversed(pairs):
        alpha = rho * torch.dot(s, q)
        q -= alpha * y
        alphas.append(alpha)
    q *= gamma
    for (s, y, rho), alpha in zip(pairs, reversed(alphas)):
        beta = rho * torch.dot(y, q)
        q += (alpha - beta) * s
    return q


def minimize(value_and_grad: ValueAndGrad, x0: torch.Tensor, max_iters: int) -> LbfgsResult:
    """``max_iters`` L-BFGS steps from ``x0`` (a flat tensor) on the
    function whose value (a 0-d tensor) and gradient ``value_and_grad``
    gives."""
    x = x0.clone()
    value, grad = value_and_grad(x)
    result = LbfgsResult(x, float(value), evaluations=1)
    value = result.value
    pairs: list = []
    prev_x = prev_g = None
    for _ in range(max_iters):
        if prev_x is None:
            gamma = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)
        else:
            s, y = x - prev_x, grad - prev_g
            sy, yy = torch.dot(y, s), torch.dot(y, y)
            rho = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
            pairs = [*pairs, (s, y, rho)][-MEMORY:]
        u = -_two_loop(grad, pairs, gamma)
        t, value, new_grad, evals = zoom_linesearch(value_and_grad, x, u, value, grad)
        prev_x, prev_g = x, grad
        x, grad = x + t * u, new_grad
        result.values.append(value)
        result.evaluations += evals
    result.x, result.value = x, value
    return result
