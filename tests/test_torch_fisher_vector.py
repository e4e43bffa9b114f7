"""The port's Fisher-vector encoding held against the JAX package.

Same numpy inputs through the JAX Pallas kernel (interpreter mode on the
CPU, as tests/test_pallas_ops.py runs it), the JAX einsum twin ``_fv_tpu``,
and the port's plain version and ``FisherVector(device="cpu")``, at the
tolerance tests/test_pallas_ops.py uses (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.nodes.images.external.fisher_vector import _fv_tpu
from keystone_tpu.ops import fisher_vectors_pallas
from keystone_tpu_torch.nodes.images.external.fisher_vector import FisherVector
from keystone_tpu_torch.ops.fisher_vector import (
    centred_statistics,
    fisher_vectors,
    fisher_vectors_plain,
    fv_operands,
    split_plan,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _gmm(rng, k, d, zero_component=False):
    w = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    if zero_component:
        w[-1] = 0.0
    w /= w.sum()
    mu = rng.normal(size=(k, d)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=(k, d)).astype(np.float32)
    return w, mu, var


def _port(X, w, mu, var):
    t = [torch.from_numpy(a) for a in (X, w, mu, var)]
    plain = fisher_vectors_plain(*t).numpy()
    node = FisherVector(w, mu, var, device="cpu")(t[0]).numpy()
    return plain, node


@pytest.mark.parametrize(
    "B, m, k, d, zero_component",
    [
        (2, 300, 4, 8, False),  # m not a multiple of the 256-row tile: mask path
        (2, 40, 3, 4, True),  # a starved component: finite, no NaN
        (1, 57, 5, 8, False),  # one image
    ],
    ids=["ragged-m", "zero-weight", "B1"],
)
def test_port_fv_matches_jax(B, m, k, d, zero_component):
    rng = np.random.default_rng(B * 1000 + m)
    w, mu, var = _gmm(rng, k, d, zero_component)
    X = rng.normal(size=(B, m, d)).astype(np.float32)
    ref_pallas = np.asarray(fisher_vectors_pallas(X, w, mu, var))
    ref_xla = np.asarray(
        _fv_tpu(jnp.asarray(X), jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))
    )
    plain, node = _port(X, w, mu, var)
    assert plain.shape == node.shape == (B, 2 * k * d)
    assert np.isfinite(plain).all()
    for got in (plain, node):
        np.testing.assert_allclose(got, ref_pallas, **TOL)
        np.testing.assert_allclose(got, ref_xla, **TOL)


def test_fisher_vectors_rejects_other_devices():
    rng = np.random.default_rng(0)
    w, mu, var = _gmm(rng, 3, 4)
    ops = fv_operands(*(torch.from_numpy(a) for a in (w, mu, var)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fisher_vectors(torch.empty((1, 5, 4), device="meta"), ops)


@pytest.mark.parametrize("B", [1, 3, 16, 64])
def test_split_plan_covers_every_row_once(B):
    m, tile, sms = 3721, 32, 132
    S, rows = split_plan(B, m, tile, sms)
    # Whole tiles, at least two a split, so that a block's constant load
    # and partial write are spread over enough rows.
    assert rows % tile == 0 and rows >= 2 * tile
    # Every split has rows, and the splits tile [0, m) exactly once.
    assert (S - 1) * rows < m <= S * rows
    # The B·S blocks (one resident per SM) fit in one wave ...
    assert B * S <= sms
    # ... and a one-image request still spreads over a third of the SMs or
    # more.
    if B == 1:
        assert S >= sms // 3


# The kernel's arithmetic, emulated on the CPU: TF32 keeps 10 mantissa bits,
# and a 3xTF32 product of float32 operands is hi·hi + hi·lo + lo·hi with
# hi = v rounded to TF32 (to nearest, ties away from zero: the kernel's
# to_tf32) and lo = v - hi cut to TF32 toward zero (the kernel's split).
# Each partial product of two TF32 values is exact in float32, so float32
# matmuls of the parts emulate the tensor cores' logits up to the order of
# the float32 sums. The statistics are float32 on the CUDA cores.


def _round_tf32(v):
    return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _cut_tf32(v):
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b, passes):
    if passes == 1:
        return _round_tf32(a) @ _round_tf32(b)
    a_hi, b_hi = _round_tf32(a), _round_tf32(b)
    a_lo, b_lo = _cut_tf32(a - a_hi), _cut_tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _fv_tensor_core(X, ops, passes):
    """The kernel's arithmetic on the kernel's operands (``fv_operands``):
    logits = bias + [x² | x]·W', W' = -½ [inv_t ; m2_t], on the tensor
    cores; then the centred statistics in float32 on the CUDA cores and the
    reduce kernel's scalings."""
    B, m, d = X.shape
    W = torch.cat([-0.5 * ops.inv_t, -0.5 * ops.m2_t])
    r = torch.softmax(ops.bias + _split_matmul(torch.cat([X * X, X], -1), W, passes), -1)
    g1, c2 = centred_statistics(r, X, ops.means)
    rs = r.sum(1)[..., None]
    gmu = g1 / ops.sigma
    gvar = c2 * ops.inv - rs
    cm = 1.0 / (m * torch.sqrt(ops.w_floor))[:, None]
    cv = 1.0 / (m * torch.sqrt(2.0 * ops.w_floor))[:, None]
    return torch.cat([(gmu * cm).reshape(B, -1), (gvar * cv).reshape(B, -1)], -1)


def _full_width_case(near_floor):
    """d=64, k=256, two images of 300 descriptors drawn from the GMM. Near
    the floor, variances are uniform in 1e-4..1e-3 (a fitted GMM's regime,
    where the quadratic form's terms reach ~10³) and the means sit a few
    standard deviations apart, where float32 itself still meets the
    tolerance against float64."""
    rng = np.random.default_rng(7 if near_floor else 8)
    k, d = 256, 64
    w = rng.uniform(0.1, 1.0, size=k)
    w /= w.sum()
    mu = (0.05 if near_floor else 0.5) * rng.normal(size=(k, d))
    var = rng.uniform(*((1e-4, 1e-3) if near_floor else (0.5, 1.5)), size=(k, d))
    z = rng.integers(0, k, size=(2, 300))
    X = mu[z] + np.sqrt(var[z]) * rng.normal(size=(2, 300, d))
    return [a.astype(np.float32) for a in (X, w, mu, var)]


def _within(got, want):
    return bool((np.abs(got - want) <= TOL["atol"] + TOL["rtol"] * np.abs(want)).all())


@pytest.mark.parametrize("near_floor", [True, False], ids=["near-floor-var", "unit-var"])
def test_3xtf32_products_keep_float32_accuracy(near_floor):
    X, w, mu, var = _full_width_case(near_floor)
    t = [torch.from_numpy(a) for a in (X, w, mu, var)]
    got = _fv_tensor_core(t[0], fv_operands(*t[1:]), passes=3).numpy()
    f32 = fisher_vectors_plain(*t).numpy()
    f64 = fisher_vectors_plain(*(a.double() for a in t)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, f32, **TOL)
    np.testing.assert_allclose(got, f64, **TOL)


def test_single_tf32_misses_the_tolerance():
    """Unit variances spread the responsibilities over several components,
    so the logits' rounding shows: single TF32 misses, 3xTF32 does not."""
    X, w, mu, var = _full_width_case(near_floor=False)
    t = [torch.from_numpy(a) for a in (X, w, mu, var)]
    one = _fv_tensor_core(t[0], fv_operands(*t[1:]), passes=1).numpy()
    f32 = fisher_vectors_plain(*t).numpy()
    assert _within(_fv_tensor_core(t[0], fv_operands(*t[1:]), passes=3).numpy(), f32)
    assert not _within(one, f32)


def _at_floor_case():
    """VOCSIFTFisher's mixture shape (d 64, k 16), every variance at the
    1e-4 floor and means of scale 0.5, with two images of 841 descriptors
    drawn from it: a component sits 50 standard deviations from 0 in each
    feature, as components of a GMM fitted to real descriptors do."""
    rng = np.random.default_rng(9)
    k, d = 16, 64
    w = rng.uniform(0.1, 1.0, size=k)
    w /= w.sum()
    mu = 0.5 * rng.normal(size=(k, d))
    var = np.full((k, d), 1e-4)
    z = rng.integers(0, k, size=(2, 841))
    X = mu[z] + np.sqrt(var[z]) * rng.normal(size=(2, 841, d))
    return [a.astype(np.float32) for a in (X, w, mu, var)]


def test_centred_statistics_hold_at_the_variance_floor():
    """The kernel's arithmetic and the plain version stay within TOL of
    float64 at the floor, where the reference's expanded forms (``_fv_tpu``,
    float32) do not: the terms of rᵀx² − 2μ rᵀx + rs μ² are ~10⁴ times the
    centred sum."""
    X, w, mu, var = _at_floor_case()
    t = [torch.from_numpy(a) for a in (X, w, mu, var)]
    f64 = fisher_vectors_plain(*(a.double() for a in t)).numpy()
    got = _fv_tensor_core(t[0], fv_operands(*t[1:]), passes=3).numpy()
    plain = fisher_vectors_plain(*t).numpy()
    expanded = np.asarray(
        _fv_tpu(jnp.asarray(X), jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))
    )
    np.testing.assert_allclose(got, f64, **TOL)
    np.testing.assert_allclose(plain, f64, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)
    assert not _within(expanded, f64)
