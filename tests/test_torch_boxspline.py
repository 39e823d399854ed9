"""Parity of the port's zp box spline (ionotomo_tpu_torch.core.boxspline,
plain PyTorch versions on the CPU) with the JAX package on the same
numpy-seeded inputs.

Both sides compute in f32 on the CPU; they differ only in summation
order (BLAS vs XLA dots) and in exp/log implementations, so each bound
is a few f32 ulps of the largest term, stated per test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import boxspline as jbox
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox

torch.set_num_threads(2)

# Dyadic origin and spacings: lattice, half-lattice and u±v=0 points are
# then exact in f32 and both packages see the same fractional index.
SHAPE = (12, 10, 16)
ORIGIN = (-1.0, 0.5, 2.0)
SPACING = (0.5, 0.25, 0.125)


def _grids():
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    return jg, convert.grid_from_numpy(jg, device="cpu")


def edge_case_points(n_random=200, seed=0):
    """Index-space points: random (inside and outside the grid), exactly
    on lattice points, on half-lattice ties, on u+v=0 and u−v=0, and in
    the boundary cells; mapped to world coordinates."""
    rng = np.random.default_rng(seed)
    n = np.asarray(SHAPE, np.float64)
    t = [rng.uniform(-3.0, n + 2.0, (n_random, 3)),          # in and out
         rng.integers(0, n, (40, 3)).astype(np.float64),     # lattice
         rng.integers(0, n - 1, (40, 3)) + 0.5]              # ties
    for a in (0.25, 0.375, -0.25):
        base = rng.integers(1, n - 1, (20, 3)).astype(np.float64)
        t.append(base + np.array([a, a, 0.5 * a]))           # u−v = 0
        t.append(base + np.array([a, -a, -0.5 * a]))         # u+v = 0
    t.append(np.array([[0.0, 0.0, 0.0], [0.2, 0.3, 0.1],
                       [n[0] - 1, n[1] - 1, n[2] - 1],
                       [n[0] - 1.2, n[1] - 1.3, n[2] - 1.1],
                       [-0.5, n[1] - 0.5, 0.5]]))             # boundary
    t = np.concatenate(t, 0)
    pts = np.asarray(ORIGIN) + t * np.asarray(SPACING)
    return pts.astype(np.float32)


@pytest.mark.parametrize("order", [2, 4])
def test_prefilter_matches_jax(order):
    """Prefilter on a non-cubic grid: one nz×nz matmul plus `order`
    edge-replicated stencil passes. Tolerance 4e-6·max|f| (measured
    8e-7): the z matmul sums 16 terms of a dense inverse in another
    order, and the stencil passes carry that on."""
    f = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(jbox.prefilter(jnp.asarray(f), order))
    got = tbox.prefilter(torch.from_numpy(f), order).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4e-6 * np.abs(f).max())


def test_apply_a_xy_is_edge_replicated():
    f = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(jbox._apply_a_xy(jnp.asarray(f)))
    got = tbox._apply_a_xy(torch.from_numpy(f)).numpy()
    # products by 1/2 and 1/8 are exact and the sum order is the same
    np.testing.assert_array_equal(got, want)


def test_neighborhood_and_weights_match_jax():
    """Rounding (half to even), clamp order and piece selection agree
    exactly on ties, lattice points and u±v=0; weights to f32 rounding."""
    jg, tg = _grids()
    pts = edge_case_points()
    jn = jbox._neighborhood(jg, jnp.asarray(pts))
    tn = tbox._neighborhood(tg, torch.from_numpy(pts))
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jw = jbox._xy_weights(jn[3], jn[4], with_grad=True)
    tw = tbox._xy_weights(tn[3], tn[4], with_grad=True)
    for a, b in zip(jw[:2], tw[:2]):                      # offsets
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jw[2:], tw[2:]):                      # weights
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def test_interp_rows_matches_jax():
    """Value path (the K2 route on the card). Tolerance 5e-7·max|coef|
    (measured 5e-8): 21 weighted taps summed in another order."""
    jg, tg = _grids()
    f = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    coef = np.array(jbox.prefilter(jnp.asarray(f)))
    table = coef.reshape(-1, SHAPE[2])
    pts = edge_case_points(seed=3)
    want = np.asarray(jbox.interp_rows(jnp.asarray(table), jg,
                                       jnp.asarray(pts)))
    got = tbox.interp_rows(torch.from_numpy(table), tg,
                           torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-7 * np.abs(coef).max())
    got3 = tbox.interp(torch.from_numpy(coef), tg,
                       torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got3, got)


def test_interp_rows_with_grad_matches_jax():
    """Value + physical gradient (the K1e route on the card). Tolerance
    5e-7·max|coef| for the value (measured 5e-8), that over the smallest
    spacing for the gradient (measured 1e-7)."""
    jg, tg = _grids()
    f = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    coef = np.array(jbox.prefilter(jnp.asarray(f)))
    table = coef.reshape(-1, SHAPE[2])
    pts = edge_case_points(seed=4)
    jv, jgr = jbox.interp_rows_with_grad(jnp.asarray(table), jg,
                                         jnp.asarray(pts))
    tv, tgr = tbox.interp_rows_with_grad(torch.from_numpy(table), tg,
                                         torch.from_numpy(pts))
    tol = 5e-7 * np.abs(coef).max()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / min(SPACING))
    # the CPU dispatch is the plain version itself
    rv, rg = tbox.interp_rows_with_grad_ref(torch.from_numpy(table), tg,
                                            torch.from_numpy(pts))
    np.testing.assert_array_equal(rv.numpy(), tv.numpy())
    np.testing.assert_array_equal(rg.numpy(), tgr.numpy())


@pytest.mark.parametrize("spec", ["zp", "zp2", "zp4", "zp7", "zp1", "zpx",
                                  "cubic"])
def test_zp_order_grammar_matches_jax(spec):
    try:
        want = jbox.zp_order(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tbox.zp_order(spec)
    else:
        assert tbox.zp_order(spec) == want


def test_matches_f64_oracle():
    """Against the independent f64 oracle (exact area integrals, no
    tables), with the bounds the JAX package's own oracle test uses:
    1e-5 on the coefficients, 5e-6 on values, 5e-4 on gradients."""
    from reference_kernels import boxspline_ref
    _, tg = _grids()
    rng = np.random.default_rng(5)
    f = rng.normal(size=SHAPE).astype(np.float32)
    coef = tbox.prefilter(torch.from_numpy(f))
    coef_ref = boxspline_ref.prefilter_ref(f)
    np.testing.assert_allclose(coef.numpy(), coef_ref, atol=1e-5)
    lo = np.asarray(ORIGIN) + 2 * np.asarray(SPACING)
    hi = (np.asarray(ORIGIN)
          + (np.asarray(SHAPE) - 3) * np.asarray(SPACING))
    pts = rng.uniform(lo, hi, (120, 3)).astype(np.float32)
    v, g = tbox.interp_with_grad(coef, tg, torch.from_numpy(pts))
    rv, rg = boxspline_ref.interp_grad_ref(
        coef_ref, np.asarray(ORIGIN), np.asarray(SPACING), pts)
    np.testing.assert_allclose(v.numpy(), rv, atol=5e-6)
    np.testing.assert_allclose(g.numpy(), rg, atol=5e-4)
