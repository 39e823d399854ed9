"""Parity of the port's tricubic field model (ionotomo_tpu_torch.core.
tricubic, the plain PyTorch versions of kernels K2, K5 and K5ᵀ on the CPU)
with the JAX package's ``core.tricubic`` on the same numpy-seeded inputs.

Grids are small (≤ 14 samples an axis, unequal axes and spacings); the
point sets include points outside the grid, on lattice points and in the
boundary cells, where the index clamp repeats rows and taps. Every test
draws from its own ``np.random.default_rng(seed)``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import tricubic as ttri
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

SHAPE = (9, 12, 14)
ORIGIN = (-40.0, -30.0, 0.0)
SPACING = (10.0, 5.0, 80.0)


def _case(seed, n=3000):
    """(JAX grid, port grid, field (numpy), points (numpy), rng)."""
    rng = np.random.default_rng(seed)
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    tg = convert.grid_from_numpy(jg, device="cpu")
    field = rng.normal(size=SHAPE).astype(np.float32)
    pts = edge_case_points(SHAPE, ORIGIN, SPACING, n, rng)
    return jg, tg, field, pts, rng


@pytest.mark.parametrize("fn", ["_catmull_rom_weights",
                                "_catmull_rom_dweights"])
def test_catmull_rom_weights_match_jax(fn):
    """The four weights (or their derivatives) at offsets in [0, 1], the
    ends included. Tolerance 1e-6 absolute (weights are O(1))."""
    u = np.concatenate([np.random.default_rng(0).uniform(0, 1, 500),
                        [0.0, 1.0, 0.5]]).astype(np.float32)
    want = np.asarray(getattr(jtri, fn)(jnp.asarray(u)))
    got = getattr(ttri, fn)(torch.from_numpy(u)).numpy()
    assert got.shape == (503, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_weights_partition_unity_and_their_derivatives_sum_to_zero():
    u = torch.linspace(0, 1, 101)
    np.testing.assert_allclose(ttri._catmull_rom_weights(u).sum(-1).numpy(),
                               1.0, atol=1e-6)
    np.testing.assert_allclose(ttri._catmull_rom_dweights(u).sum(-1).numpy(),
                               0.0, atol=1e-6)


def test_neighborhood_matches_jax_inside_outside_and_on_lattice_points():
    """Indices equal exactly; fractions to 1e-6 (one division each)."""
    jg, tg, _, pts, _ = _case(1)
    jidx, jfrac = jtri._neighborhood(jg, jnp.asarray(pts))
    tidx, tfrac = ttri._neighborhood(tg, torch.from_numpy(pts))
    assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (len(pts), 3, 4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tfrac.numpy(), np.asarray(jfrac), rtol=0,
                               atol=1e-6)
    assert tfrac.min() >= 0.0 and tfrac.max() <= 1.0
    n = np.asarray(SHAPE)[None, :, None]
    assert (tidx.numpy() >= 0).all() and (tidx.numpy() <= n - 1).all()
    _, _, jri = jtri._row_neighborhood(jg, jnp.asarray(pts))
    _, _, tri = ttri._row_neighborhood(tg, torch.from_numpy(pts))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jri))


def test_interp_rows_matches_jax():
    """Value through ``rows_value`` (K=16, L=4, z first). Tolerance
    1e-5·max|field|."""
    jg, tg, field, pts, _ = _case(2)
    f2d = field.reshape(-1, SHAPE[2])
    want = np.asarray(jtri.interp_rows(jnp.asarray(f2d), jg,
                                       jnp.asarray(pts)))
    got = ttri.interp_rows(torch.from_numpy(f2d), tg,
                           torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(field).max())


def test_interp_rows_with_grad_matches_jax():
    """Value to 1e-5·max|field|, physical gradient to 1e-5·max|field| over
    the smallest spacing. The dispatching function is the plain version
    on CPU tensors."""
    jg, tg, field, pts, _ = _case(3)
    f2d = field.reshape(-1, SHAPE[2])
    jv, jgr = jtri.interp_rows_with_grad(jnp.asarray(f2d), jg,
                                         jnp.asarray(pts))
    tv, tgr = ttri.interp_rows_with_grad(torch.from_numpy(f2d), tg,
                                         torch.from_numpy(pts))
    tol = 1e-5 * np.abs(field).max()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / min(SPACING))
    rv, rgr = ttri.interp_rows_with_grad_ref(torch.from_numpy(f2d), tg,
                                             torch.from_numpy(pts))
    assert torch.equal(tv, rv) and torch.equal(tgr, rgr)


def test_block_gather_forms_match_jax():
    """``interp`` and ``interp_with_grad`` over the 3-D field. Tolerance
    1e-5·max|field| (over min spacing for the gradient)."""
    jg, tg, field, pts, _ = _case(4)
    tol = 1e-5 * np.abs(field).max()
    want = np.asarray(jtri.interp(jnp.asarray(field), jg, jnp.asarray(pts)))
    got = ttri.interp(torch.from_numpy(field), tg, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    jv, jgr = jtri.interp_with_grad(jnp.asarray(field), jg, jnp.asarray(pts))
    tv, tgr = ttri.interp_with_grad(torch.from_numpy(field), tg,
                                    torch.from_numpy(pts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / min(SPACING))


def test_interp_weights_match_jax_and_reproduce_interp():
    jg, tg, field, pts, _ = _case(5, n=800)
    jidx, jw = jtri.interp_weights(jg, jnp.asarray(pts))
    tidx, tw = ttri.interp_weights(tg, torch.from_numpy(pts))
    assert tuple(tidx.shape) == tuple(tw.shape) == (len(pts), 64)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    f = torch.from_numpy(field)
    via_weights = (f.reshape(-1)[tidx.long()] * tw).sum(-1)
    direct = ttri.interp(f, tg, torch.from_numpy(pts))
    np.testing.assert_allclose(via_weights.numpy(), direct.numpy(), rtol=0,
                               atol=1e-5 * np.abs(field).max())


def test_value_grad_transpose_ref_matches_jax_vjp():
    """The plain version of K5ᵀ against ``jax.vjp`` of the reference's
    ``interp_rows_with_grad`` with respect to the table: 1e-5·max|out|;
    and the adjoint identity ⟨E t, c⟩ = ⟨t, Eᵀ c⟩ to 1e-4 relative."""
    jg, tg, field, pts, rng = _case(6)
    n = len(pts)
    f2d = field.reshape(-1, SHAPE[2])
    cv = rng.normal(size=(n,)).astype(np.float32)
    cg = rng.normal(size=(n, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jtri.interp_rows_with_grad(
        t, jg, jnp.asarray(pts)), jnp.asarray(f2d))
    (want,) = vjp((jnp.asarray(cv), jnp.asarray(cg)))
    want = np.asarray(want)
    tp, tcv, tcg = (torch.from_numpy(a) for a in (pts, cv, cg))
    got = ttri.interp_rows_with_grad_transpose(tg, tp, tcv, tcg)
    assert tuple(got.shape) == f2d.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(got, ttri.interp_rows_with_grad_transpose_ref(
        tg, tp, tcv, tcg))
    v, g = ttri.interp_rows_with_grad(torch.from_numpy(f2d), tg, tp)
    lhs = float((v.double() * tcv.double()).sum()
                + (g.double() * tcg.double()).sum())
    rhs = float((got.double() * torch.from_numpy(f2d).double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


def test_rows_value_transpose_on_the_cubic_setup_matches_jax_vjp():
    """K3's plain version on ``row_setup``'s arrays is the transpose of
    the reference's ``interp_rows``: 1e-5·max|out|."""
    jg, tg, field, pts, rng = _case(7)
    ct = rng.normal(size=(len(pts),)).astype(np.float32)
    f2d = field.reshape(-1, SHAPE[2])
    _, vjp = jax.vjp(lambda t: jtri.interp_rows(t, jg, jnp.asarray(pts)),
                     jnp.asarray(f2d))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    ri, wxy, zi, wz = ttri.row_setup(tg, torch.from_numpy(pts))
    got = ttri.rows_value_transpose(torch.from_numpy(ct), ri, wxy, zi, wz,
                                    f2d.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_cubic_plans_cover_every_pair_and_sort_each_tap_within_a_row():
    """``row_plan`` and ``endpoint_plan`` hold all 16 pairs of every point
    once; within a row every one of the 4 z taps is non-decreasing in
    plan order (the key is the unclamped cell base, so the kernels'
    in-warp scan applies at the clamped bottom and top edges too)."""
    _, tg, _, pts, _ = _case(8, n=2000)
    tp = torch.from_numpy(pts)
    ri, _, zi, _ = ttri.row_setup(tg, tp)
    n_rows = SHAPE[0] * SHAPE[1]
    for plan in (ttri.row_plan(ri, zi, n_rows), ttri.endpoint_plan(tg, tp)):
        assert plan.live == plan.stride == 16 and plan.stream is None
        order = plan.order.numpy()
        assert sorted(order.tolist()) == list(range(16 * len(pts)))
        rows = ri.reshape(-1).numpy()[order]
        assert (np.diff(rows) >= 0).all()
        taps = zi.numpy()[order // 16]                     # (P, 4)
        same_row = np.diff(rows) == 0
        assert (np.diff(taps, axis=0)[same_row] >= 0).all()
        np.testing.assert_array_equal(
            np.diff(plan.offsets.numpy()),
            np.bincount(rows, minlength=n_rows))


def test_constant_field_is_reproduced_with_zero_gradient_everywhere():
    """Outside the grid too (constant extrapolation)."""
    _, tg, _, pts, _ = _case(9, n=500)
    f2d = torch.full((SHAPE[0] * SHAPE[1], SHAPE[2]), 2.5)
    v, g = ttri.interp_rows_with_grad(f2d, tg, torch.from_numpy(pts))
    np.testing.assert_allclose(v.numpy(), 2.5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-5)


def test_probe_rowgather_chain_matches_the_reference_probe():
    """The gather probe's baseline (``bench/probe_gather.py``): chained
    value + gradient evaluations, each moving the points along the
    normalised gradient. Positions after 4 steps within 1e-3 km."""
    from ionotomo_tpu_torch.probes import gather

    jg, tg, field, pts, _ = _case(10, n=400)
    f2d = field.reshape(-1, SHAPE[2])
    p = jnp.asarray(pts)
    for _ in range(4):
        v, g = jtri.interp_rows_with_grad(jnp.asarray(f2d), jg, p)
        gn = g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-12)
        p = p + 0.5 * gn + 1e-6 * v[:, None]
    got = gather.rowgather_chain(torch.from_numpy(f2d), tg,
                                 torch.from_numpy(pts), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(p), rtol=0, atol=1e-3)
    assert gather.rowgather_baseline(nx=8, n_pts=32, n_steps=2,
                                     device="cpu") > 0
