"""Parity of the port's zpc field model (ionotomo_tpu_torch.core.zpcubic:
the ZP box spline in x, y and the Catmull-Rom cubic in z) with the JAX
package's ``core.zpcubic`` on the same numpy-seeded 16³ tables and
points, and with the f64 oracle ``reference_kernels/zpcubic_ref.py``.

The plain versions here are what kernels K6z (value + gradient), K6zᵀ
(its transpose, added into a table) and K1z (the tracer's evaluator, over
K1c's z-tap pack) are held to on the card.

Tolerances: values 5e-7·max|coef|, gradients that over the smallest
spacing (f32 sums in another order, as
``test_torch_endpoint_eval.py``); the transpose 1e-6·max|out| against
``jax.vjp``; the prefilter bitwise (the same adds in the same order);
against the oracle ``tests/test_zpcubic.py``'s bounds (2e-5 values,
2e-4 gradients, 1e-5 coefficients).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import zpcubic as jzpc
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import tricubic as ttri, zpcubic as tzpc
from ionotomo_tpu_torch.testing import edge_case_points
from reference_kernels import zpcubic_ref

torch.set_num_threads(2)

SHAPE = (16, 16, 16)
ORIGIN = (-1.0, 0.5, 2.0)
SPACING = (0.5, 0.25, 0.125)
KINDS = pytest.mark.parametrize("kind", ["random", "edge_case"])


@pytest.fixture(scope="module")
def world():
    """A random field, its zpc table from the JAX prefilter, the JAX and
    port grids and two point sets: uniform inside, and the edge cases
    (outside the grid, on lattice and half-lattice points, on u±v = 0, in
    the boundary cells)."""
    rng = np.random.default_rng(61)
    field = rng.normal(size=SHAPE).astype(np.float32)
    coef = np.array(jzpc.prefilter(jnp.asarray(field)))
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    pts = {"random": (np.asarray(ORIGIN) + rng.uniform(0, 1, (600, 3)) * hi
                      ).astype(np.float32),
           "edge_case": edge_case_points(SHAPE, ORIGIN, SPACING, 1600, rng)}
    return dict(field=field, coef2d=coef.reshape(-1, SHAPE[2]), jg=jg,
                tg=convert.grid_from_numpy(jg, device="cpu"), pts=pts,
                cmax=float(np.abs(coef).max()), rng=rng)


@pytest.mark.parametrize("spec", ["zpc", "zpc2", "zpc3", "zpc11", "zpc1",
                                  "zpc0", "zpcx", "zpc-2", "zp", "cubic"])
def test_zpc_order_grammar_matches_jax(spec):
    try:
        want = jzpc.zpc_order(spec)
    except ValueError:
        with pytest.raises(ValueError, match="unknown zpc interp spec"):
            tzpc.zpc_order(spec)
        return
    assert tzpc.zpc_order(spec) == want


@pytest.mark.parametrize("order", [2, 3])
def test_prefilter_matches_jax_and_its_transpose(world, order):
    """P bitwise the reference's; Pᵀ bitwise ``jax.linear_transpose`` of
    it up to f32 rounding (1e-6·max)."""
    f = world["field"]
    want = np.asarray(jzpc.prefilter(jnp.asarray(f), order))
    got = tzpc.prefilter(torch.from_numpy(f), order).numpy()
    np.testing.assert_array_equal(got, want)
    ct = world["rng"].normal(size=SHAPE).astype(np.float32)
    (want_t,) = jax.linear_transpose(lambda x: jzpc.prefilter(x, order),
                                     jnp.asarray(f))(jnp.asarray(ct))
    got_t = tzpc.prefilter_transpose(torch.from_numpy(ct), order).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=0,
                               atol=1e-6 * np.abs(want_t).max())


@KINDS
def test_interp_rows_matches_jax(world, kind):
    """The value gather (K2 at K=8, L=4, xy first on the card)."""
    pts = world["pts"][kind]
    want = np.asarray(jzpc.interp_rows(jnp.asarray(world["coef2d"]),
                                       world["jg"], jnp.asarray(pts)))
    got = tzpc.interp_rows(torch.from_numpy(world["coef2d"]), world["tg"],
                           torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7 * world["cmax"])


@KINDS
def test_interp_rows_with_grad_ref_matches_jax(world, kind):
    """K6z's plain version, and its twin in the kernels' order (the merged
    z weights at the clamped bottom and top bases included), against the
    reference's ``interp_rows_with_grad``."""
    pts = world["pts"][kind]
    jv, jgr = jzpc.interp_rows_with_grad(jnp.asarray(world["coef2d"]),
                                         world["jg"], jnp.asarray(pts))
    table = torch.from_numpy(world["coef2d"])
    tol = 5e-7 * world["cmax"]
    for fn in (tzpc.interp_rows_with_grad_ref,
               tzpc.interp_rows_with_grad_taps_ref):
        v, g = fn(table, world["tg"], torch.from_numpy(pts))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=0,
                                   atol=tol / min(SPACING))


def test_packed_evaluator_is_the_taps_twin_bitwise(world):
    """K1z's evaluator over K1c's z-tap pack reads the very taps the
    unpacked twin gathers (zpc's z stencil is the tricubic one, clamped
    at both ends), so the two agree bit for bit, at the bottom and top
    cell bases too."""
    pts = torch.from_numpy(world["pts"]["edge_case"])
    table = torch.from_numpy(world["coef2d"])
    packed = ttri.pack_z_taps_ref(table)
    zi = tzpc._neighborhood(world["tg"], pts)[4]
    assert bool((zi[:, 1] == 0).any()) and bool(
        (zi[:, 1] == SHAPE[2] - 2).any())
    got = tzpc.interp_rows_with_grad_packed_ref(packed, world["tg"], pts)
    want = tzpc.interp_rows_with_grad_taps_ref(table, world["tg"], pts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_merged_z_weights_are_the_dense_band():
    """At the clamped bases the merged weights put on each lane exactly
    what ``_z_band`` puts there."""
    fz = torch.linspace(0, 1, 9)
    for base, nz in ((0, 6), (4, 6), (2, 6)):
        zi = torch.clamp(base + torch.arange(-1, 3, dtype=torch.int32),
                         0, nz - 1).expand(9, 4).contiguous()
        w = ttri._catmull_rom_weights(fz)
        merged = tzpc._merged_z_weights(zi, w)
        assert torch.equal(ttri._z_band(zi, merged, nz),
                           ttri._z_band(zi, w, nz))


@KINDS
def test_transpose_matches_jax_vjp(world, kind):
    """K6zᵀ's plain version against ``jax.vjp`` of the reference's
    ``interp_rows_with_grad`` with respect to the table; the in-place add
    on the CPU is table + that."""
    pts = world["pts"][kind]
    rng = np.random.default_rng(7)
    cv = rng.normal(size=pts.shape[0]).astype(np.float32)
    cg = rng.normal(size=pts.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jzpc.interp_rows_with_grad(
        t, world["jg"], jnp.asarray(pts)), jnp.asarray(world["coef2d"]))
    (want,) = vjp((jnp.asarray(cv), jnp.asarray(cg)))
    args = (world["tg"], torch.from_numpy(pts), torch.from_numpy(cv),
            torch.from_numpy(cg))
    got = tzpc.interp_rows_with_grad_transpose_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(want).max())
    table = torch.from_numpy(world["coef2d"]).clone()
    assert torch.equal(
        tzpc.interp_rows_with_grad_transpose_add_(table.clone(), *args),
        table + got)


def test_plans_hold_the_live_translates(world):
    """The K3 plan and the K6zᵀ plan of occupied rows: 7 live translates
    of 8 a point, within a row sorted by the cell base zi[:, 1]."""
    pts = torch.from_numpy(world["pts"]["edge_case"])
    ri, _, zi, _ = tzpc.row_setup(world["tg"], pts)
    n_rows = SHAPE[0] * SHAPE[1]
    for plan in (tzpc.row_plan(ri, zi, n_rows),
                 tzpc.endpoint_plan(world["tg"], pts)):
        assert (plan.live, plan.stride) == (7, 8)
        ids = plan.order.long()
        assert int(plan.offsets[-1]) == 7 * pts.shape[0]
        assert bool(((ids % 8) < 7).all())
        key = ri.reshape(-1)[ids].long() * 64 + zi[ids // 8, 1].long()
        assert bool((key[1:] >= key[:-1]).all())
    assert plan.z0_range is not None


def test_matches_f64_oracle(world):
    """Prefilter, value and gradient against the f64 oracle at interior
    points, within ``tests/test_zpcubic.py``'s bounds."""
    rng = np.random.default_rng(11)
    f = world["field"]
    coef = tzpc.prefilter(torch.from_numpy(f))
    coef_ref = zpcubic_ref.prefilter_ref(f)
    np.testing.assert_allclose(coef.numpy(), coef_ref, atol=1e-5)
    lo = np.asarray(ORIGIN) + 2.0 * np.asarray(SPACING)
    hi = (np.asarray(ORIGIN)
          + (np.asarray(SHAPE) - 3.0) * np.asarray(SPACING))
    pts = rng.uniform(lo, hi, (60, 3)).astype(np.float32)
    v = tzpc.interp(coef, world["tg"], torch.from_numpy(pts)).numpy()
    vg, g = tzpc.interp_with_grad(coef, world["tg"], torch.from_numpy(pts))
    want_v, want_g = zpcubic_ref.interp_grad_ref(
        coef_ref, np.asarray(ORIGIN), np.asarray(SPACING), pts)
    np.testing.assert_allclose(v, zpcubic_ref.interp_ref(
        coef_ref, np.asarray(ORIGIN), np.asarray(SPACING), pts), atol=2e-5)
    np.testing.assert_allclose(vg.numpy(), want_v, atol=2e-5)
    np.testing.assert_allclose(g.numpy(), want_g, atol=2e-4)
