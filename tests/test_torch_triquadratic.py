"""Parity of the port's triquadratic field model (ionotomo_tpu_torch.core.
triquadratic) with the JAX package's ``core.triquadratic`` on the same
numpy-seeded 16³ fields and points, and with the f64 oracle
``reference_kernels/triquadratic_ref.py``.

The plain versions here are what kernels K6q (value + gradient) and K1q
(the tracer's evaluator, over K1's z-tap pack) are held to on the card.

Tolerances: the prefilter 2e-6·max|field| (three f32 matmuls summed in
another order); values 5e-7·max|coef|, gradients that over the smallest
spacing (as ``test_torch_endpoint_eval.py``); the stencil indices
bitwise; against the oracle ``tests/test_triquadratic.py``'s bounds (5e-6
values and coefficients, 5e-5 gradients).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import triquadratic as jquad
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox, triquadratic as tquad
from ionotomo_tpu_torch.testing import edge_case_points
from reference_kernels import triquadratic_ref

torch.set_num_threads(2)

SHAPE = (16, 16, 16)
ORIGIN = (-1.0, 0.5, 2.0)
SPACING = (0.5, 0.25, 0.125)
KINDS = pytest.mark.parametrize("kind", ["random", "edge_case"])


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(62)
    field = rng.normal(size=SHAPE).astype(np.float32)
    coef = np.array(jquad.prefilter(jnp.asarray(field)))
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    pts = {"random": (np.asarray(ORIGIN) + rng.uniform(0, 1, (600, 3)) * hi
                      ).astype(np.float32),
           "edge_case": edge_case_points(SHAPE, ORIGIN, SPACING, 1600, rng)}
    return dict(field=field, coef=coef, coef2d=coef.reshape(-1, SHAPE[2]),
                jg=jg, tg=convert.grid_from_numpy(jg, device="cpu"),
                pts=pts, cmax=float(np.abs(coef).max()))


def test_prefilter_matches_jax(world):
    got = tquad.prefilter(torch.from_numpy(world["field"])).numpy()
    np.testing.assert_allclose(got, world["coef"], rtol=0,
                               atol=2e-6 * np.abs(world["field"]).max())
    stacked = tquad.prefilter(torch.from_numpy(
        np.stack([world["field"], 2 * world["field"]])))
    assert torch.equal(stacked[0], torch.from_numpy(got))


@KINDS
def test_interp_and_interp_rows_match_jax(world, kind):
    """The block form and the row gather (K2 at K=9, L=3, z first on the
    card) of the coefficient grid."""
    pts = world["pts"][kind]
    tol = 5e-7 * world["cmax"]
    want = np.asarray(jquad.interp(jnp.asarray(world["coef"]), world["jg"],
                                   jnp.asarray(pts)))
    got = tquad.interp(torch.from_numpy(world["coef"]), world["tg"],
                       torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    want = np.asarray(jquad.interp_rows(jnp.asarray(world["coef2d"]),
                                        world["jg"], jnp.asarray(pts)))
    got = tquad.interp_rows(torch.from_numpy(world["coef2d"]), world["tg"],
                            torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@KINDS
def test_interp_rows_with_grad_ref_matches_jax(world, kind):
    """K6q's plain version and its twin in the kernels' order against the
    reference's ``interp_rows_with_grad``."""
    pts = world["pts"][kind]
    jv, jgr = jquad.interp_rows_with_grad(jnp.asarray(world["coef2d"]),
                                          world["jg"], jnp.asarray(pts))
    table = torch.from_numpy(world["coef2d"])
    tol = 5e-7 * world["cmax"]
    for fn in (tquad.interp_rows_with_grad_ref,
               tquad.interp_rows_with_grad_taps_ref):
        v, g = fn(table, world["tg"], torch.from_numpy(pts))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=0,
                                   atol=tol / min(SPACING))


def test_packed_evaluator_is_the_taps_twin_bitwise(world):
    """K1q's evaluator over K1's z-tap pack (quadratic's z stencil is the
    zp one: b−1, b, b+1 of the nearest base, clamped to [1, nz−2]) reads
    the very taps of the unpacked twin."""
    pts = torch.from_numpy(world["pts"]["edge_case"])
    table = torch.from_numpy(world["coef2d"])
    idx, _ = tquad._neighborhood(world["tg"], pts)
    assert bool((idx[:, 2, 1] == 1).any()) and bool(
        (idx[:, 2, 1] == SHAPE[2] - 2).any())
    got = tquad.interp_rows_with_grad_packed_ref(
        tbox.pack_z_taps_ref(table), world["tg"], pts)
    want = tquad.interp_rows_with_grad_taps_ref(table, world["tg"], pts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_interp_weights_match_jax(world):
    pts = world["pts"]["edge_case"]
    ji, jw = jquad.interp_weights(world["jg"], jnp.asarray(pts))
    ti, tw = tquad.interp_weights(world["tg"], torch.from_numpy(pts))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-7)
    via = (torch.from_numpy(world["coef"]).reshape(-1)[ti.long()] * tw).sum(-1)
    np.testing.assert_allclose(
        via.numpy(), tquad.interp(torch.from_numpy(world["coef"]),
                                  world["tg"], torch.from_numpy(pts)).numpy(),
        rtol=0, atol=5e-7 * world["cmax"])


def test_matches_f64_oracle(world):
    """Prefilter, value and gradient against the f64 oracle at interior
    points, within ``tests/test_triquadratic.py``'s bounds."""
    rng = np.random.default_rng(12)
    f = world["field"]
    coef = tquad.prefilter(torch.from_numpy(f))
    coef_ref = triquadratic_ref.prefilter_ref(f)
    np.testing.assert_allclose(coef.numpy(), coef_ref, atol=5e-6)
    lo = np.asarray(ORIGIN) + 1.0 * np.asarray(SPACING)
    hi = (np.asarray(ORIGIN)
          + (np.asarray(SHAPE) - 2.0) * np.asarray(SPACING))
    pts = rng.uniform(lo, hi, (60, 3)).astype(np.float32)
    v = tquad.interp(coef, world["tg"], torch.from_numpy(pts)).numpy()
    vg, g = tquad.interp_with_grad(coef, world["tg"], torch.from_numpy(pts))
    want_v, want_g = triquadratic_ref.interp_grad_ref(
        coef_ref, np.asarray(ORIGIN), np.asarray(SPACING), pts)
    np.testing.assert_allclose(v, triquadratic_ref.interp_ref(
        coef_ref, np.asarray(ORIGIN), np.asarray(SPACING), pts), atol=5e-6)
    np.testing.assert_allclose(vg.numpy(), want_v, atol=5e-6)
    np.testing.assert_allclose(g.numpy(), want_g, atol=5e-5)
