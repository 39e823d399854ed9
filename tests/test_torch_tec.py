"""Parity of the port's TEC / paired-dTEC operators (ionotomo_tpu_torch.
forward.tec, plain PyTorch versions on the CPU) with the JAX package on
the same numpy-seeded world and ray bundles, straight and bent.

Both sides evaluate n_e = K_NE·e^m at the same points and sum in f32 in
different orders. A paired dTEC is a difference of samples whose size is
set by TEC, not by dTEC, so every bound is relative to max|TEC| of the
bundle (measured errors are quoted per test).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import fermat as jfermat, rays as jrays
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays

from tests.test_torch_fermat import perturbed_world

torch.set_num_threads(2)

NA, ND = 6, 5


def _array(seed=2):
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-150, 150, (NA, 2)),
                           np.zeros((NA, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.6, ND)
    az = rng.uniform(0, 2 * np.pi, ND)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    return ants, dirs


def _bundles(kind):
    """(JAX RayBundle, port RayBundle) holding the same points."""
    jg, m = perturbed_world()
    ants, dirs = _array()
    o, d = jrays.make_ray_batch(ants, dirs)
    if kind == "straight":
        jb = jrays.sample_straight_rays(o, d, 1000.0, 33)
    else:
        jb, _ = jfermat.trace_rays(jnp.asarray(m), jg, o, d, 150e6, 1000.0,
                                   n_steps=32, keep_path=True,
                                   method="leapfrog", interp="zp")
    tb = trays.RayBundle(points=torch.from_numpy(np.array(jb.points)),
                         ds=torch.from_numpy(np.array(jb.ds)))
    return jg, m, jb, convert.grid_from_numpy(jg, device="cpu"), tb


def test_make_ray_batch_and_straight_sampler_match_jax():
    ants, dirs = _array()
    jo, jd = jrays.make_ray_batch(ants, dirs)
    to, td = trays.make_ray_batch(torch.from_numpy(ants),
                                  torch.from_numpy(dirs))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jb = jrays.sample_straight_rays(jo, jd, 1000.0, 33)
    tb = trays.sample_straight_rays(to, td, 1000.0, 33)
    # linspace may differ by an ulp of the 1000 km arc length
    np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                               rtol=0, atol=2e-4)
    np.testing.assert_array_equal(tb.ds.numpy(), np.asarray(jb.ds))


@pytest.mark.parametrize("n", [3, 5, 33, 34])
def test_quadrature_weights_match_jax(n):
    np.testing.assert_array_equal(trays.trapezoid_weights(n).numpy(),
                                  np.asarray(jrays.trapezoid_weights(n)))
    np.testing.assert_allclose(trays.simpson_weights(n).numpy(),
                               np.asarray(jrays.simpson_weights(n)),
                               rtol=1e-7)


@pytest.mark.parametrize("kind", ["straight", "bent"])
@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_tec_q_matches_jax(kind, quadrature):
    """TEC per ray. Tolerance 2e-6·max|TEC| (measured 2.4e-7)."""
    jg, m, jb, tg, tb = _bundles(kind)
    want = np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb, quadrature, "zp"))
    got = ttec.tec_q(torch.from_numpy(m), tg, tb, quadrature, "zp").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["straight", "bent"])
@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_dtec_paired_q_matches_jax(kind, quadrature):
    """Paired dTEC (Na, Nd), i0 = 2. Tolerance 2e-6·max|TEC| (measured
    2.6e-7); the reference antenna's row is exactly zero on both sides."""
    jg, m, jb, tg, tb = _bundles(kind)
    i0 = 2
    want = np.asarray(jtec.dtec_paired_q(jnp.asarray(m), jg, jb, ND, i0,
                                         quadrature, "zp"))
    got = ttec.dtec_paired_q(torch.from_numpy(m), tg, tb, ND, i0,
                             quadrature, "zp").numpy()
    scale = np.abs(np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb,
                                         quadrature, "zp"))).max()
    assert got.shape == (NA, ND)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    assert np.all(got[i0] == 0.0)


@pytest.mark.parametrize("kind", ["straight", "bent"])
def test_endpoint_derivatives_match_jax(kind):
    """dn_e/ds at the 2R endpoints (the K1e route on the card). e^m turns
    the interpolant's absolute error in m (5e-7·max|m|) into a relative
    one: tolerance 5e-7·max|m|·max|dn_e/ds| (measured 5.9e-6·max)."""
    jg, m, jb, tg, tb = _bundles(kind)
    jd0, jd1 = jtec._endpoint_dne_ds(jnp.asarray(m), jg, jb, "zp")
    td0, td1 = ttec._endpoint_dne_ds(torch.from_numpy(m), tg, tb, "zp")
    for a, b in ((jd0, td0), (jd1, td1)):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=0,
            atol=5e-7 * np.abs(m).max() * np.abs(a).max())


def test_ne_at_matches_jax():
    """n_e = K_NE·e^m turns the interpolant's absolute error in m (bound
    5e-7·max|m|, test_torch_boxspline) into a relative error in n_e."""
    jg, m, jb, tg, tb = _bundles("straight")
    want = np.asarray(jtec.ne_at(jnp.asarray(m), jg, jb.points, "zp"))
    got = ttec.ne_at(torch.from_numpy(m), tg, tb.points, "zp").numpy()
    assert got.shape == tuple(tb.points.shape[:2])
    np.testing.assert_allclose(got, want, rtol=5e-7 * np.abs(m).max())


@pytest.mark.parametrize("interp", ["zpc3", "zpc"])
def test_unported_field_models_raise(interp):
    """The zpc models, which raised before they were ported (the name is
    kept from then): ``dtec_paired_q`` under both quadratures on the bent
    bundle, and ``tec_hermite``, against the JAX package, within
    ``test_dtec_paired_q_matches_jax``'s bound (2e-6·max|TEC|)."""
    jg, m, jb, tg, tb = _bundles("bent")
    scale = np.abs(np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb, "hermite",
                                         interp))).max()
    for quadrature in ("hermite", "simpson"):
        want = np.asarray(jtec.dtec_paired_q(jnp.asarray(m), jg, jb, ND, 2,
                                             quadrature, interp))
        got = ttec.dtec_paired_q(torch.from_numpy(m), tg, tb, ND, 2,
                                 quadrature, interp).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    want = np.asarray(jtec.tec_hermite(jnp.asarray(m), jg, jb, interp))
    got = ttec.tec_hermite(torch.from_numpy(m), tg, tb, interp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
