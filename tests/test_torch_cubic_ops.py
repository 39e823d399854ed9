"""Parity of the port's forward operators on the tricubic field model (the
default ``interp``) with the JAX package: the TEC and paired-dTEC forms,
the linear ray–voxel projection with its transpose on cubic and zp, ray
coverage, the vertical TEC map, the beam-noise rows, and the linearised
operator ``PairedDtecLinear`` against the J and Jᵀ that the reference
takes from ``jax.linearize``/``jax.linear_transpose``.

Same world as ``test_torch_tec.py`` (a 20³ Chapman grid plus a smooth
perturbation, 6 antennas × 5 directions, straight and bent 33-sample
bundles); every input is drawn from a ``np.random.default_rng(seed)`` of
its own. A paired dTEC is a difference of samples whose size is set by
TEC, so those bounds are relative to max|TEC| of the bundle.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import fermat as jfermat, rays as jrays
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox, tricubic as ttri
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import solvers as tsolvers

from tests.test_solvers import inversion_world
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
    """(JAX grid, m, JAX bundle, port grid, port bundle), same points."""
    jg, m = perturbed_world()
    o, d = jrays.make_ray_batch(*_array())
    if kind == "straight":
        jb = jrays.sample_straight_rays(o, d, 1000.0, 33)
    else:
        jb, _ = jfermat.trace_rays(jnp.asarray(m), jg, o, d, 150e6, 1000.0,
                                   n_steps=32, keep_path=True,
                                   method="leapfrog")
    tb = trays.RayBundle(points=torch.from_numpy(np.array(jb.points)),
                         ds=torch.from_numpy(np.array(jb.ds)))
    return jg, m, jb, convert.grid_from_numpy(jg, device="cpu"), tb


def test_cubic_is_the_default_field_model():
    """No ``interp`` named: the port runs the tricubic model, as the
    reference does, and the table is a view of the field (no copy)."""
    jg, m, jb, tg, tb = _bundles("straight")
    tm = torch.from_numpy(m)
    assert torch.equal(ttec.tec(tm, tg, tb), ttec.tec(tm, tg, tb, "cubic"))
    assert ttec._rows_of("cubic") is ttri and ttec._rows_of("zp3") is tbox
    table = ttec._coef2d(tm, tg, "cubic")
    assert table.data_ptr() == tm.data_ptr() and tuple(table.shape) == (400,
                                                                       20)
    np.testing.assert_allclose(
        ttec._coef2d(tm, tg, "zp").numpy(),
        np.asarray(jtec._coef2d(jnp.asarray(m), jg, "zp")), rtol=0,
        atol=5e-6 * np.abs(m).max())


@pytest.mark.parametrize("kind", ["straight", "bent"])
@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_tec_q_cubic_matches_jax(kind, quadrature):
    """TEC per ray on cubic. Tolerance 2e-6·max|TEC|."""
    jg, m, jb, tg, tb = _bundles(kind)
    want = np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb, quadrature))
    got = ttec.tec_q(torch.from_numpy(m), tg, tb, quadrature).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["straight", "bent"])
@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_dtec_paired_q_cubic_matches_jax(kind, quadrature):
    """Paired dTEC (Na, Nd) on cubic, i0 = 2. Tolerance 2e-6·max|TEC|; the
    reference antenna's row is exactly zero."""
    jg, m, jb, tg, tb = _bundles(kind)
    want = np.asarray(jtec.dtec_paired_q(jnp.asarray(m), jg, jb, ND, 2,
                                         quadrature))
    got = ttec.dtec_paired_q(torch.from_numpy(m), tg, tb, ND, 2,
                             quadrature).numpy()
    scale = np.abs(np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb,
                                         quadrature))).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("interp", ["cubic", "zp"])
def test_dtec_matches_jax(interp):
    """``dtec`` (the difference of two TEC integrals) to 2e-6·max|TEC|."""
    jg, m, jb, tg, tb = _bundles("straight")
    want = np.asarray(jtec.dtec(jnp.asarray(m), jg, jb, ND, 1, interp))
    got = ttec.dtec(torch.from_numpy(m), tg, tb, ND, 1, interp).numpy()
    scale = np.abs(np.asarray(jtec.tec(jnp.asarray(m), jg, jb, interp))).max()
    assert got.shape == (NA, ND)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("kind", ["straight", "bent"])
def test_endpoint_derivatives_cubic_match_jax(kind):
    """dn_e/ds at the 2R endpoints on cubic (the K5 route on the card):
    5e-7·max|m|·max|dn_e/ds|, as on zp."""
    jg, m, jb, tg, tb = _bundles(kind)
    jd0, jd1 = jtec._endpoint_dne_ds(jnp.asarray(m), jg, jb)
    td0, td1 = ttec._endpoint_dne_ds(torch.from_numpy(m), tg, tb)
    for a, b in ((jd0, td0), (jd1, td1)):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=0,
            atol=5e-7 * np.abs(m).max() * np.abs(a).max())


def test_ne_at_and_log_ne_at_cubic_match_jax():
    jg, m, jb, tg, tb = _bundles("straight")
    want = np.asarray(jtec.log_ne_at(jnp.asarray(m), jg, jb.points))
    got = ttec.log_ne_at(torch.from_numpy(m), tg, tb.points).numpy()
    assert got.shape == tuple(tb.points.shape[:2])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-7 * np.abs(m).max())
    want = np.asarray(jtec.ne_at(jnp.asarray(m), jg, jb.points))
    got = ttec.ne_at(torch.from_numpy(m), tg, tb.points).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-7 * np.abs(m).max())


@pytest.mark.parametrize("interp", ["cubic", "zp"])
def test_tec_linear_and_its_adjoint_match_jax(interp):
    """``tec_linear`` of an n_e field to 2e-6·max; ``tec_linear_adjoint``
    of a data vector to 1e-5·max|out| (on cubic the reference scatters 64
    stencil weights per sample, the port the same products through
    ``rows_value_transpose``; on zp the reference takes the derived
    transpose, prefilter included); the adjoint identity to 1e-4."""
    jg, m, jb, tg, tb = _bundles("straight")
    rng = np.random.default_rng(31)
    ne = (1e11 * np.exp(rng.normal(size=m.shape) * 0.3)).astype(np.float32)
    y = rng.normal(size=(NA * ND,)).astype(np.float32)
    want = np.asarray(jtec.tec_linear(jnp.asarray(ne), jg, jb, interp))
    got = ttec.tec_linear(torch.from_numpy(ne), tg, tb, interp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    want_t = np.asarray(jtec.tec_linear_adjoint(jnp.asarray(y), jg, jb,
                                                interp))
    got_t = ttec.tec_linear_adjoint(torch.from_numpy(y), tg, tb, interp)
    assert tuple(got_t.shape) == m.shape
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                               atol=1e-5 * np.abs(want_t).max())
    lhs = float(torch.dot(got.double(), torch.from_numpy(y).double()))
    rhs = float((torch.from_numpy(ne).double() * got_t.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


def test_ray_coverage_matches_jax():
    """Per-voxel sampling weight on cubic, 1e-5·max; voxels far from every
    ray carry none."""
    jg, m, jb, tg, tb = _bundles("bent")
    want = np.asarray(jtec.ray_coverage(jg, jb))
    got = ttec.ray_coverage(tg, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert got.max() > 0 and (got == 0).sum() > got.size // 2


def test_vtec_map_matches_jax():
    jg, m, _, tg, _ = _bundles("straight")
    want = np.asarray(jtec.vtec_map(jnp.asarray(m), jg))
    got = ttec.vtec_map(torch.from_numpy(m), tg).numpy()
    assert got.shape == m.shape[:2]
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_dtec_noise_from_beam_matches_jax():
    sd = np.abs(np.random.default_rng(32).normal(size=(NA * ND,))
                ).astype(np.float32)
    want = np.asarray(jtec.dtec_noise_from_beam(jnp.asarray(sd), ND, 3))
    got = ttec.dtec_noise_from_beam(torch.from_numpy(sd), ND, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[3] == 0.0)


@pytest.mark.parametrize("kind", ["straight", "bent"])
@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_linearised_operator_cubic_matches_jax(kind, quadrature):
    """``PairedDtecLinear`` on cubic against the reference's
    ``_dtec_operator``: g0 to 2e-6·max|TEC|; J δm and Jᵀ y to 1e-4·max;
    the adjoint identity to 1e-4; the plain-version operator is the CPU
    path."""
    jg, m, jb, tg, tb = _bundles(kind)
    rng = np.random.default_rng(33)
    dm = rng.normal(size=m.shape).astype(np.float32)
    y = rng.normal(size=(NA * ND,)).astype(np.float32)
    japply, japplyt, jg0 = jsolvers._dtec_operator(
        jg, jb, ND, 1, jnp.asarray(m), quadrature=quadrature)
    op = ttec.dtec_paired_linear(torch.from_numpy(m), tg, tb, ND, 1,
                                 quadrature)
    scale = np.abs(np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb,
                                         quadrature))).max()
    np.testing.assert_allclose(op.g0.numpy(), np.asarray(jg0), rtol=0,
                               atol=2e-6 * scale)
    want, want_t = np.asarray(japply(jnp.asarray(dm))), np.asarray(
        japplyt(jnp.asarray(y)))
    got, got_t = op.apply(torch.from_numpy(dm)), op.apply_t(
        torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                               atol=1e-4 * np.abs(want_t).max())
    lhs = float(torch.dot(got.double(), torch.from_numpy(y).double()))
    rhs = float((torch.from_numpy(dm).double() * got_t.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    ref = ttec.dtec_paired_linear_ref(torch.from_numpy(m), tg, tb, ND, 1,
                                      quadrature)
    assert torch.equal(ref.apply(torch.from_numpy(dm)), got)
    assert torch.equal(ref.apply_t(torch.from_numpy(y)), got_t)


@pytest.mark.parametrize("interp", ["zpc", "quadratic"])
def test_models_still_to_port_raise_in_every_operator(interp):
    """(The name is kept from before these models were ported.) zpc runs
    every operator: ``dtec_paired_linear`` against the reference's
    ``_dtec_operator`` (g0 to 2e-6·max|TEC|, J δm and Jᵀ y to 1e-4·max),
    by the adjoint identity (1e-4), and as the plain-version operator
    bitwise on the CPU; ``tec_linear_adjoint`` against the reference's
    derived transpose (1e-5·max, prefilter included) and by the adjoint
    identity of ``tec_linear``. quadratic raises ValueError in every
    operator, as the reference does; so does an unknown model."""
    jg, m, jb, tg, tb = _bundles("bent")
    tm = torch.from_numpy(m)
    rng = np.random.default_rng(37)
    y = rng.normal(size=(NA * ND,)).astype(np.float32)
    if interp == "quadratic":
        for call in (
                lambda: ttec.tec_linear_adjoint(torch.from_numpy(y), tg, tb,
                                                interp),
                lambda: ttec.dtec_paired_linear(tm, tg, tb, ND, 0, "hermite",
                                                interp),
                lambda: ttec.dtec_paired_q(tm, tg, tb, ND, 0, "hermite",
                                           interp),
                lambda: ttec.log_ne_at(tm, tg, tb.points, interp),
                lambda: ttec.tec_linear_op(tm, tg, tb, "simpson", interp)):
            with pytest.raises(ValueError, match="unknown interp"):
                call()
        # the reference: ValueError from its table map, or KeyError from
        # its model lookup, whichever its operator reaches first
        with pytest.raises((ValueError, KeyError)):
            jtec.dtec_paired_q(jnp.asarray(m), jg, jb, ND, 0, "hermite",
                               interp)
        with pytest.raises(ValueError, match="unknown interp"):
            ttec.tec(tm, tg, tb, "linear")
        return
    dm = rng.normal(size=m.shape).astype(np.float32)
    japply, japplyt, jg0 = jsolvers._dtec_operator(
        jg, jb, ND, 1, jnp.asarray(m), quadrature="hermite", interp=interp)
    op = ttec.dtec_paired_linear(tm, tg, tb, ND, 1, "hermite", interp)
    scale = np.abs(np.asarray(jtec.tec_q(jnp.asarray(m), jg, jb, "hermite",
                                         interp))).max()
    np.testing.assert_allclose(op.g0.numpy(), np.asarray(jg0), rtol=0,
                               atol=2e-6 * scale)
    want, want_t = np.asarray(japply(jnp.asarray(dm))), np.asarray(
        japplyt(jnp.asarray(y)))
    got, got_t = op.apply(torch.from_numpy(dm)), op.apply_t(
        torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                               atol=1e-4 * np.abs(want_t).max())
    lhs = float(torch.dot(got.double(), torch.from_numpy(y).double()))
    rhs = float((torch.from_numpy(dm).double() * got_t.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    ref = ttec.dtec_paired_linear_ref(tm, tg, tb, ND, 1, "hermite", interp)
    assert torch.equal(ref.apply(torch.from_numpy(dm)), got)
    assert torch.equal(ref.apply_t(torch.from_numpy(y)), got_t)
    ne = (1e11 * np.exp(rng.normal(size=m.shape) * 0.3)).astype(np.float32)
    want_t = np.asarray(jtec.tec_linear_adjoint(jnp.asarray(y), jg, jb,
                                                interp))
    got_t = ttec.tec_linear_adjoint(torch.from_numpy(y), tg, tb, interp)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                               atol=1e-5 * np.abs(want_t).max())
    got = ttec.tec_linear(torch.from_numpy(ne), tg, tb, interp)
    lhs = float(torch.dot(got.double(), torch.from_numpy(y).double()))
    rhs = float((torch.from_numpy(ne).double() * got_t.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


def test_lsqr_smoothness_cubic_matches_jax():
    """Config 3's solver on the default model, on the miniature world of
    ``tests/test_solvers.py`` at 20 LSQR iterations (where the two
    packages' arithmetic still agrees, see ``test_torch_solvers.py``): the
    final residual within 1e-3 relative, the field within 1 % of its
    departure from the prior, the same iteration count."""
    w = inversion_world()
    rb = w["rays"]
    kw = dict(num_directions=w["n_dirs"], damp=3e-3, smooth=0.2,
              max_iters=20)
    jres = jsolvers.lsqr_smoothness(w["grid"], rb, w["d_obs"],
                                    w["noise_std"], w["m_prior"], **kw)
    tres = tsolvers.lsqr_smoothness(
        convert.grid_from_numpy(w["grid"], device="cpu"),
        trays.RayBundle(torch.from_numpy(np.array(rb.points)),
                        torch.from_numpy(np.array(rb.ds))),
        torch.from_numpy(np.array(w["d_obs"])), float(w["noise_std"]),
        torch.from_numpy(np.array(w["m_prior"])), **kw)
    jr, tr = float(jres.residual_norm), float(tres.residual_norm)
    assert abs(tr - jr) <= 1e-3 * jr
    jm, mp = np.asarray(jres.m), np.asarray(w["m_prior"])
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    assert rms(tres.m.numpy() - jm) <= 1e-2 * rms(jm - mp)
    assert int(tres.info[0].iterations) == int(jres.info[0].iterations)
