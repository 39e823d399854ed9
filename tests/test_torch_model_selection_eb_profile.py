"""Parity of the port's prior selection (``inversion.model_selection``),
empirical Bayes (``inversion.empirical_bayes``) and joint profile solve
(``inversion.profile``) with the JAX package, on the worlds of the JAX
package's own tests of those modules (``tests/test_model_selection.py``,
``tests/test_empirical_bayes.py``, ``tests/test_profile.py``, the last at
14³). Both packages get the same inputs; the Hutchinson and Lanczos
probes are the JAX package's own Rademacher draws, fed to the port. Each
JAX computation runs once per module. Tolerances are stated per test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionotomo_tpu.inversion import empirical_bayes as jeb
from ionotomo_tpu.inversion import model_selection as jms
from ionotomo_tpu.inversion import profile as jprof
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import empirical_bayes as teb
from ionotomo_tpu_torch.inversion import model_selection as tms
from ionotomo_tpu_torch.inversion import profile as tprof
from ionotomo_tpu_torch.inversion.anchors import TecAnchors
from ionotomo_tpu_torch.inversion.priors import GPCovariance as TGPCovariance

torch.set_num_threads(2)


def _bundle(rb):
    return trays.RayBundle(torch.from_numpy(np.array(rb.points)),
                           torch.from_numpy(np.array(rb.ds)))


def _t(a):
    return torch.from_numpy(np.array(a))


# --- GCV -----------------------------------------------------------------

CANDIDATES = [dict(sigma=s, length_scale=ls, kind="sqexp")
              for s in (0.2, 0.4) for ls in (45.0, 90.0)]
GCV_CG = 6


@functools.lru_cache(maxsize=None)
def gcv_runs():
    from tests.test_model_selection import world
    grid, m_prior, rb, d_obs, noise, nd, _, _ = world()
    key = jax.random.key(0)
    n_data = int(np.prod(d_obs.shape))
    probes = np.array(jax.random.rademacher(key, (4, n_data))
                      .astype(jnp.float32))
    _, jparams, jscores = jms.select_prior(
        grid, rb, d_obs, noise, m_prior, CANDIDATES, nd, key=key,
        cg_iters=GCV_CG)
    tgrid = convert.grid_from_numpy(grid, device="cpu")
    tcov, tparams, tscores = tms.select_prior(
        tgrid, _bundle(rb), _t(d_obs), float(noise), _t(m_prior),
        CANDIDATES, nd, probes=torch.from_numpy(probes), cg_iters=GCV_CG)
    return jparams, jscores, tparams, tscores, tcov, tgrid


def test_select_prior_matches_jax():
    """The JAX package's winner, and each candidate's score within 1e-3
    relative (f32 CG at cg 6 over five systems batched on a member axis:
    the residual and 4 probes). One test, so that one process runs the
    JAX selection."""
    jparams, jscores, tparams, tscores, tcov, tgrid = gcv_runs()
    assert tparams == jparams
    assert isinstance(tcov, TGPCovariance)
    assert tcov.sigma == jparams["sigma"] and tcov.kind == "sqexp"
    assert np.all(np.isfinite(tscores))
    np.testing.assert_allclose(tscores, jscores, rtol=1e-3)


def test_select_prior_draws_its_own_probes_reproducibly():
    """Without probes the port draws them from its seed: the same scores
    on every call, other scores from another seed."""
    from tests.test_model_selection import world
    grid, m_prior, rb, d_obs, noise, nd, _, _ = world()
    tgrid = convert.grid_from_numpy(grid, device="cpu")
    args = (tgrid, _bundle(rb), _t(d_obs), float(noise), _t(m_prior),
            CANDIDATES[:1], nd)
    a = tms.select_prior(*args, seed=3, cg_iters=2)[2]
    b = tms.select_prior(*args, seed=3, cg_iters=2)[2]
    c = tms.select_prior(*args, seed=4, cg_iters=2)[2]
    assert a == b and a != c


# --- empirical Bayes -----------------------------------------------------

GAMMAS = (np.array([0.1, 0.2, 0.4, 0.8]) ** 2).astype(np.float32)
RHOS = np.logspace(-0.4, 0.4, 5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def eb_world():
    from tests.test_empirical_bayes import small_world
    grid, m_prior, rb, nd = small_world()
    cov_true = JGPCovariance.create(grid, sigma=0.3, length_scale=60.0,
                                    kind="von_karman")
    m_true = m_prior + cov_true.sample(jax.random.key(11))
    from ionotomo_tpu.forward import tec as jtec
    d_clean = jtec.dtec_paired_hermite(m_true, grid, rb, nd, 0)
    noise = jnp.float32(0.05 * float(jnp.std(d_clean)))
    d_obs = d_clean + noise * jax.random.normal(jax.random.key(12),
                                                d_clean.shape)
    cov1 = JGPCovariance.create(grid, sigma=1.0, length_scale=60.0,
                                kind="von_karman")
    tgrid = convert.grid_from_numpy(grid, device="cpu")
    port = (tgrid, _bundle(rb), _t(d_obs), float(noise), _t(m_prior),
            convert.gp_covariance_from_numpy(cov1, device="cpu"))
    return (grid, rb, d_obs, noise, m_prior, cov1), port, nd


@pytest.mark.parametrize("method", ["dense", "slq"])
def test_log_marginal_family_matches_jax(method):
    """The (γ, ρ) log-evidence table within 1e-4 of its largest magnitude
    (dense: Ã assembled in f32 by each package, one f64 eigh on the host;
    slq: 30 Lanczos steps with full reorthogonalisation over JAX's 8
    probes), the same argmax."""
    j, t, nd = eb_world()
    n = int(np.prod(j[2].shape))
    key = jax.random.key(0)
    jll, jdiag = jeb.log_marginal_family(
        *j[:5], j[5], jnp.asarray(GAMMAS), nd, method=method, key=key,
        noise_scales=jnp.asarray(RHOS), lanczos_iters=30)
    probes = np.array(jax.random.rademacher(key, (8, n), jnp.float32))
    tll, tdiag = teb.log_marginal_family(
        *t, GAMMAS, nd, method=method, probes=torch.from_numpy(probes),
        noise_scales=RHOS, lanczos_iters=30)
    jll = np.asarray(jll)
    assert tll.shape == jll.shape == (len(GAMMAS), len(RHOS))
    np.testing.assert_allclose(tll, jll, rtol=0,
                               atol=1e-4 * np.abs(jll).max())
    assert np.argmax(tll) == np.argmax(jll)
    np.testing.assert_allclose(tdiag["r_norm"], jdiag["r_norm"], rtol=1e-5)


def test_fit_hyperparameters_matches_jax():
    """The same (σ*, L*, ρ*) and the table within 1e-4 of its largest
    magnitude (the dense path: 30 rows)."""
    j, t, nd = eb_world()
    kw = dict(length_scales=[30.0, 60.0, 120.0],
              sigmas=0.3 * np.logspace(-0.6, 0.6, 5), kind="von_karman",
              noise_scales=np.logspace(-0.3, 0.3, 3))
    jout = jeb.fit_hyperparameters(*j[:5], nd, **kw)
    tout = teb.fit_hyperparameters(*t[:5], nd, **kw)
    assert tout[:3] == jout[:3]
    np.testing.assert_allclose(tout[3], jout[3], rtol=0,
                               atol=1e-4 * np.abs(jout[3]).max())
    assert isinstance(tout[4], TGPCovariance)
    assert tout[4].length_scale == jout[4].length_scale


# --- the joint profile solve ---------------------------------------------

#: The joint (θ, δm) system's CG depth for parity. Its θ columns, scaled
#: by Σ_θ^{1/2}, leave it far worse conditioned than the voxel system: on
#: this world the two packages agree to ~1e-4 at cg 1-3 and part by
#: percents from cg 4 (measured, one GN step: cg 4 residual 268.38 and
#: 268.29; cg 6 275.85 and 267.57, the JAX solve's residual above its cg
#: 2 value, f32 CG past its accuracy in both packages).
PROFILE_CG = 3

@functools.lru_cache(maxsize=None)
def profile_runs():
    from ionotomo_tpu.forward import tec as jtec
    from ionotomo_tpu.geometry import rays as jrays
    from tests.test_profile import slant_anchor_set, wrong_profile_world
    grid, ants, dirs, _, m_true = wrong_profile_world(nx=14)
    anchors = slant_anchor_set(grid, m_true)
    o, d = jrays.make_ray_batch(ants, dirs)
    rb = jrays.sample_straight_rays(o, d, n_samples=33)
    nd = dirs.shape[0]
    d_obs = np.array(jtec.dtec_paired_hermite(m_true, grid, rb, nd, 0))
    noise = np.float32(0.01 * np.std(d_obs) + 1e-3)
    cov = JGPCovariance.create(grid, sigma=0.2, length_scale=80.0,
                               kind="von_karman")
    theta0 = jprof.ProfileParams.create()
    kw = dict(num_directions=nd, gn_iters=2, cg_iters=PROFILE_CG)
    jres = jprof.map_gauss_newton_profile(
        grid, rb, d_obs, noise, theta0, (0.7, 50.0, 30.0), cov,
        anchors=anchors, **kw)
    tgrid = convert.grid_from_numpy(grid, device="cpu")
    tanch = TecAnchors(rays=_bundle(anchors.rays), values=_t(anchors.values),
                       noise_std=_t(anchors.noise_std))
    tres = tprof.map_gauss_newton_profile(
        tgrid, _bundle(rb), torch.from_numpy(d_obs), float(noise),
        tprof.ProfileParams.create(device="cpu"), (0.7, 50.0, 30.0),
        convert.gp_covariance_from_numpy(cov, device="cpu"),
        anchors=tanch, **kw)
    return jres, tres, grid, tgrid, m_true


def test_profile_solve_matches_jax():
    """θ̂ within 1e-3 relative per parameter (against the step θ̂ − θ0 of
    each: 1e-2), the residual history within 1e-3 relative, the same CG
    iteration counts, δm within 1e-2 rms of its size, the profile rms
    against the truth within 1e-3 relative."""
    jres, tres, grid, tgrid, m_true = profile_runs()
    jt = np.array([float(v) for v in jres.theta])
    tt = np.array([float(v) for v in tres.theta])
    t0 = np.array([float(v) for v in jprof.ProfileParams.create()])
    assert np.all(np.abs(tt - jt) <= 1e-2 * np.abs(jt - t0) + 1e-6 * np.abs(jt))
    np.testing.assert_allclose(tres.info[0].numpy(), np.asarray(jres.info[0]),
                               rtol=1e-3)
    np.testing.assert_array_equal(tres.info[1].numpy(),
                                  np.asarray(jres.info[1]))
    jd, td = np.asarray(jres.delta_m), tres.delta_m.numpy()
    assert np.sqrt(np.mean((td - jd) ** 2)) <= 1e-2 * np.sqrt(np.mean(jd ** 2))
    jr = float(jprof.log_profile_rms(jres.m, m_true, grid))
    tr = float(tprof.log_profile_rms(tres.m, _t(m_true), tgrid))
    assert abs(tr - jr) <= 1e-3 * jr
    assert tr < float(tprof.log_profile_rms(
        tprof.chapman_log_field(tgrid, tprof.ProfileParams.create()),
        _t(m_true), tgrid))


@pytest.mark.parametrize("curved", [False, True])
def test_profile_fields_match_jax(curved):
    """The single- and three-layer fields: flat within 1e-5 (1 + |m|) (f32
    rounding); curved also within 1e-3 km × the field's vertical slope,
    since the two packages' true altitudes, sqrt(r² + (R + z)²) − R in
    f32, differ by up to 4.9e-4 km (measured; the cancellation the synth
    tests state)."""
    from ionotomo_tpu.core.grids import Grid3D as JGrid
    jg = JGrid.create(np.array([-200.0, -150.0, 0.0], np.float32),
                      np.array([25.0, 20.0, 40.0], np.float32), (12, 10, 16))
    tg = convert.grid_from_numpy(jg, device="cpu")
    th = jprof.ProfileParams.create(n_peak=1.3e12, h_peak_km=330.0,
                                    scale_km=70.0)
    tth = tprof.ProfileParams.create(n_peak=1.3e12, h_peak_km=330.0,
                                     scale_km=70.0, device="cpu")
    assert [float(a) for a in tth] == [float(a) for a in th]
    layers = np.array([np.log(1.2e11), 110.0, 10.0, np.log(2.5e11), 180.0,
                       40.0, np.log(1e12), 350.0, 80.0], np.float32)
    pairs = [(jprof.chapman_log_field(jg, th, curved=curved),
              tprof.chapman_log_field(tg, tth, curved=curved)),
             (jprof.multi_chapman_log_field(jg, jnp.asarray(layers),
                                            curved=curved),
              tprof.multi_chapman_log_field(tg, torch.from_numpy(layers),
                                            curved=curved))]
    for j, t in pairs:
        j, t = np.asarray(j, np.float64), t.numpy().astype(np.float64)
        tol = 1e-5 * (1.0 + np.abs(j))
        if curved:
            slope = np.abs(np.gradient(j, 40.0, axis=2))
            tol = tol + 1e-3 * slope
        assert np.all(np.abs(t - j) <= tol), np.abs(t - j).max()


def test_profile_solve_matches_jax_where_gauss_newton_diverges():
    """The estimate_profile mode's joint solve on the world of
    ``chip_smoke.py``'s phase 16 (``data.synth``'s defaults, timestep 0,
    the truth's 15 slant anchors), its grid cut to 24³, cg 5 and two
    Gauss-Newton steps, through ``chip_smoke.theta_solve`` and through the
    JAX function on the same inputs: the residual after each step and θ̂
    within 1e-3 relative. Both packages' second step raises the whitened
    residual: the reference's undamped Gauss-Newton diverges on this
    world, which is why the mode's θ̂ at cg 40 and 4 steps is unphysical
    on the card (``chip_smoke.py --theta-study``)."""
    import sys

    from ionotomo_tpu.core.grids import Grid3D as JGrid
    from ionotomo_tpu.geometry.rays import RayBundle as JBundle
    from ionotomo_tpu.inversion.anchors import TecAnchors as JAnchors
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
    from tests.test_torch_slice import REPO

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    cpu = torch.device("cpu")
    dp, truth = chip_smoke.invert_world(cpu)
    sub = dp.select(times=[0])
    sub.wind_kmps = dp.wind_kmps
    pipe = InversionPipeline(sub, chip_smoke.invert_config(
        "theta_parity", "--estimate-profile", shape=(24, 24, 24)),
        device=cpu)
    anchors = chip_smoke.slant_truth_anchors(cpu, pipe, truth)
    got = chip_smoke.theta_solve(pipe, anchors, 5, 2)

    ants, d0, noise0, _ = pipe._padded_data(0)
    rb = pipe.rays_for_time(0, antennas=ants)
    g = pipe.grid
    jgrid = JGrid.create(g.origin.numpy(), g.spacing.numpy(), g.shape)
    cov = JGPCovariance.create(jgrid, sigma=pipe.cov.sigma,
                               length_scale=pipe.cov.length_scale,
                               kind=pipe.cov.kind)
    np.testing.assert_array_equal(np.asarray(cov.spectrum),
                                  pipe.cov.spectrum.numpy())
    jres = jprof.map_gauss_newton_profile(
        jgrid, JBundle(jnp.asarray(rb.points.numpy()),
                       jnp.asarray(rb.ds.numpy())),
        d0.numpy(), noise0.numpy(), jprof.ProfileParams.create(),
        pipe.config.solver.profile_sigma, cov,
        num_directions=pipe.directions.shape[1], i0=pipe.i0,
        anchors=JAnchors(
            rays=JBundle(jnp.asarray(anchors.rays.points.numpy()),
                         jnp.asarray(anchors.rays.ds.numpy())),
            values=jnp.asarray(anchors.values.numpy()),
            noise_std=jnp.asarray(np.float32(anchors.noise_std))),
        gn_iters=2, cg_iters=5)
    jt = [float(jres.theta.n_peak), float(jres.theta.h_peak_km),
          float(jres.theta.scale_km)]
    np.testing.assert_allclose(got["theta"], jt, rtol=1e-3)
    jr = np.asarray(jres.info[0])
    np.testing.assert_allclose(got["residual"], jr, rtol=1e-3)
    assert jr[1] > jr[0] and got["residual"][1] > got["residual"][0]
