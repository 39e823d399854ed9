"""Parity of the port's remaining solvers with the JAX package:
``map_gauss_newton_robust``, ``posterior_samples``,
``map_gauss_newton_batched``, ``steepest_descent_map`` and
``priors.fit_shell_spectrum``, on a small copy of ``tests/test_solvers.py``'s
world (14³, 8 antennas × 6 directions, 65-sample straight rays, a blob
truth plus noise). Both packages get the same inputs; the draws of the
posterior samples are the JAX package's own, fed to the port. Each JAX
solve runs once per module.

Solvers are compared by norms (truncated f32 Krylov iterations amplify
rounding; ROADMAP.md): at cg 6 the final whitened residuals within 1e-3
relative, rms(m_port − m_jax) ≤ 1e-2·rms(m_jax − m_prior), and the
held-out dTEC rms (the truth's dTEC over 8 antennas × 3 other directions)
within 1e-3 relative of the JAX field's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu.inversion.priors import fit_shell_spectrum as jshell
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import solvers as tsolvers
from ionotomo_tpu_torch.inversion.priors import fit_shell_spectrum as tshell

from tests.test_solvers import inversion_world

torch.set_num_threads(2)

CG = 6
RES_TOL = 1e-3          # relative, final whitened residual
FIELD_TOL = 1e-2        # rms(m_port − m_jax) / rms(m_jax − m_prior)
HELDOUT_TOL = 1e-3      # relative, held-out dTEC rms


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _bundle(rb):
    return trays.RayBundle(torch.from_numpy(np.array(rb.points)),
                           torch.from_numpy(np.array(rb.ds)))


@functools.lru_cache(maxsize=None)
def world():
    """The JAX world, the port's copy of its inputs, the covariance in both
    packages and the held-out rays with the truth's dTEC over them."""
    w = inversion_world(nx=14, n_ants=8, n_dirs=6, seed=2)
    cov = JGPCovariance.create(w["grid"], sigma=0.3, length_scale=90.0,
                               kind="sqexp")
    p = dict(grid=convert.grid_from_numpy(w["grid"], device="cpu"),
             rays=_bundle(w["rays"]),
             d_obs=torch.from_numpy(np.array(w["d_obs"])),
             noise_std=float(w["noise_std"]),
             m_prior=torch.from_numpy(np.array(w["m_prior"])),
             cov=convert.gp_covariance_from_numpy(cov, device="cpu"))
    rng = np.random.default_rng(7)
    zen = rng.uniform(0.1, 0.4, 3)
    az = rng.uniform(0, 2 * np.pi, 3)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    ants = np.asarray(w["rays"].points[::w["n_dirs"], 0])
    o, d = jrays.make_ray_batch(ants, dirs)
    ho = jrays.sample_straight_rays(o, d, max_length_km=900.0, n_samples=65)
    want = np.asarray(jtec.dtec_paired(w["m_true"], w["grid"], ho, 3, 0))
    return w, p, cov, (ho, want)


def heldout(m):
    w, _, _, (ho, want) = world()
    pred = np.asarray(jtec.dtec_paired(jnp.asarray(np.asarray(m)),
                                       w["grid"], ho, 3, 0))
    return _rms(pred - want)


def assert_close(jres, tres, res_tol=RES_TOL, field_tol=FIELD_TOL):
    w = world()[0]
    jm, tm = np.asarray(jres.m), tres.m.numpy()
    mp = np.asarray(w["m_prior"])
    jr, tr = float(jres.residual_norm), float(tres.residual_norm)
    assert abs(tr - jr) <= res_tol * jr, (tr, jr)
    assert _rms(tm - jm) <= field_tol * _rms(jm - mp)
    hj, ht = heldout(jm), heldout(tm)
    assert abs(ht - hj) <= HELDOUT_TOL * hj, (ht, hj)
    assert hj < heldout(mp)


@functools.lru_cache(maxsize=None)
def robust_runs():
    """Both packages' robust solve on data with 4 unflagged spikes of 80σ,
    Huber threshold 10σ. The first round weighs the residual at the
    prior, past the threshold almost everywhere; the later rounds
    down-weight fewer samples. At 3σ and 40σ spikes nearly every sample
    stays down-weighted after cg 6 on this world, and the residual's
    dependence on the weights amplifies f32 rounding to 0.3 % by the
    third round (measured), so that setting is not a parity test."""
    w, p, cov, _ = world()
    d = np.array(w["d_obs"])
    spikes = [(0, 1), (2, 3), (5, 0), (7, 4)]
    for i, k in spikes:
        d[i, k] += 80.0 * float(w["noise_std"])
    kw = dict(num_directions=w["n_dirs"], gn_iters=1, cg_iters=CG,
              irls_iters=3, huber_k=10.0)
    jres = jsolvers.map_gauss_newton_robust(
        w["grid"], w["rays"], jnp.asarray(d), w["noise_std"], w["m_prior"],
        cov, **kw)
    tres = tsolvers.map_gauss_newton_robust(
        p["grid"], p["rays"], torch.from_numpy(d), p["noise_std"],
        p["m_prior"], p["cov"], **kw)
    return jres, tres, len(spikes)


def test_robust_gn_matches_jax():
    """The IRLS rounds' residuals within 1e-3 relative, the same count of
    down-weighted samples every round (at least the spikes), the field
    and held-out rms as in the module docstring."""
    jres, tres, n_spikes = robust_runs()
    np.testing.assert_allclose(tres.info[0].numpy(),
                               np.asarray(jres.info[0]), rtol=RES_TOL)
    np.testing.assert_array_equal(tres.info[1].numpy(),
                                  np.asarray(jres.info[1]))
    assert int(tres.info[1][-1]) >= n_spikes
    assert_close(jres, tres)


def test_robust_gn_warm_start_carries_the_departure():
    """warm_start: the rounds after the first continue the solve (the
    reference's contract, held to JAX by residual)."""
    w, p, cov, _ = world()
    kw = dict(num_directions=w["n_dirs"], gn_iters=1, cg_iters=CG,
              irls_iters=2, warm_start=True)
    jres = jsolvers.map_gauss_newton_robust(
        w["grid"], w["rays"], w["d_obs"], w["noise_std"], w["m_prior"],
        cov, **kw)
    tres = tsolvers.map_gauss_newton_robust(
        p["grid"], p["rays"], p["d_obs"], p["noise_std"], p["m_prior"],
        p["cov"], **kw)
    assert_close(jres, tres)


N_SAMPLES = 6


@functools.lru_cache(maxsize=None)
def posterior_runs():
    """Both packages' draws from one key: JAX draws inside, the port gets
    the same normals (the reference's split of its key)."""
    w, p, cov, _ = world()
    key = jax.random.key(5)
    n_data = int(np.prod(w["d_obs"].shape))
    k1, k2 = jax.random.split(key)
    eps = np.array(jax.random.normal(k1, (N_SAMPLES, n_data)))
    eta = np.array(jax.random.normal(k2, (N_SAMPLES,) + w["grid"].shape))
    kw = dict(num_directions=w["n_dirs"], cg_iters=CG)
    jout = jsolvers.posterior_samples(
        w["grid"], w["rays"], w["d_obs"], w["noise_std"], w["m_prior"], cov,
        key=key, n_samples=N_SAMPLES, **kw)
    tout = tsolvers.posterior_samples(
        p["grid"], p["rays"], p["d_obs"], p["noise_std"], p["m_prior"],
        p["cov"], data_noise=torch.from_numpy(eps),
        prior_noise=torch.from_numpy(eta), **kw)
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def test_posterior_samples_match_jax_with_its_draws():
    """The samples' departures from the prior, the mean's and the std
    within 1e-2 rms relative of the JAX package's (f32 CG at cg 6 over
    six systems batched on a member axis)."""
    j, t = posterior_runs()
    mp = np.asarray(world()[0]["m_prior"])
    for i, which in enumerate(["samples", "mean", "std"]):
        scale = _rms(j[i]) if which == "std" else _rms(j[i] - mp)
        assert _rms(t[i] - j[i]) <= 1e-2 * scale, which
        assert t[i].shape == j[i].shape


@functools.lru_cache(maxsize=None)
def batched_runs():
    """Two epochs with their own rays (the second set's directions
    rotated by 40° in azimuth) and data."""
    w, p, cov, _ = world()
    pts = np.asarray(w["rays"].points)
    ants = pts[::w["n_dirs"], 0]
    dirs = pts[:w["n_dirs"], -1] - pts[:w["n_dirs"], 0]
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    c, s = np.cos(0.7), np.sin(0.7)
    rot = dirs @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    o, d = jrays.make_ray_batch(ants, rot)
    rb2 = jrays.sample_straight_rays(o, d, max_length_km=900.0, n_samples=65)
    d2 = np.asarray(jtec.dtec_paired(w["m_true"], w["grid"], rb2,
                                     w["n_dirs"], 0))
    d2 = d2 + np.random.default_rng(3).normal(
        scale=float(w["noise_std"]), size=d2.shape)
    jseq = jrays.RayBundle(points=jnp.stack([w["rays"].points, rb2.points]),
                           ds=jnp.stack([w["rays"].ds, rb2.ds]))
    d_seq = np.stack([np.asarray(w["d_obs"]), d2]).astype(np.float32)
    kw = dict(num_directions=w["n_dirs"], gn_iters=2, cg_iters=CG)
    jres = jsolvers.map_gauss_newton_batched(
        w["grid"], jseq, jnp.asarray(d_seq), w["noise_std"], w["m_prior"],
        cov, **kw)
    tseq = _bundle(jseq)
    tres = tsolvers.map_gauss_newton_batched(
        p["grid"], tseq, torch.from_numpy(d_seq), p["noise_std"],
        p["m_prior"], p["cov"], **kw)
    return jres, tres, tseq, d_seq, kw


def test_batched_gn_matches_jax_and_the_per_snapshot_solves():
    """Each epoch against the JAX batch (residuals, fields, the residual
    history of the Gauss-Newton steps as the module docstring states),
    and bitwise the port's own snapshot solve of that epoch."""
    jres, tres, tseq, d_seq, kw = batched_runs()
    w, p = world()[:2]
    mp = np.asarray(w["m_prior"])
    for epoch in range(2):
        jr = float(jres.residual_norm[epoch])
        tr = float(tres.residual_norm[epoch])
        assert abs(tr - jr) <= RES_TOL * jr, (tr, jr)
        jm, tm = np.asarray(jres.m[epoch]), tres.m[epoch].numpy()
        assert _rms(tm - jm) <= FIELD_TOL * _rms(jm - mp)
    np.testing.assert_allclose(tres.info[0].numpy(), np.asarray(jres.info[0]),
                               rtol=RES_TOL)
    for t in range(2):
        one = tsolvers.map_gauss_newton(
            p["grid"], trays.RayBundle(tseq.points[t], tseq.ds[t]),
            torch.from_numpy(d_seq[t]), p["noise_std"], p["m_prior"],
            p["cov"], **kw)
        assert torch.equal(one.m, tres.m[t])
        assert torch.equal(one.residual_norm, tres.residual_norm[t])


@functools.lru_cache(maxsize=None)
def steepest_runs():
    w, p, cov, _ = world()
    kw = dict(num_directions=w["n_dirs"], n_iters=6)
    jres = jsolvers.steepest_descent_map(
        w["grid"], w["rays"], w["d_obs"], w["noise_std"], w["m_prior"], cov,
        **kw)
    tres = tsolvers.steepest_descent_map(
        p["grid"], p["rays"], p["d_obs"], p["noise_std"], p["m_prior"],
        p["cov"], **kw)
    return jres, tres


def test_steepest_descent_matches_jax():
    """The accepted objective of each iteration within 1e-4 relative (the
    line search picked the same ε every iteration on this world: a flip
    of a near-tie would show here as a jump), then the final residual and
    field as the module docstring states."""
    jres, tres = steepest_runs()
    jh, th = np.asarray(jres.info[0]), tres.info[0].numpy()
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    assert np.all(np.diff(th) <= 0)
    assert_close(jres, tres)


def test_dtec_paired_over_is_the_forward_of_the_linearisation():
    """``tec.dtec_paired_over`` (steepest's objectives and final residual):
    bit for bit the ``g0`` of the operator linearised about the same field
    over the same Simpson geometry, for one field and for a member axis of
    three, each member equal to its own forward; within 1e-6 of the
    largest |dTEC| of JAX's ``dtec_paired``; a Hermite geometry refused."""
    from ionotomo_tpu_torch.forward import tec as ttec

    w, p, _, _ = world()
    nd = w["n_dirs"]
    geo = ttec.DtecGeometry(p["grid"], p["rays"], nd, 0, "simpson", "cubic")
    rng = np.random.default_rng(11)
    ms = (p["m_prior"][None] + torch.from_numpy(
        0.2 * rng.normal(size=(3,) + p["grid"].shape).astype(np.float32)))
    one = ttec.dtec_paired_over(ms[0], geo)
    assert torch.equal(one, ttec.dtec_paired_linear(
        ms[0], p["grid"], p["rays"], nd, 0, "simpson", "cubic",
        geometry=geo).g0)
    batched = ttec.dtec_paired_over(ms, geo)
    assert batched.shape == (3, one.numel())
    assert torch.equal(batched, ttec.dtec_paired_linear(
        ms, p["grid"], p["rays"], nd, 0, "simpson", "cubic",
        geometry=geo).g0)
    for b in range(3):
        assert torch.equal(batched[b], ttec.dtec_paired_over(ms[b], geo))
    want = np.asarray(jtec.dtec_paired(jnp.asarray(ms[0].numpy()), w["grid"],
                                       w["rays"], nd, 0)).ravel()
    np.testing.assert_allclose(one.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="Simpson"):
        ttec.dtec_paired_over(ms[0], ttec.DtecGeometry(
            p["grid"], p["rays"], nd, 0, "hermite", "cubic"))


@pytest.mark.parametrize("shape,n", [((12, 10, 9), 5), ((16, 16, 16), 8)])
def test_fit_shell_spectrum_matches_jax(shape, n):
    """Elementwise within 2e-6 of the spectrum's largest value (f32 FFT
    rounding; every mode lands in the same shell in both packages)."""
    from ionotomo_tpu.core.grids import Grid3D as JGrid

    rng = np.random.default_rng(n)
    a = rng.normal(size=(n,) + shape).astype(np.float32)
    a -= a.mean(0)
    jg = JGrid.create(np.array([-50.0, -40.0, 0.0], np.float32),
                      np.array([7.5, 8.0, 30.0], np.float32), shape)
    j = np.asarray(jshell(jnp.asarray(a), jg))
    t = tshell(torch.from_numpy(a), convert.grid_from_numpy(jg, device="cpu"))
    assert t.shape == j.shape and float(t[0, 0, 0]) == 0.0
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-6 * j.max())
