"""Parity of the port's inversion solvers with the JAX package on the zp
field model, on the miniature world of ``tests/test_solvers.py`` (20³,
12 antennas × 8 directions, 65-sample straight rays, data from the JAX
forward of a blob truth plus noise). Both packages get the same inputs.

Solvers are compared by norms, not elementwise: truncated Krylov
iterations amplify f32 rounding. Measured on this world: a 1e-7 relative
perturbation of the data moves the port's own Gauss-Newton residual by up
to 1 % after 20 CG iterations, and by 2e-4 after 12; LSQR's by 0.5 % at
30 to 60 iterations and 4e-6 at 20. So the solves run at 12 CG and 20
LSQR iterations, where the two packages' arithmetic still agrees, and
must give: the final whitened residual within 1e-3 relative of JAX, and
rms(m_port − m_jax) ≤ 1e-2·rms(m_jax − m_prior). They must also beat the
prior as the JAX package's own tests require of it.
"""
import numpy as np
import pytest
import torch

from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import solvers as tsolvers

from tests.test_solvers import inversion_world

torch.set_num_threads(2)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _port(w):
    """The world's inputs as the port takes them."""
    rb = w["rays"]
    return dict(grid=convert.grid_from_numpy(w["grid"], device="cpu"),
                rays=trays.RayBundle(torch.from_numpy(np.array(rb.points)),
                                     torch.from_numpy(np.array(rb.ds))),
                d_obs=torch.from_numpy(np.array(w["d_obs"])),
                noise_std=float(w["noise_std"]),
                m_prior=torch.from_numpy(np.array(w["m_prior"])))


def _compare(jres, tres, w):
    jm, tm = np.asarray(jres.m), tres.m.numpy()
    mp, mt = np.asarray(w["m_prior"]), np.asarray(w["m_true"])
    jr, tr = float(jres.residual_norm), float(tres.residual_norm)
    assert abs(tr - jr) <= 1e-3 * jr, (tr, jr)
    assert _rms(tm - jm) <= 1e-2 * _rms(jm - mp)
    return _rms(mp - mt), _rms(tm - mt)


def _inner_bundles(w):
    ants_dirs = w["rays"].points[:, 0], w["rays"].points[:, -1]
    o = np.asarray(ants_dirs[0])
    d = np.asarray(ants_dirs[1]) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jb = jrays.sample_straight_rays(o, d, max_length_km=900.0, n_samples=33)
    return jb, trays.RayBundle(torch.from_numpy(np.array(jb.points)),
                               torch.from_numpy(np.array(jb.ds)))


# How far each variant must beat the prior: the bounds of the JAX
# package's own tests of the same options (test_solvers.py).
BEATS_PRIOR = {"cold": 0.6, "warm_start": 1.0, "inner": 0.95}


@pytest.mark.parametrize("variant", sorted(BEATS_PRIOR))
def test_map_gauss_newton_zp_matches_jax(variant):
    w = inversion_world(seed=1)
    p = _port(w)
    cov = JGPCovariance.create(w["grid"], sigma=0.3, length_scale=90.0,
                               kind="sqexp")
    kw = dict(num_directions=w["n_dirs"], gn_iters=2, cg_iters=12,
              interp="zp")
    jkw, tkw = dict(kw), dict(kw)
    if variant == "warm_start":
        jkw["warm_start"] = tkw["warm_start"] = True
    if variant == "inner":
        jb, tb = _inner_bundles(w)
        jkw.update(rays_inner=jb, interp_inner="zp3")
        tkw.update(rays_inner=tb, interp_inner="zp3")
    jres = jsolvers.map_gauss_newton(w["grid"], w["rays"], w["d_obs"],
                                     w["noise_std"], w["m_prior"], cov, **jkw)
    tres = tsolvers.map_gauss_newton(
        p["grid"], p["rays"], p["d_obs"], p["noise_std"], p["m_prior"],
        convert.gp_covariance_from_numpy(cov, device="cpu"), **tkw)
    err_prior, err_post = _compare(jres, tres, w)
    assert err_post < BEATS_PRIOR[variant] * err_prior
    np.testing.assert_array_equal(tres.info[1].numpy(),
                                  np.asarray(jres.info[1]))
    assert (tres.u_final is not None) == (variant == "warm_start")
    if variant == "warm_start":
        # the substitution invariant m = m_prior + C^{1/2} u_final
        tcov = convert.gp_covariance_from_numpy(cov, device="cpu")
        recon = p["m_prior"] + tcov.apply_sqrt(
            tres.u_final.reshape(p["grid"].shape))
        np.testing.assert_allclose(recon.numpy(), tres.m.numpy(), rtol=0,
                                   atol=1e-5)
        assert _rms(tres.u_final.numpy() - np.asarray(jres.u_final)) \
            <= 1e-2 * _rms(np.asarray(jres.u_final))


def test_lsqr_smoothness_zp_matches_jax():
    w = inversion_world()
    p = _port(w)
    kw = dict(num_directions=w["n_dirs"], damp=3e-3, smooth=0.2,
              max_iters=20, interp="zp")
    jres = jsolvers.lsqr_smoothness(w["grid"], w["rays"], w["d_obs"],
                                    w["noise_std"], w["m_prior"], **kw)
    tres = tsolvers.lsqr_smoothness(p["grid"], p["rays"], p["d_obs"],
                                    p["noise_std"], p["m_prior"], **kw)
    err_prior, err_post = _compare(jres, tres, w)
    assert err_post < 0.92 * err_prior
    g0, g1 = (ttec.dtec_paired(m, p["grid"], p["rays"], w["n_dirs"], 0, "zp")
              for m in (p["m_prior"], tres.m))
    r0 = float(torch.linalg.norm(g0 - p["d_obs"]))
    r1 = float(torch.linalg.norm(g1 - p["d_obs"]))
    assert r1 < 0.12 * r0
    assert int(tres.info[0].iterations) == int(jres.info[0].iterations)


def test_linearised_forward_matches_the_forward():
    """J of the operator against a central difference of dtec_paired_q
    (the contract the JAX package gets from jax.linearize)."""
    w = inversion_world(nx=12, n_ants=4, n_dirs=3)
    p = _port(w)
    op = ttec.dtec_paired_linear(p["m_prior"], p["grid"], p["rays"], 3, 0,
                                 "hermite", "zp")
    dm = torch.from_numpy(np.random.default_rng(0).normal(
        size=p["grid"].shape).astype(np.float32))
    eps = 1e-2
    fwd = [ttec.dtec_paired_q(p["m_prior"] + s * eps * dm, p["grid"],
                              p["rays"], 3, 0, "hermite", "zp").reshape(-1)
           for s in (1.0, -1.0)]
    fd = (fwd[0] - fwd[1]) / (2 * eps)
    jdm = op.apply(dm)
    assert float((jdm - fd).abs().max()) <= 2e-3 * float(fd.abs().max())


@pytest.mark.parametrize("which", ["anchors", "probes"])
def test_anchor_and_probe_rows_are_not_ported(which):
    w = inversion_world(nx=8, n_ants=3, n_dirs=2)
    p = _port(w)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolvers.anchored_forward(p["grid"], p["rays"], 2, 0,
                                  **{which: object()}, interp="zp")
    cov = convert.gp_covariance_from_numpy(
        JGPCovariance.create(w["grid"], sigma=0.3, length_scale=90.0),
        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolvers.map_gauss_newton(p["grid"], p["rays"], p["d_obs"],
                                  p["noise_std"], p["m_prior"], cov, 2,
                                  interp="zp", **{which: object()})
