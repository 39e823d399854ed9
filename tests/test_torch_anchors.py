"""``ionotomo_tpu_torch.inversion.anchors`` against the JAX package on the
CPU: the geometry builders bit for bit, the anchor and probe updates (a
prior mean and an ensemble) by their data residual and the relative L2
difference of the updated fields, and ``map_gauss_newton`` with anchor
and probe rows.

Tolerances: solver outputs are compared by norms, not element by element
(CG amplifies last-ulp differences, most of all when it is truncated
among the few widely spread eigenvalues of an anchor system, so the
solves here run to convergence): final whitened residuals within 1e-3 of
the residual the update started from (5e-3 relative for the joint solve),
the update itself within 1e-2 of its own size (relative L2 of the
difference over the update's L2).
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.data.ionosonde import NeProbes
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.inversion import anchors as janchors, solvers as jsolvers
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import anchors as tanchors
from ionotomo_tpu_torch.inversion import solvers as tsolvers

from tests.test_solvers import inversion_world
from tests.test_torch_solvers import _port, _rms

torch.set_num_threads(2)


def _tbundle(jb):
    return trays.RayBundle(torch.from_numpy(np.array(jb.points)),
                           torch.from_numpy(np.array(jb.ds)))


def _world(nx=12, seed=0):
    w = inversion_world(nx=nx, n_ants=5, n_dirs=4, seed=seed)
    p = _port(w)
    return w, p, w["grid"], p["grid"]


def _assert_bundles_equal(tb, jb):
    np.testing.assert_array_equal(tb.points.numpy(), np.asarray(jb.points))
    np.testing.assert_array_equal(tb.ds.numpy(), np.asarray(jb.ds))
    assert tb.points.dtype == tb.ds.dtype == torch.float32


def test_geometry_builders_are_bit_identical():
    _, _, jg, tg = _world()
    rng = np.random.default_rng(300)
    xy = rng.uniform(-60, 60, (7, 2))
    _assert_bundles_equal(tanchors.columns_bundle(tg, xy, 33),
                          janchors.columns_bundle(jg, xy, 33))
    _assert_bundles_equal(tanchors.vertical_anchor_bundle(tg, 3, 4, 21, 0.2),
                          janchors.vertical_anchor_bundle(jg, 3, 4, 21, 0.2))
    az, el = rng.uniform(0, 2 * np.pi, 7), rng.uniform(0.3, 1.5, 7)
    _assert_bundles_equal(tanchors.slant_bundle(tg, xy, az, el, 17),
                          janchors.slant_bundle(jg, xy, az, el, 17))
    np.testing.assert_array_equal(tanchors.thin_shell_mapping(el, 400.0),
                                  janchors.thin_shell_mapping(el, 400.0))
    with pytest.raises(ValueError, match="elevation below 10 deg"):
        tanchors.slant_bundle(tg, xy, 0.0, np.deg2rad(5.0))


def test_anchors_from_npz_matches_and_refuses_outside_points(tmp_path):
    _, _, jg, tg = _world()
    path = tmp_path / "anchors.npz"
    xy = np.array([[10.0, -20.0], [-35.0, 40.0]])
    np.savez(path, points_xy=xy, values_tecu=np.array([12.5, 9.0]),
             noise_tecu=0.5)
    ta, ja = tanchors.anchors_from_npz(tg, path, 17), \
        janchors.anchors_from_npz(jg, path, 17)
    _assert_bundles_equal(ta.rays, ja.rays)
    np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ja.values))
    assert float(ta.noise_std) == float(ja.noise_std)
    np.savez(path, points_xy=xy * 1e3, values_tecu=np.array([12.5, 9.0]),
             noise_tecu=0.5)
    with pytest.raises(ValueError, match="outside the"):
        tanchors.anchors_from_npz(tg, path)


def test_background_covariance_matches_jax():
    """Spectrum within 1e-6·max (both built in f64 numpy, stored f32)."""
    _, _, jg, tg = _world()
    tc = tanchors.background_covariance(tg, 0.7, 90.0)
    jc = janchors.background_covariance(jg, 0.7, 90.0)
    assert tc.kind == jc.kind == "sqexp"
    np.testing.assert_allclose(tc.spectrum.numpy(), np.asarray(jc.spectrum),
                               rtol=0, atol=1e-6 * float(jc.spectrum.max()))


def _anchor_case(seed, quadrature="simpson", interp="cubic"):
    """A prior mean off the truth's level, anchors simulated from the
    truth with noise drawn by numpy (fed to both packages)."""
    w, p, jg, tg = _world(seed=seed)
    rng = np.random.default_rng(seed)
    jb = janchors.vertical_anchor_bundle(jg, 3, 3, 33)
    tb = tanchors.vertical_anchor_bundle(tg, 3, 3, 33)
    truth = np.asarray(w["m_true"]) + 0.15
    clean = np.asarray(jtec.tec(jnp.asarray(truth), jg, jb))
    noise_std = 2e-2 * float(np.abs(clean).max())
    unit = rng.normal(size=clean.shape).astype(np.float32)
    ta = tanchors.anchors_from_field(torch.from_numpy(truth), tg, tb,
                                     noise_std, unit)
    ja = janchors.TecAnchors(rays=jb, values=jnp.asarray(ta.values.numpy()),
                             noise_std=jnp.float32(noise_std))
    np.testing.assert_allclose(ta.values.numpy(), clean + noise_std * unit,
                               rtol=2e-6)
    jcov = janchors.background_covariance(jg, 0.5)
    tcov = convert.gp_covariance_from_numpy(jcov, device="cpu")
    return w, p, jg, tg, ja, ta, jcov, tcov


def _anchor_residual(m, jg, ja):
    r = (np.asarray(jtec.tec(jnp.asarray(m), jg, ja.rays))
         - np.asarray(ja.values)) / float(ja.noise_std)
    return float(np.linalg.norm(r))


def _assert_same_residual(r_t, r_j, r_0):
    """Final whitened residuals agree to 1e-3 of the residual the update
    started from (an update that cuts it 100-fold leaves a small
    difference of large numbers)."""
    assert abs(r_t - r_j) <= 1e-3 * r_0, (r_t, r_j, r_0)


def _assert_same_update(tm, jm, base, tol=1e-2):
    """The port's update equals the reference's to ``tol`` of its size."""
    tm, jm, base = (np.asarray(x) for x in (tm, jm, base))
    assert np.isfinite(tm).all()
    assert _rms(tm - jm) <= tol * _rms(jm - base), (_rms(tm - jm),
                                                    _rms(jm - base))


@pytest.mark.parametrize("quadrature,interp", [("simpson", "cubic"),
                                               ("hermite", "zp")])
@pytest.mark.parametrize("pull", [False, True], ids=["at_mk", "at_prior"])
def test_anchor_map_step_matches_jax(quadrature, interp, pull):
    w, p, jg, tg, ja, ta, jcov, tcov = _anchor_case(301)
    m_k = np.asarray(w["m_prior"]) + 0.05
    inv_cd = 1.0 / np.full(ja.values.shape, float(ja.noise_std) ** 2,
                           np.float32)
    jm = janchors.anchor_map_step(
        jg, jnp.asarray(m_k), jcov, ja.rays, ja.values, jnp.asarray(inv_cd),
        15, 1e-5, m_pull=(w["m_prior"] if pull else None),
        quadrature=quadrature, interp=interp)
    tm = tanchors.anchor_map_step(
        tg, torch.from_numpy(m_k), tcov, ta.rays, ta.values,
        torch.from_numpy(inv_cd), 15, 1e-5,
        m_pull=(p["m_prior"] if pull else None), quadrature=quadrature,
        interp=interp)
    _assert_same_update(tm, jm, m_k)
    r_0 = _anchor_residual(m_k, jg, ja)
    r_t, r_j = _anchor_residual(tm.numpy(), jg, ja), \
        _anchor_residual(jm, jg, ja)
    _assert_same_residual(r_t, r_j, r_0)
    assert r_j < r_0


def test_assimilate_anchors_matches_jax():
    w, p, jg, tg, ja, ta, jcov, tcov = _anchor_case(302)
    jm = janchors.assimilate_anchors(jg, w["m_prior"], jcov, ja, gn_iters=2,
                                     cg_iters=15)
    tm = tanchors.assimilate_anchors(tg, p["m_prior"], tcov, ta, gn_iters=2,
                                     cg_iters=15)
    _assert_same_update(tm, jm, w["m_prior"])
    r0 = _anchor_residual(np.asarray(w["m_prior"]), jg, ja)
    r_t, r_j = _anchor_residual(tm.numpy(), jg, ja), \
        _anchor_residual(jm, jg, ja)
    _assert_same_residual(r_t, r_j, r0)
    assert r_t < 0.2 * r0


def _ensemble(w, seed, n=4):
    rng = np.random.default_rng(seed)
    return (np.asarray(w["m_prior"])[None]
            + 0.1 * rng.normal(size=(n,) + w["grid"].shape)
            ).astype(np.float32)


def test_anchor_sqrt_update_matches_jax():
    """Mean and every member against the reference's vmapped anomaly
    solves (here one batched CG of B + 1 systems); the anomalies
    contract."""
    w, p, jg, tg, ja, ta, jcov, tcov = _anchor_case(303)
    ens = _ensemble(w, 303)
    inv_cd = 1.0 / np.full(ja.values.shape, float(ja.noise_std) ** 2,
                           np.float32)
    je = np.asarray(janchors.anchor_sqrt_update(
        jg, jnp.asarray(ens), jcov, ja.rays, ja.values, jnp.asarray(inv_cd),
        15, 1e-5, quadrature="hermite", interp="zp"))
    te = tanchors.anchor_sqrt_update(
        tg, torch.from_numpy(ens), tcov, ta.rays, ta.values,
        torch.from_numpy(inv_cd), 15, 1e-5, quadrature="hermite",
        interp="zp").numpy()
    assert te.shape == ens.shape
    _assert_same_update(te.mean(0), je.mean(0), ens.mean(0))
    for b in range(ens.shape[0]):
        _assert_same_update(te[b], je[b], ens[b])
    r_t, r_j = _anchor_residual(te.mean(0), jg, ja), \
        _anchor_residual(je.mean(0), jg, ja)
    _assert_same_residual(r_t, r_j, _anchor_residual(ens.mean(0), jg, ja))


def _probes(w, jg, seed, n=12):
    rng = np.random.default_rng(seed)
    lo = np.asarray(jg.origin) + 2 * np.asarray(jg.spacing)
    hi = np.asarray(jg.origin) + (np.asarray(jg.shape) - 3) * np.asarray(
        jg.spacing)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    truth = np.asarray(w["m_true"]) + 0.15
    vals = np.asarray(jtec.log_ne_at(jnp.asarray(truth), jg,
                                     jnp.asarray(pts), "cubic"))
    vals = (vals + 0.01 * rng.normal(size=n)).astype(np.float32)
    return SimpleNamespace(points=pts, values=vals, noise_std=0.01)


def _jprobes(pr):
    return NeProbes(points=jnp.asarray(pr.points),
                    values=jnp.asarray(pr.values),
                    noise_std=jnp.float32(pr.noise_std))


def test_assimilate_probes_and_probe_sqrt_update_match_jax():
    """Probes are duck-typed on points/values/noise_std; the default
    covariance is the 80 km-vertical background covariance."""
    w, p, jg, tg = _world(seed=304)
    pr = _probes(w, jg, 304)
    jm = janchors.assimilate_probes(jg, w["m_prior"], _jprobes(pr),
                                    gn_iters=2, cg_iters=15)
    tm = tanchors.assimilate_probes(tg, p["m_prior"], pr, gn_iters=2,
                                    cg_iters=15)
    _assert_same_update(tm, jm, w["m_prior"])

    def resid(m):
        g = np.asarray(jtec.log_ne_at(jnp.asarray(m), jg,
                                      jnp.asarray(pr.points), "cubic"))
        return float(np.linalg.norm((g - pr.values) / pr.noise_std))

    r_0 = resid(np.asarray(w["m_prior"]))
    _assert_same_residual(resid(tm.numpy()), resid(jm), r_0)
    assert resid(tm.numpy()) < 0.5 * r_0
    ens = _ensemble(w, 304)
    je = np.asarray(janchors.probe_sqrt_update(jg, jnp.asarray(ens),
                                               _jprobes(pr), cg_iters=15))
    te = tanchors.probe_sqrt_update(tg, torch.from_numpy(ens), pr,
                                    cg_iters=15).numpy()
    _assert_same_update(te.mean(0), je.mean(0), ens.mean(0))
    for b in range(ens.shape[0]):
        _assert_same_update(te[b], je[b], ens[b])


@pytest.mark.parametrize("which", ["anchors", "probes", "both"])
def test_map_gauss_newton_with_extra_rows_matches_jax(which):
    """[dTEC, anchors, probes] rows in one solve, CG run to convergence
    (45 iterations for at most 41 rows): final whitened residual within
    5e-3 relative (it is ~1 % of the residual at the prior) and the field
    within 1e-2 of the update's size; the stacked forward equals the
    reference's to 1e-5·max."""
    w, p, jg, tg, ja, ta, _, _ = _anchor_case(305)
    pr = _probes(w, jg, 305)
    jkw, tkw = {}, {}
    if which in ("anchors", "both"):
        jkw["anchors"], tkw["anchors"] = ja, ta
    if which in ("probes", "both"):
        jkw["probes"] = _jprobes(pr)
        tkw["probes"] = SimpleNamespace(points=torch.from_numpy(pr.points),
                                        values=torch.from_numpy(pr.values),
                                        noise_std=pr.noise_std)
    jcov = JGPCovariance.create(jg, sigma=0.3, length_scale=90.0)
    tcov = convert.gp_covariance_from_numpy(jcov, device="cpu")
    nd = w["n_dirs"]
    jf = np.asarray(jsolvers.anchored_forward(
        jg, w["rays"], nd, 0, quadrature="hermite", interp="zp", **jkw)(
            w["m_true"]))
    tf = tsolvers.anchored_forward(
        tg, p["rays"], nd, 0, quadrature="hermite", interp="zp", **tkw)(
            torch.from_numpy(np.array(w["m_true"]))).numpy()
    assert tf.shape == jf.shape
    n_extra = (9 if "anchors" in jkw else 0) + (12 if "probes" in jkw else 0)
    assert tf.shape[0] == 5 * nd + n_extra
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5 * np.abs(jf).max())
    kw = dict(gn_iters=2, cg_iters=45, quadrature="hermite", interp="zp")
    jres = jsolvers.map_gauss_newton(jg, w["rays"], w["d_obs"],
                                     w["noise_std"], w["m_prior"], jcov, nd,
                                     **kw, **jkw)
    tres = tsolvers.map_gauss_newton(tg, p["rays"], p["d_obs"],
                                     p["noise_std"], p["m_prior"], tcov, nd,
                                     **kw, **tkw)
    jr, tr = float(jres.residual_norm), float(tres.residual_norm)
    assert abs(tr - jr) <= 5e-3 * jr, (tr, jr)
    _assert_same_update(tres.m, jres.m, w["m_prior"])
    # the plain-version route stacks the plain anchor operator
    tref = tsolvers.map_gauss_newton(
        tg, p["rays"], p["d_obs"], p["noise_std"], p["m_prior"], tcov, nd,
        linearize=ttec.dtec_paired_linear_ref, **kw, **tkw)
    np.testing.assert_array_equal(tref.m.numpy(), tres.m.numpy())
