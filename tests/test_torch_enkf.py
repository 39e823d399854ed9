"""``ensemble_kalman_filter`` of the port against the JAX package on the
CPU, on the world of ``tests/test_torch_kalman.py`` (12³, 6 × 4 rays, 3
steps, 4 members).

The port takes its randomness as arrays. ``jax_draws`` draws them with
JAX by the reference's own key derivation (``fold_in(key, 0x7FFFFFFF)``
then ``split`` for the initial ensemble; per global step
``fold_in(key, t)`` → ``split`` → ``k_adv``, ``k_obs``; ``fold_in(k_t,
2)`` for perturbed anchors), so both filters consume the same numbers.

Tolerances (shallow CG, see ``test_torch_kalman.py``): ensemble mean and
every final member within 1e-2 of their departure from the prior mean
(relative L2), the spread within 1e-2 relative L2, residuals 1e-3
relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion.kalman import (
    ensemble_kalman_filter as jenkf, initial_ensemble as jinitial)
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion.kalman import (
    ensemble_kalman_filter as tenkf, initial_ensemble as tinitial)

from tests.test_torch_kalman import NT, _anchors, inner_bundles, l2, world

torch.set_num_threads(2)

B = 4


def jax_draws(key, shape, n_rows, n_anchors=9, nt=NT, b=B):
    """The reference's draws for global steps 0 .. nt−1 as numpy arrays:
    init (B, *shape), process (nt, B, *shape), obs (nt, B, n_rows),
    anchor (nt, B, n_anchors)."""
    init_key = jax.random.fold_in(key, 0x7FFFFFFF)
    init = np.stack([np.asarray(jax.random.normal(k, shape))
                     for k in jax.random.split(init_key, b)])
    process, obs, anchor = [], [], []
    for t in range(nt):
        k_t = jax.random.fold_in(key, t)
        k_adv, k_obs = jax.random.split(k_t)
        process.append(np.stack([np.asarray(jax.random.normal(k, shape))
                                 for k in jax.random.split(k_adv, b)]))
        obs.append(np.asarray(jax.random.normal(k_obs, (b, n_rows))))
        anchor.append(np.asarray(jax.random.normal(
            jax.random.fold_in(k_t, 2), (b, n_anchors))))
    return init, np.stack(process), np.stack(obs), np.stack(anchor)


def run_both(key_seed, jkw=None, tkw=None, **kw):
    w, p = world()
    key = jax.random.key(key_seed)
    n_rows = int(np.prod(w["d_seq"].shape[1:]))
    init, process, obs, anchor = jax_draws(key, w["grid"].shape, n_rows)
    jwind, twind = kw.pop("jwind", w["wind"]), kw.pop("twind", p["wind"])
    jres = jenkf(w["grid"], w["rays_seq"], w["d_seq"], w["noise"], w["m_bg"],
                 w["cov"], jwind, w["dt_s"], w["n_dirs"], key, n_members=B,
                 **kw, **(jkw or {}))
    tkw = dict(tkw or {})
    if kw.get("process_sigma"):
        tkw["process_noise"] = torch.from_numpy(process)
    if tkw.pop("perturbed_anchors", False):
        tkw["anchor_noise"] = torch.from_numpy(anchor)
    tres = tenkf(p["grid"], p["rays_seq"], p["d_seq"], p["noise"], p["m_bg"],
                 p["cov"], twind, p["dt_s"], p["n_dirs"],
                 torch.from_numpy(obs), n_members=B,
                 init_noise=torch.from_numpy(init), **kw, **tkw)
    return jres, tres


def assert_same_enkf(jres, tres, tol=1e-2, res_tol=1e-3):
    w, _ = world()
    bg = np.asarray(w["m_bg"])
    jm, tm = np.asarray(jres.mean_seq), tres.mean_seq.numpy()
    js, ts = np.asarray(jres.std_seq), tres.std_seq.numpy()
    assert tm.shape == jm.shape and ts.shape == js.shape
    assert np.isfinite(tm).all() and (ts >= 0).all()
    np.testing.assert_allclose(tres.residuals.numpy(),
                               np.asarray(jres.residuals), rtol=res_tol)
    for t in range(jm.shape[0]):
        assert l2(tm[t] - jm[t]) <= tol * l2(jm[t] - bg), t
        assert l2(ts[t] - js[t]) <= tol * l2(js[t]), t
    je, te = np.asarray(jres.ensemble), tres.ensemble.numpy()
    assert te.shape == je.shape == (B,) + bg.shape
    for b in range(B):
        assert l2(te[b] - je[b]) <= tol * l2(je[b] - bg), b


def test_initial_ensemble_matches_jax():
    """Prior mean + C^{1/2} of the fed draws: 1e-6·max of the reference's
    ensemble from the same key."""
    w, p = world()
    key = jax.random.key(3)
    init, _, _, _ = jax_draws(key, w["grid"].shape, 1, nt=1)
    want = np.asarray(jinitial(w["grid"], w["cov"], w["m_bg"], key, B))
    got = tinitial(p["grid"], p["cov"], p["m_bg"], torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("interp", ["zp", "cubic"])
def test_enkf_matches_jax(interp):
    jres, tres = run_both(0, cg_iters=4, interp=interp)
    assert_same_enkf(jres, tres)
    assert tres.wind_seq is None and tres.innov_q is None
    # the biased spread (correction=0), as jnp's std
    assert float(tres.std_seq[-1].mean()) > 0


def test_enkf_calibration_controls_match_jax():
    """fade, inflation and C^{1/2}-correlated process noise (its draws
    fed in), with innovation statistics from the member forwards."""
    jres, tres = run_both(1, cg_iters=4, interp="zp", fade=0.95,
                          inflation=1.3, process_sigma=0.05,
                          innov_stats=True)
    assert_same_enkf(jres, tres)
    np.testing.assert_allclose(tres.innov_q.numpy(),
                               np.asarray(jres.innov_q), rtol=1e-2)


@pytest.mark.parametrize("form", ["sqrt", "stochastic"])
def test_enkf_anchor_forms_match_jax(form):
    """Both anchor updates of the predicted ensemble (anchor CG run to
    convergence: 12 iterations for 9 anchors): the square-root form and
    the perturbed-values form with the reference's draws."""
    w, p = world()
    ja, ta, _, jcov, tcov = _anchors(w, p, 500)
    jres, tres = run_both(
        2, cg_iters=4, interp="zp", anchor_update=form, anchor_cg_iters=12,
        jkw=dict(anchors=ja, anchor_cov=jcov),
        tkw=dict(anchors=ta, anchor_cov=tcov,
                 perturbed_anchors=form == "stochastic"))
    assert_same_enkf(jres, tres)


def test_enkf_mixed_fidelity_and_wind_adaptation_match_jax():
    """The coarse inner bundle for the members' Jacobian, and the wind
    refined on the ensemble mean (within 2e-3 km/s of the reference)."""
    w, _ = world()
    jinner, tinner = inner_bundles(w)
    wind0 = np.array([0.25, 0.05, 0.0], np.float32)
    jres, tres = run_both(3, cg_iters=4, interp="zp", wind_adapt_iters=1,
                          jwind=jnp.asarray(wind0), twind=wind0,
                          jkw=dict(rays_inner_seq=jinner),
                          tkw=dict(rays_inner_seq=tinner))
    assert_same_enkf(jres, tres, tol=3e-2, res_tol=3e-3)
    np.testing.assert_allclose(tres.wind_seq.numpy(),
                               np.asarray(jres.wind_seq), rtol=0, atol=2e-3)


def test_enkf_chunked_run_equals_one_call_bitwise():
    """Restart identity: 3 steps in one call, and 1 + 2 chained through
    ``ens0``, ``advect_first=True``, ``m_clim`` and ``step_offset`` over
    the same noise arrays, agree bit for bit; twice the same run too."""
    w, p = world()
    key = jax.random.key(4)
    init, process, obs, _ = jax_draws(
        key, w["grid"].shape, int(np.prod(w["d_seq"].shape[1:])))
    kw = dict(n_members=B, cg_iters=4, interp="zp", fade=0.95, inflation=1.1,
              process_sigma=0.05, process_noise=torch.from_numpy(process),
              geometry_cache={})

    def run(t0, t1, **more):
        return tenkf(
            p["grid"], trays.RayBundle(p["rays_seq"].points[t0:t1],
                                       p["rays_seq"].ds[t0:t1]),
            p["d_seq"][t0:t1], p["noise"], p["m_bg"], p["cov"], p["wind"],
            p["dt_s"], p["n_dirs"], torch.from_numpy(obs), **kw, **more)

    one = run(0, NT, init_noise=torch.from_numpy(init))
    a = run(0, 1, init_noise=torch.from_numpy(init))
    b = run(1, NT, ens0=a.ensemble, advect_first=True, m_clim=p["m_bg"],
            step_offset=1)
    assert torch.equal(one.ensemble, b.ensemble)
    assert torch.equal(one.mean_seq, torch.cat([a.mean_seq, b.mean_seq]))
    assert torch.equal(one.std_seq, torch.cat([a.std_seq, b.std_seq]))
    assert torch.equal(one.residuals, torch.cat([a.residuals, b.residuals]))
    again = run(0, NT, init_noise=torch.from_numpy(init))
    assert torch.equal(one.ensemble, again.ensemble)


def test_enkf_refuses_what_is_not_ported_or_not_fed():
    _, p = world()
    args = (p["grid"], p["rays_seq"], p["d_seq"], p["noise"], p["m_bg"],
            p["cov"], p["wind"], p["dt_s"], p["n_dirs"],
            torch.zeros((NT, B, 24)))
    init = torch.zeros((B,) + p["grid"].shape)
    with pytest.raises(NotImplementedError, match="spectrum_blend"):
        tenkf(*args, n_members=B, init_noise=init, spectrum_blend=0.5)
    with pytest.raises(ValueError, match="ens0 or init_noise"):
        tenkf(*args, n_members=B)
    with pytest.raises(ValueError, match="n_members"):
        tenkf(*args, n_members=B + 1, init_noise=init)
    with pytest.raises(ValueError, match="process_noise"):
        tenkf(*args, n_members=B, init_noise=init, process_sigma=0.1)
