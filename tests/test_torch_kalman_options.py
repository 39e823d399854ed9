"""``kalman_filter``'s options against the JAX package on the CPU, on
``test_torch_kalman.py``'s world and helpers (12³, 6 × 4 rays, 3 steps,
cg 5-6; the tolerances that file states): anchor sub-updates, innovation
statistics from fed probes, wind adaptation, the chunked-run restart
identity and the plain-version route. A file of its own so that the
filter's tests run on two workers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion.kalman import kalman_filter as tkalman

from tests.test_torch_kalman import (NT, _anchors, assert_same_filter,
                                     inner_bundles, run_both, world)

torch.set_num_threads(2)


@pytest.mark.parametrize("per_epoch", [False, True])
def test_anchored_filter_matches_jax(per_epoch):
    """Anchor sub-update of every step's prediction (run to convergence:
    12 iterations for 9 anchors), the same values every epoch or per-epoch
    values."""
    w, p = world()
    ja, ta, vals, jcov, tcov = _anchors(w, p, 401)
    jkw = dict(anchors=ja, anchor_cov=jcov)
    tkw = dict(anchors=ta, anchor_cov=tcov)
    if per_epoch:
        jkw["anchor_values_seq"] = jnp.asarray(vals)
        tkw["anchor_values_seq"] = torch.from_numpy(vals)
    jres, tres = run_both(jkw=jkw, tkw=tkw, cg_iters=6, anchor_cg_iters=12,
                          interp="zp")
    assert_same_filter(jres, tres)
    with pytest.raises(ValueError, match="anchor_cov"):
        run_both(jkw=jkw, tkw=dict(anchors=ta), cg_iters=6,
                 anchor_cg_iters=12, interp="zp")


def test_innov_stats_with_fed_probes_match_jax():
    """The probe draws of the reference (``fold_in(stats_key, t)``, then
    ``normal(k, (probes,) + shape)``) are drawn here with JAX and fed to
    the port. ρ̂² within 1e-2 relative (a ratio of sums over 24 rows)."""
    w, _ = world()
    key = jax.random.key(7)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, t), (2,) + w["grid"].shape))
        for t in range(NT)])
    jres, tres = run_both(cg_iters=6, interp="zp", innov_stats=True,
                          jkw=dict(stats_key=key, stats_probes=2),
                          tkw=dict(stats_noise=torch.from_numpy(noise)))
    assert_same_filter(jres, tres)
    assert tres.innov_q.shape == (NT,)
    np.testing.assert_allclose(tres.innov_q.numpy(),
                               np.asarray(jres.innov_q), rtol=1e-2)
    with pytest.raises(ValueError, match="stats_noise"):
        run_both(nt=1, cg_iters=2, interp="zp", innov_stats=True,
                 jkw=dict(stats_key=key))


@pytest.mark.parametrize("kind", ["rigid", "shear", "free_vz"])
def test_wind_adaptation_matches_jax(kind):
    """Damped Gauss-Newton on the innovation from a wrong initial wind:
    the refined wind per step within 2e-3 km/s of the reference's (its
    Jacobian columns are analytic tangents here, forward-mode tangents
    there), the first step keeps the initial wind, masked components do
    not move, and the filter agrees as usual."""
    wind0 = np.array([0.25, 0.05, 0.0], np.float32)
    kw = dict(cg_iters=6, interp="zp", wind_adapt_iters=2, fade=0.95,
              wind_adapt_horizontal=kind != "free_vz")
    if kind == "shear":
        wind0 = np.stack([wind0, np.array([0.03, -0.02, 0.0], np.float32)])
    jres, tres = run_both(jwind=jnp.asarray(wind0), twind=wind0, **kw)
    jw, tw = np.asarray(jres.wind_seq), tres.wind_seq.numpy()
    assert tw.shape == jw.shape == (NT,) + wind0.shape
    np.testing.assert_array_equal(tw[0], wind0)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=2e-3)
    assert np.abs(tw[-1] - wind0).max() > 1e-3          # it did move
    if kind != "free_vz":
        np.testing.assert_array_equal(tw[..., 2], np.broadcast_to(
            wind0[..., 2], tw.shape[:-1]))
    assert_same_filter(jres, tres, state_tol=3e-2, res_tol=3e-3)


@pytest.mark.parametrize("adapt", [0, 1])
def test_chunked_run_equals_one_call_bitwise(adapt):
    """Restart identity: 3 steps in one call, and 1 + 2 chained through
    ``advect_first=True, m_clim=m_bg`` (and the carried wind), agree bit
    for bit; a shared ``geometry_cache`` holds one geometry per bundle and
    field model for the whole run."""
    w, p = world()
    _, inner = inner_bundles(w)
    cache = {}
    kw = dict(num_directions=p["n_dirs"], cg_iters=5, fade=0.95, interp="zp",
              wind_adapt_iters=adapt, geometry_cache=cache)

    def run(t0, t1, m0, wind, **more):
        return tkalman(
            p["grid"], trays.RayBundle(p["rays_seq"].points[t0:t1],
                                       p["rays_seq"].ds[t0:t1]),
            p["d_seq"][t0:t1], p["noise"], m0, p["cov"], wind, p["dt_s"],
            rays_inner_seq=trays.RayBundle(inner.points[t0:t1],
                                           inner.ds[t0:t1]), **kw, **more)

    one = run(0, NT, p["m_bg"], p["wind"])
    a = run(0, 1, p["m_bg"], p["wind"])
    b = run(1, NT, a.m_seq[-1], a.wind_seq[-1] if adapt else p["wind"],
            advect_first=True, m_clim=p["m_bg"])
    assert len(cache) == 2                     # the outer and inner bundles
    assert torch.equal(one.m_seq, torch.cat([a.m_seq, b.m_seq]))
    assert torch.equal(one.residuals, torch.cat([a.residuals, b.residuals]))
    assert torch.equal(one.post_residuals,
                       torch.cat([a.post_residuals, b.post_residuals]))
    if adapt:
        assert torch.equal(one.wind_seq, torch.cat([a.wind_seq, b.wind_seq]))
    again = run(0, NT, p["m_bg"], p["wind"])
    assert torch.equal(one.m_seq, again.m_seq)


def test_plain_version_route_is_the_same_filter_on_the_cpu():
    """``linearize=dtec_paired_linear_ref``: on CPU tensors the kernel
    route already takes the plain versions, so the two agree bitwise."""
    _, p = world()
    kw = dict(num_directions=p["n_dirs"], cg_iters=3, interp="zp")
    args = (p["grid"], trays.RayBundle(p["rays_seq"].points[:2],
                                       p["rays_seq"].ds[:2]),
            p["d_seq"][:2], p["noise"], p["m_bg"], p["cov"], p["wind"],
            p["dt_s"])
    a = tkalman(*args, **kw)
    b = tkalman(*args, linearize=ttec.dtec_paired_linear_ref, **kw)
    assert torch.equal(a.m_seq, b.m_seq)
