"""``ionotomo_tpu_torch.inversion.kalman.kalman_filter`` against the JAX
package on the CPU, on ``tests/test_kalman.py``'s moving-blob world at a
smaller size (12³, 6 × 4 rays, 3 steps).

Filters are not compared element by element over many steps (truncated CG
amplifies last-ulp differences): one step at cg 3 is held tightly (the
state within 1e-3 of the update's own L2 size), longer runs by their
whitened residuals (1e-3 relative) and the state's relative L2 difference
(1e-2 of the update's size), at CG depths of 3 to 6: on this 24-row
world f32 CG loses its accuracy past ~6 iterations in either package
(measured: the one-step state difference over the update's size is
4e-6 at cg 3 and 5, 3e-4 at cg 8, 2e-3 at cg 12). Each JAX variant
compiles once.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import anchors as janchors
from ionotomo_tpu.inversion.kalman import kalman_filter as jkalman
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import anchors as tanchors
from ionotomo_tpu_torch.inversion.kalman import kalman_filter as tkalman

from tests.test_kalman import moving_world

torch.set_num_threads(2)

NT = 3


@functools.lru_cache(maxsize=None)
def world():
    """The JAX world and its port: (w, p). The port's bundle is expanded
    along the time axis (one geometry for all steps)."""
    w = moving_world(nx=12, n_ants=6, n_dirs=4, nt=NT, seed=0)
    w["cov"] = JGPCovariance.create(w["grid"], sigma=0.3, length_scale=80.0,
                                    kind="sqexp")
    pts = torch.from_numpy(np.array(w["rays_seq"].points[0]))
    ds = torch.from_numpy(np.array(w["rays_seq"].ds[0]))
    p = dict(grid=convert.grid_from_numpy(w["grid"], device="cpu"),
             rays_seq=trays.RayBundle(pts.expand(NT, *pts.shape),
                                      ds.expand(NT, *ds.shape)),
             d_seq=torch.from_numpy(np.array(w["d_seq"])),
             noise=float(w["noise"]),
             m_bg=torch.from_numpy(np.array(w["m_bg"])),
             cov=convert.gp_covariance_from_numpy(w["cov"], device="cpu"),
             wind=np.asarray(w["wind"], np.float32), dt_s=w["dt_s"],
             n_dirs=w["n_dirs"])
    return w, p


def inner_bundles(w, n_samples=25):
    """The coarser bundle over the same rays, for both packages."""
    pts = np.asarray(w["rays_seq"].points[0])
    o = pts[:, 0]
    d = pts[:, -1] - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jb = jrays.sample_straight_rays(o, d, max_length_km=900.0,
                                    n_samples=n_samples)
    jseq = jrays.RayBundle(points=jnp.stack([jb.points] * NT),
                           ds=jnp.stack([jb.ds] * NT))
    tp = torch.from_numpy(np.array(jb.points))
    tds = torch.from_numpy(np.array(jb.ds))
    return jseq, trays.RayBundle(tp.expand(NT, *tp.shape),
                                 tds.expand(NT, *tds.shape))


def run_both(nt=NT, jkw=None, tkw=None, **kw):
    """The two filters on the world's first ``nt`` steps with the same
    options ``kw`` (``jkw``/``tkw``: what only one of them takes)."""
    w, p = world()
    jwind, twind = kw.pop("jwind", w["wind"]), kw.pop("twind", p["wind"])
    jres = jkalman(w["grid"],
                   jrays.RayBundle(points=w["rays_seq"].points[:nt],
                                   ds=w["rays_seq"].ds[:nt]),
                   w["d_seq"][:nt], w["noise"], w["m_bg"], w["cov"],
                   jwind, w["dt_s"],
                   num_directions=w["n_dirs"], **kw, **(jkw or {}))
    tres = tkalman(p["grid"],
                   trays.RayBundle(p["rays_seq"].points[:nt],
                                   p["rays_seq"].ds[:nt]),
                   p["d_seq"][:nt], p["noise"], p["m_bg"], p["cov"],
                   twind, p["dt_s"],
                   num_directions=p["n_dirs"], **kw, **(tkw or {}))
    return jres, tres


def l2(a):
    return float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))


def assert_same_filter(jres, tres, state_tol=1e-2, res_tol=1e-3):
    w, _ = world()
    jm, tm = np.asarray(jres.m_seq), tres.m_seq.numpy()
    assert tm.shape == jm.shape and np.isfinite(tm).all()
    for name in ("residuals", "post_residuals"):
        jr, tr = np.asarray(getattr(jres, name)), getattr(tres, name).numpy()
        np.testing.assert_allclose(tr, jr, rtol=res_tol, err_msg=name)
    bg = np.asarray(w["m_bg"])
    for t in range(jm.shape[0]):
        assert l2(tm[t] - jm[t]) <= state_tol * l2(jm[t] - bg), (
            t, l2(tm[t] - jm[t]), l2(jm[t] - bg))


@pytest.mark.parametrize("interp", ["zp", "cubic"])
def test_one_step_matches_jax_tightly(interp):
    """One update at cg 3: the state within 1e-3 of the update's L2 size,
    residuals within 1e-4 relative."""
    jres, tres = run_both(nt=1, cg_iters=3, interp=interp)
    assert_same_filter(jres, tres, state_tol=1e-3, res_tol=1e-4)
    assert tres.wind_seq is None and tres.innov_q is None


@pytest.mark.parametrize("interp", ["zp", "cubic"])
def test_three_steps_with_fade_match_jax(interp):
    jres, tres = run_both(cg_iters=5, fade=0.95, interp=interp)
    assert_same_filter(jres, tres)
    assert (tres.post_residuals < tres.residuals).all()


@pytest.mark.parametrize("variant", ["rays_inner", "interp_inner", "both"])
def test_mixed_fidelity_matches_jax(variant):
    w, _ = world()
    jkw, tkw, kw = {}, {}, dict(cg_iters=4, interp="cubic")
    if variant in ("rays_inner", "both"):
        jkw["rays_inner_seq"], tkw["rays_inner_seq"] = inner_bundles(w)
    if variant in ("interp_inner", "both"):
        kw["interp_inner"] = "zp"
    jres, tres = run_both(jkw=jkw, tkw=tkw, **kw)
    assert_same_filter(jres, tres)


def test_per_step_bundles_and_m_clim_seq_match_jax():
    """Bundles that differ by step (no shared geometry) and per-epoch
    climatology fields."""
    w, p = world()
    rng = np.random.default_rng(400)
    clim = (np.asarray(w["m_bg"])[None]
            + 0.02 * rng.normal(size=(NT,) + w["grid"].shape)
            ).astype(np.float32)
    # step t's rays are the world's rays shortened by t samples' worth
    jp, jd = np.array(w["rays_seq"].points), np.array(w["rays_seq"].ds)
    for t in range(NT):
        scale = 1.0 - 0.01 * t
        jp[t] = jp[t][:, :1] + scale * (jp[t] - jp[t][:, :1])
        jd[t] *= scale
    w2 = dict(w, rays_seq=jrays.RayBundle(points=jnp.asarray(jp),
                                          ds=jnp.asarray(jd)))
    jres = jkalman(w2["grid"], w2["rays_seq"], w["d_seq"], w["noise"],
                   w["m_bg"], w["cov"], w["wind"], w["dt_s"],
                   num_directions=w["n_dirs"], cg_iters=6, fade=0.9,
                   interp="zp", m_clim_seq=jnp.asarray(clim))
    tres = tkalman(p["grid"], trays.RayBundle(torch.from_numpy(jp),
                                              torch.from_numpy(jd)),
                   p["d_seq"], p["noise"], p["m_bg"], p["cov"], p["wind"],
                   p["dt_s"], num_directions=p["n_dirs"], cg_iters=6,
                   fade=0.9, interp="zp",
                   m_clim_seq=torch.from_numpy(clim))
    assert_same_filter(jres, tres)


def _anchors(w, p, seed):
    rng = np.random.default_rng(seed)
    jb = janchors.vertical_anchor_bundle(w["grid"], 3, 3, 33)
    tb = tanchors.vertical_anchor_bundle(p["grid"], 3, 3, 33)
    truth = torch.from_numpy(np.asarray(w["m_true"][0]) + 0.1)
    clean = ttec.tec(truth, p["grid"], tb)
    noise = 2e-2 * float(clean.abs().max())
    vals = (clean.numpy()[None] * (1 + 0.01 * np.arange(NT))[:, None]
            + noise * rng.normal(size=(NT, 9))).astype(np.float32)
    ta = tanchors.TecAnchors(tb, torch.from_numpy(vals[0]),
                             torch.tensor(noise))
    ja = janchors.TecAnchors(jb, jnp.asarray(vals[0]), jnp.float32(noise))
    jcov = janchors.background_covariance(w["grid"], 0.5)
    return ja, ta, vals, jcov, convert.gp_covariance_from_numpy(
        jcov, device="cpu")


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
