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
compiles once. The filter's options (anchors, innovation statistics,
wind adaptation, restarts) are in ``test_torch_kalman_options.py``, on
this file's world, so that the two files run on two workers.
"""
import functools

import numpy as np
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
