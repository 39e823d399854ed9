"""The judged configurations the port can run, as functions (counterparts
of ``bench/config2.py`` and ``bench/config4.py`` with their helpers from
``bench/common.py``).

``config2``: bent-ray Fermat tracing through a 128³ Chapman cube, 62
stations × 100 directions and the saturated 262144-ray batch, leapfrog at
128 steps, on the default (tricubic) field model.

``config4``: Bayesian MAP inversion on a 256³ grid from 100 × 100 rays:
an analytic world (closed-form Chapman × a band-limited von Kármán
Fourier-mode sum) traced by ``trace_rays_callable`` at 256 steps plus 1 %
noise, a von Kármán prior at mismatched hyperparameters, and the
progressive warm-started Gauss-Newton schedule (step 1 on the 33-sample
bundle at cg 20, step 2 on the 65-sample bundle at cg 10, continuing step
1's whitened Krylov solution).

``config5``: the frozen-flow Kalman filter over 30 epochs of 100 × 100
rays on a 128³ grid, zp, Hermite@65 with the @33 inner bundle, cg 10, in 5
chunks of 6 steps chained through ``advect_first``/``m_clim``: the
analytic world of config 4 drifting with the wind by an exact phase shift
(so the filter's periodic spectral advection carries its true model
error), data by ``trace_rays_callable`` at 128 steps per epoch plus 1 %
noise. ``config5_enkf`` runs the 8-member ensemble filter on the same
world.

Sizes are arguments defaulting to the benches'; each function returns a
dict of what its bench emits. Everything runs on the card unless
``device`` says otherwise. The observation noise is drawn by numpy from
``seed``. The benches' environment switches are arguments here, and their
chunking of the ray axis (a work-around for a watchdog of another
machine) is absent.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .core.grids import Grid3D
from .device import resolve
from .forward import tec as tec_mod
from .geometry import fermat, rays as rays_mod
from .inversion import kalman, solvers
from .inversion.priors import GPCovariance
from .models import chapman
from .models.turbulence import FourierModes, analytic_ne_fn


def make_rays(n_ants, n_dirs, seed=0, spread_km=150.0, zen_max=0.6):
    """Antenna ENU positions (n_ants, 3) and near-zenith unit directions
    (n_dirs, 3), numpy float32."""
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-spread_km, spread_km, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, zen_max, n_dirs)
    az = rng.uniform(0, 2 * np.pi, n_dirs)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    return ants, dirs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps, warmup=True):
    """Seconds per call over ``reps`` calls after one untimed call (unless
    ``warmup`` is off), the device synchronised; (last result, seconds)."""
    if warmup:
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) / reps


def _paired_noisy(tau: torch.Tensor, n_dirs: int, noise_frac, seed):
    """TEC per ray (R,) → dTEC against antenna 0 (Na, Nd) plus numpy
    Gaussian noise of noise_frac·std; (d on tau's device, noise std)."""
    tau = tau.reshape(-1, n_dirs).cpu().numpy()
    d = tau - tau[0:1]
    noise = float(noise_frac * np.std(d))
    d = d + noise * np.random.default_rng(seed).standard_normal(
        d.shape).astype(np.float32)
    return torch.from_numpy(d.astype(np.float32)), noise


def bent_dtec_data(m_true, grid: Grid3D, ants, dirs, frequency_hz=150e6,
                   n_steps=256, noise_frac=0.01, seed=0,
                   max_length_km=1000.0, interp="cubic"):
    """Observations via the bent Fermat tracer through a gridded truth at
    twice the production quadrature, plus Gaussian noise: the forward
    model generating the data is not the operator the solvers invert.
    Returns (d_obs (Na, Nd) on the grid's device, noise std)."""
    o, dv = rays_mod.make_ray_batch(torch.from_numpy(ants).to(grid.device),
                                    torch.from_numpy(dirs).to(grid.device))
    _, tau = fermat.trace_rays(m_true, grid, o, dv, frequency_hz,
                               max_length_km, n_steps=n_steps,
                               keep_path=False, method="leapfrog",
                               interp=interp)
    d, noise = _paired_noisy(tau, dirs.shape[0], noise_frac, seed)
    return d.to(grid.device), noise


def analytic_world(grid: Grid3D, amplitude=0.25, outer_scale_km=120.0,
                   n_modes=512, seed=11):
    """Analytic honest world: closed-form Chapman background × a
    band-limited von Kármán Fourier-mode sum, band-limited at the grid's
    Nyquist so the world stays representable. Truth value and gradient
    exist everywhere in closed form, so no solver's interpolation model
    defines reality. Returns (m_true, the truth's log-density samples on
    ``grid``; ne_and_grad, the closed-form evaluator the bent tracer
    generates data through)."""
    kmax = float(np.pi / float(grid.spacing.max()))
    modes = FourierModes(n_modes, amplitude, outer_scale_km, kmax,
                         seed=seed, device=grid.device)
    m_ch = chapman.log_parametrize(chapman.chapman_field(grid))
    pts = torch.stack(torch.meshgrid(*grid.axes(), indexing="ij"),
                      dim=-1).reshape(-1, 3)
    m_true = m_ch + modes.value(pts).reshape(grid.shape)
    return m_true, analytic_ne_fn(modes, chapman.background_ne_fn())


def bent_dtec_data_callable(ne_and_grad, ants, dirs, frequency_hz=150e6,
                            n_steps=256, noise_frac=0.01, seed=0,
                            max_length_km=1000.0, device=None):
    """Observations via the bent tracer through a closed-form field
    (``fermat.trace_rays_callable``) at twice the production step count,
    plus noise: the analytic-world twin of ``bent_dtec_data``."""
    dev = resolve(device)
    o, dv = rays_mod.make_ray_batch(torch.from_numpy(ants).to(dev),
                                    torch.from_numpy(dirs).to(dev))
    _, tau = fermat.trace_rays_callable(ne_and_grad, o, dv, frequency_hz,
                                        max_length_km, n_steps=n_steps,
                                        keep_path=False, method="leapfrog")
    d, noise = _paired_noisy(tau, dirs.shape[0], noise_frac, seed)
    return d.to(dev), noise


def covered_rmse(m, m_true, grid: Grid3D, rb, frac=0.05) -> float:
    """RMSE of (m − m_true) over the ray-covered voxels (coverage above
    ``frac`` of its maximum): unobserved voxels carry no information and
    would dilute the metric."""
    cover = tec_mod.ray_coverage(grid, rb)
    mask = cover > frac * cover.max()
    e = torch.where(mask, m - m_true, 0.0)
    return float(torch.sqrt(torch.sum(e * e) / torch.clamp_min(mask.sum(),
                                                              1)))


def straight_bundle(ants, dirs, n_samples, device):
    """The straight-ray bundle of an (antennas × directions) array."""
    o, dv = rays_mod.make_ray_batch(torch.from_numpy(ants).to(device),
                                    torch.from_numpy(dirs).to(device))
    return rays_mod.sample_straight_rays(o, dv, n_samples=n_samples)


def heldout_dtec_rms(m, grid: Grid3D, ants_h, dirs_h, d_heldout,
                     n_samples=129, interp="cubic") -> float:
    """Generalisation on the observable: rms dTEC prediction error on rays
    never used in the solve (new antennas and directions)."""
    rb = straight_bundle(ants_h, dirs_h, n_samples, grid.device)
    g = tec_mod.dtec_paired(m, grid, rb, dirs_h.shape[0], 0, interp)
    return float(torch.sqrt(torch.mean((g - d_heldout) ** 2)))


def config2(shape=(128, 128, 128), n_ants=62, n_dirs=100,
            n_saturated=262144, n_steps=128, interp="cubic",
            frequency_hz=150e6, max_length_km=1000.0, reps=(5, 3),
            device=None) -> dict:
    """Config 2: bent rays per second with TEC, endpoints only, leapfrog,
    through a Chapman cube on (±400, ±400, 0..1100) km: the literal
    ``n_ants`` × ``n_dirs`` array and the saturated batch of
    ``n_saturated`` rays (512 antennas × n_saturated/512 directions)."""
    dev = resolve(device)
    grid = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0), shape,
                              device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    out = {"config": "config2", "interp": interp, "n_steps": n_steps,
           "shape": list(shape)}
    cases = (("6200", make_rays(n_ants, n_dirs), reps[0]),
             ("saturated", make_rays(512, n_saturated // 512), reps[1]))
    for name, (ants, dirs), n_reps in cases:
        o, dv = rays_mod.make_ray_batch(torch.from_numpy(ants).to(dev),
                                        torch.from_numpy(dirs).to(dev))
        (rb, tau), secs = _timed(
            lambda: fermat.trace_rays(m, grid, o, dv, frequency_hz,
                                      max_length_km, n_steps=n_steps,
                                      keep_path=False, method="leapfrog",
                                      interp=interp), dev, n_reps)
        out[f"rays_{name}"] = o.shape[0]
        out[f"seconds_{name}"] = secs
        out[f"bent_rays_per_sec_{name}"] = o.shape[0] / secs
        out[f"finite_{name}"] = bool(torch.isfinite(tau).all()
                                     and torch.isfinite(rb.points).all())
    return out


class Config4World(NamedTuple):
    """What a config-4 solve takes, and what its skill is measured on."""
    grid: Grid3D
    m_prior: torch.Tensor
    m_true: torch.Tensor
    cov: GPCovariance
    d_obs: torch.Tensor          # (Na, Nd) observed dTEC
    noise: float
    rays: rays_mod.RayBundle     # the full-fidelity straight bundle
    rays_inner: rays_mod.RayBundle | None
    n_dirs: int
    heldout: tuple               # (ants_h, dirs_h, d_h): rays not solved on


def config4_world(shape=(256, 256, 256), n_ants=100, n_dirs=100,
                  n_samples=65, inner_samples=33, n_modes=512,
                  amplitude=0.25, outer_scale_km=120.0, world_seed=11,
                  trace_steps=256, noise_frac=0.01, seed=0,
                  heldout=(20, 50, 99), frequency_hz=150e6,
                  device=None) -> Config4World:
    """The world of config 4: grid enclosing the rays, Chapman prior mean,
    analytic truth, bent-ray data through it with noise, a von Kármán
    prior (σ 0.3, 80 km: deliberately off the truth's 0.25, 120 km), the
    65- and 33-sample straight bundles, and noise-free held-out data on
    ``heldout`` = (antennas, directions, seed) new rays."""
    dev = resolve(device)
    ants, dirs = make_rays(n_ants, n_dirs)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=shape, h_min_km=0.0,
                                       device=dev)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid)
                                      ).contiguous()
    m_true, ne_fn = analytic_world(grid, amplitude, outer_scale_km, n_modes,
                                   world_seed)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    kw = dict(frequency_hz=frequency_hz, n_steps=trace_steps, device=dev)
    d_obs, noise = bent_dtec_data_callable(ne_fn, ants, dirs,
                                           noise_frac=noise_frac, seed=seed,
                                           **kw)
    ants_h, dirs_h = make_rays(heldout[0], heldout[1], seed=heldout[2])
    d_h, _ = bent_dtec_data_callable(ne_fn, ants_h, dirs_h, noise_frac=0.0,
                                     **kw)
    rb = straight_bundle(ants, dirs, n_samples, dev)
    rb_inner = (straight_bundle(ants, dirs, inner_samples, dev)
                if inner_samples else None)
    return Config4World(grid, m_prior, m_true, cov, d_obs, noise, rb,
                        rb_inner, n_dirs, (ants_h, dirs_h, d_h))


def config4_solve(world: Config4World, interp="cubic", interp_inner=None,
                  quadrature="hermite", progressive=True, warm_start=True,
                  cg_iters=20, cg2=None, gn_iters=2, linearize=None
                  ) -> solvers.InversionResult:
    """The config-4 schedule. Progressive (needs the inner bundle):
    Gauss-Newton step 1 entirely on the coarse bundle at ``cg_iters``,
    step 2 on the full bundle at ``cg2`` (default 10 warm, ``cg_iters``
    cold) from step 1's iterate and, warm, its whitened Krylov solution.
    Otherwise ``gn_iters`` steps on the full bundle with the coarse one as
    the inner Jacobian."""
    w = world
    kw = dict(num_directions=w.n_dirs, quadrature=quadrature, interp=interp,
              warm_start=warm_start, interp_inner=interp_inner,
              linearize=linearize)
    if not (progressive and w.rays_inner is not None):
        return solvers.map_gauss_newton(
            w.grid, w.rays, w.d_obs, w.noise, w.m_prior, w.cov,
            gn_iters=gn_iters, cg_iters=cg_iters, rays_inner=w.rays_inner,
            **kw)
    if cg2 is None:
        cg2 = 10 if warm_start else cg_iters
    r1 = solvers.map_gauss_newton(w.grid, w.rays_inner, w.d_obs, w.noise,
                                  w.m_prior, w.cov, gn_iters=1,
                                  cg_iters=cg_iters, **kw)
    return solvers.map_gauss_newton(
        w.grid, w.rays, w.d_obs, w.noise, w.m_prior, w.cov, gn_iters=1,
        cg_iters=cg2, m0=r1.m, u0=(r1.u_final if warm_start else None), **kw)


def config4(world: Config4World = None, warmup=True, **solve_kw) -> dict:
    """Config 4: seconds per solve and CG iterations per second with the
    256³ covariance operator in the loop, and the solve's skill:
    covered-voxel RMSE and held-out dTEC rms, prior and posterior.
    ``world`` comes from ``config4_world`` (sizes, seeds, device; the
    bench's when none is given), ``solve_kw`` go to ``config4_solve`` (the
    schedule). ``warmup`` runs one untimed solve first (kernel build,
    allocator, FFT plans)."""
    w = world if world is not None else config4_world()
    res, secs = _timed(lambda: config4_solve(w, **solve_kw), w.grid.device,
                       1, warmup)
    interp = solve_kw.get("interp", "cubic")
    ants_h, dirs_h, d_h = w.heldout
    cg_done = sum(int(i) for i in res.info[1])    # the last call's steps
    return {"config": "config4", "metric": "map_gn_seconds_to_solve",
            "value": secs, "unit": "s", "interp": interp,
            "interp_inner": solve_kw.get("interp_inner"),
            "n_samples": w.rays.num_samples,
            "inner_samples": (w.rays_inner.num_samples
                              if w.rays_inner is not None else 0),
            "shape": list(w.grid.shape), "noise": w.noise,
            "last_step_cg_iterations": cg_done,
            "residual_norm": float(res.residual_norm),
            "covered_rmse_prior": covered_rmse(w.m_prior, w.m_true, w.grid,
                                               w.rays),
            "covered_rmse_post": covered_rmse(res.m, w.m_true, w.grid,
                                              w.rays),
            "heldout_dtec_rms_prior": heldout_dtec_rms(
                w.m_prior, w.grid, ants_h, dirs_h, d_h, interp=interp),
            "heldout_dtec_rms_post": heldout_dtec_rms(
                res.m, w.grid, ants_h, dirs_h, d_h, interp=interp)}


class Config5World(NamedTuple):
    """What a config-5 filter run takes, and what its skill is measured
    on."""
    grid: Grid3D
    m_bg: torch.Tensor           # the Chapman prior mean (log density)
    m_true_last: torch.Tensor    # the truth's samples at the last epoch
    cov: GPCovariance
    wind: tuple                  # km/s
    dt_s: float
    d_seq: torch.Tensor          # (Nt, Na, Nd) observed dTEC per epoch
    noise: float
    rays: rays_mod.RayBundle     # the full-fidelity straight bundle
    rays_inner: rays_mod.RayBundle | None
    n_dirs: int
    heldout: tuple               # (ants_h, dirs_h, d_h) at the last epoch
    heldout_at: object           # epoch t -> d_h (Nh, Ndh) there, noise-free


def config5_world(shape=(128, 128, 128), n_ants=100, n_dirs=100, nt=30,
                  n_samples=65, inner_samples=33, n_modes=512,
                  amplitude=0.25, outer_scale_km=120.0, world_seed=13,
                  trace_steps=128, wind=(0.3, 0.1, 0.0), dt_s=30.0,
                  noise_frac=0.01, seed=0, heldout=(20, 50, 99),
                  frequency_hz=150e6, device=None) -> Config5World:
    """The world of config 5: grid enclosing the rays, Chapman prior mean,
    a closed-form Chapman × Fourier-mode von Kármán truth whose frozen-flow
    evolution is an exact phase shift by wind·t·Δt (no grid, no
    interpolant, and not the filter's own periodic advection), ``nt``
    epochs of bent-ray dTEC through it (``trace_rays_callable``, leapfrog)
    plus Gaussian noise of ``noise_frac``·std over all epochs drawn by
    numpy from ``seed``, a von Kármán prior (σ 0.3, 80 km: off the truth's
    120 km), the straight bundles, and noise-free held-out data at the
    last epoch on ``heldout`` = (antennas, directions, seed) new rays."""
    dev = resolve(device)
    ants, dirs = make_rays(n_ants, n_dirs)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=shape, h_min_km=0.0,
                                       device=dev)
    m_bg = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    kmax = float(np.pi / float(grid.spacing.max()))
    modes = FourierModes(n_modes, amplitude, outer_scale_km, kmax,
                         seed=world_seed, device=dev)
    bg = chapman.background_ne_fn()
    wind_np = np.asarray(wind, np.float64)

    def tau(t, ants_, dirs_):
        ne = analytic_ne_fn(modes.shifted(wind_np * (t * dt_s)), bg)
        o, dv = rays_mod.make_ray_batch(torch.from_numpy(ants_).to(dev),
                                        torch.from_numpy(dirs_).to(dev))
        return fermat.trace_rays_callable(
            ne, o, dv, frequency_hz, 1000.0, n_steps=trace_steps,
            keep_path=False, method="leapfrog")[1]

    def paired(tau_, nd):
        tau_ = tau_.reshape(-1, nd)
        return tau_ - tau_[0:1]

    d_seq = torch.stack([paired(tau(t, ants, dirs), n_dirs)
                         for t in range(nt)]).cpu().numpy()
    noise = float(noise_frac * np.std(d_seq))
    d_seq = d_seq + noise * np.random.default_rng(seed).standard_normal(
        d_seq.shape).astype(np.float32)
    ants_h, dirs_h = make_rays(heldout[0], heldout[1], seed=heldout[2])

    def heldout_at(t):
        return paired(tau(t, ants_h, dirs_h), heldout[1])

    pts = torch.stack(torch.meshgrid(*grid.axes(), indexing="ij"),
                      dim=-1).reshape(-1, 3)
    m_true_last = m_bg + modes.shifted(
        wind_np * ((nt - 1) * dt_s)).value(pts).reshape(grid.shape)
    rb = straight_bundle(ants, dirs, n_samples, dev)
    rb_inner = (straight_bundle(ants, dirs, inner_samples, dev)
                if inner_samples else None)
    return Config5World(grid, m_bg, m_true_last, cov,
                        tuple(float(x) for x in wind), float(dt_s),
                        torch.from_numpy(d_seq.astype(np.float32)).to(dev),
                        noise, rb, rb_inner, n_dirs,
                        (ants_h, dirs_h, heldout_at(nt - 1)), heldout_at)


def _expand_steps(rb, n):
    """The bundle with a leading time axis of n steps, expanded (stride
    0): the filters set such a bundle up once."""
    if rb is None:
        return None
    return rays_mod.RayBundle(points=rb.points.expand(n, *rb.points.shape),
                              ds=rb.ds.expand(n, *rb.ds.shape))


def config5_filter(world: Config5World, interp="zp", cg_iters=10, chunk=6,
                   n_steps=None, quadrature="hermite", linearize=None,
                   geometry_cache=None):
    """The config-5 filter in production form: ``n_steps`` epochs (all by
    default) in chunks of ``chunk`` steps (None: one call), each chunk
    continuing the last through ``advect_first=True, m_clim=m_bg``.
    Returns (the final state, pre-update and post-update whitened
    residuals per step)."""
    w = world
    nt = w.d_seq.shape[0] if n_steps is None else n_steps
    chunk = nt if chunk is None else chunk
    cache = {} if geometry_cache is None else geometry_cache
    m_cur, pre, post = w.m_bg, [], []
    for c0 in range(0, nt, chunk):
        n = min(chunk, nt - c0)
        res = kalman.kalman_filter(
            w.grid, _expand_steps(w.rays, n), w.d_seq[c0:c0 + n], w.noise,
            m_cur, w.cov, w.wind, w.dt_s, num_directions=w.n_dirs,
            cg_iters=cg_iters, advect_first=(c0 > 0), m_clim=w.m_bg,
            rays_inner_seq=_expand_steps(w.rays_inner, n), interp=interp,
            quadrature=quadrature, linearize=linearize,
            geometry_cache=cache)
        m_cur = res.m_seq[-1]
        pre.append(res.residuals)
        post.append(res.post_residuals)
    return m_cur, torch.cat(pre), torch.cat(post)


def config5_heldout_rms(m, w, interp="zp", epoch=None):
    """Held-out dTEC rms of m on the world's held-out rays, against their
    data at ``epoch`` (None: the last)."""
    ants_h, dirs_h, d_h = w.heldout
    if epoch is not None:
        d_h = w.heldout_at(epoch)
    return heldout_dtec_rms(m, w.grid, ants_h, dirs_h, d_h, n_samples=65,
                            interp=interp)


def config5(world: Config5World = None, warmup=True, **filter_kw) -> dict:
    """Config 5: wall seconds for the whole filter run and timesteps per
    second, and its skill: mean pre/post residual ratio, covered-voxel
    RMSE against the truth at the last epoch and held-out dTEC rms there,
    prior and posterior. ``world`` comes from ``config5_world`` (the
    bench's when none is given), ``filter_kw`` go to ``config5_filter``.
    ``warmup`` runs one untimed filter first (kernel build, allocator,
    FFT plans, the bundles' set-up when a ``geometry_cache`` is given)."""
    w = world if world is not None else config5_world()
    interp = filter_kw.get("interp", "zp")
    (m_f, pre, post), secs = _timed(lambda: config5_filter(w, **filter_kw),
                                    w.grid.device, 1, warmup)
    nt = pre.shape[0]
    return {"config": "config5", "metric": "kalman_30steps_seconds",
            "value": secs, "unit": "s", "steps": nt,
            "timesteps_per_sec": nt / secs, "interp": interp,
            "cg_iters": filter_kw.get("cg_iters", 10),
            "n_samples": w.rays.num_samples,
            "inner_samples": (w.rays_inner.num_samples
                              if w.rays_inner is not None else 0),
            "shape": list(w.grid.shape), "noise": w.noise,
            "mean_residual_reduction": float(
                (pre / torch.clamp_min(post, 1e-9)).mean()),
            "covered_rmse_prior": covered_rmse(w.m_bg, w.m_true_last, w.grid,
                                               w.rays),
            "covered_rmse_post": covered_rmse(m_f, w.m_true_last, w.grid,
                                              w.rays),
            "heldout_dtec_rms_prior": config5_heldout_rms(w.m_bg, w, interp),
            "heldout_dtec_rms_post": config5_heldout_rms(m_f, w, interp)}


def enkf_noise(world: Config5World, n_members=8, n_steps=6, seed=0):
    """The ensemble filter's unit-normal draws from a numpy seed:
    (init_noise (B, *grid.shape), obs_noise (n_steps, B, Na·Nd)) on the
    world's device."""
    rng = np.random.default_rng(seed)
    dev = world.grid.device
    init = rng.standard_normal((n_members,) + tuple(world.grid.shape),
                               dtype=np.float32)
    obs = rng.standard_normal((n_steps, n_members,
                               world.d_seq[0].numel()), dtype=np.float32)
    return torch.from_numpy(init).to(dev), torch.from_numpy(obs).to(dev)


def config5_enkf_filter(world: Config5World, noise, n_steps=6, chunk=None,
                        interp="zp", cg_iters=10, quadrature="hermite",
                        linearize=None, geometry_cache=None, **enkf_kw):
    """The ensemble filter on config 5's world over its first ``n_steps``
    epochs, in chunks of ``chunk`` steps (None: one call) chained through
    ``ens0``/``step_offset``. ``noise`` = (init_noise, obs_noise) as
    ``enkf_noise`` makes them. Returns the per-chunk
    ``EnsembleKalmanResult`` list."""
    w = world
    init_noise, obs_noise = noise
    chunk = n_steps if chunk is None else chunk
    cache = {} if geometry_cache is None else geometry_cache
    ens, out = None, []
    for c0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - c0)
        res = kalman.ensemble_kalman_filter(
            w.grid, _expand_steps(w.rays, n), w.d_seq[c0:c0 + n], w.noise,
            w.m_bg, w.cov, w.wind, w.dt_s, w.n_dirs, obs_noise,
            n_members=init_noise.shape[0], cg_iters=cg_iters,
            advect_first=(c0 > 0), m_clim=w.m_bg, ens0=ens,
            init_noise=init_noise, step_offset=c0,
            rays_inner_seq=_expand_steps(w.rays_inner, n), interp=interp,
            quadrature=quadrature, linearize=linearize,
            geometry_cache=cache, **enkf_kw)
        ens = res.ensemble
        out.append(res)
    return out


def config5_enkf(world: Config5World = None, n_members=8, n_steps=6, seed=0,
                 warmup=True, **filter_kw) -> dict:
    """The 8-member ensemble filter on config 5's world: seconds per step
    over its first ``n_steps`` epochs (one call), the mean's residuals,
    the final spread, and the held-out dTEC rms of the final mean and of
    the prior against the held-out rays' data at the run's last epoch."""
    w = world if world is not None else config5_world()
    interp = filter_kw.get("interp", "zp")
    noise = enkf_noise(w, n_members, n_steps, seed)
    (res,), secs = _timed(
        lambda: config5_enkf_filter(w, noise, n_steps, **filter_kw),
        w.grid.device, 1, warmup)
    mean_f = res.mean_seq[-1]
    return {"config": "config5_enkf", "metric": "enkf_seconds_per_step",
            "value": secs / n_steps, "unit": "s", "steps": n_steps,
            "members": n_members, "interp": interp,
            "residual_first": float(res.residuals[0]),
            "residual_last": float(res.residuals[-1]),
            "spread_mean": float(res.std_seq[-1].mean()),
            "spread_min": float(res.std_seq[-1].min()),
            "heldout_dtec_rms_prior": config5_heldout_rms(w.m_bg, w, interp,
                                                     n_steps - 1),
            "heldout_dtec_rms_mean": config5_heldout_rms(mean_f, w, interp,
                                                    n_steps - 1)}
