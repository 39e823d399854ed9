"""Synthetic observation generation (port of ``ionotomo_tpu.data.synth``).

Builds a self-consistent synthetic world: LOFAR-like array → directions
around a phase centre → simulated ionosphere (Chapman + turbulent log-
density perturbation, frozen-flow advected over time) → straight-ray dTEC
→ noise → DataPack.

The numpy draws (directions, layout, observation noise) are the
reference's. The turbulence's white noise, which the reference draws from
its PRNG key, is fed in as ``white``; without it a ``torch.Generator``
seeded from ``seed + 2`` draws it on the CPU, so a world made on the card
and one made on the CPU hold the same noise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve
from ..forward import tec as tec_mod
from ..geometry import rays as rays_mod
from ..geometry.frames import gmst_rad
from ..models import chapman
from ..models.turbulence import turbulent_log_perturbation
from .datapack import DataPack
from .radio_array import RadioArray, generate_lofar_like_array


def choose_directions(phase_center_radec, n_dirs, spread_deg=2.5, seed=0):
    """n_dirs ICRS directions in a disc around the phase centre (rad)."""
    rng = np.random.default_rng(seed)
    ra0, dec0 = phase_center_radec
    r = np.deg2rad(spread_deg) * np.sqrt(rng.uniform(0.05, 1.0, n_dirs))
    th = rng.uniform(0, 2 * np.pi, n_dirs)
    dec = dec0 + r * np.cos(th)
    ra = ra0 + r * np.sin(th) / np.cos(dec0)
    return np.stack([ra, dec], axis=-1)


def zenith_phase_center(array: RadioArray, mjd):
    """(ra, dec) that culminates at the array zenith at time mjd."""
    lst = gmst_rad(mjd) + array.enu_frame.lon
    return np.array([lst, array.enu_frame.lat])


def white_noise(shape, seed) -> torch.Tensor:
    """Standard normals of ``shape`` from a CPU ``torch.Generator`` seeded
    with ``seed`` (the same numbers on every device)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


def generate_example_datapack(n_antennas=62, n_directions=10, n_times=1,
                              mjd0=58000.2, dt_s=30.0, noise_tecu=1e-3,
                              grid_shape=(64, 64, 64), turbulence_amp=0.5,
                              wind_kmps=(0.15, 0.05, 0.0), seed=0,
                              frequency_hz=constants.DEFAULT_FREQUENCY_HZ,
                              n_samples=constants.DEFAULT_N_SAMPLES,
                              curved_earth=False, white=None, device=None):
    """Synthetic DataPack + the ground-truth model that generated it.

    Returns (datapack, truth) where truth is a dict holding the Grid3D (on
    ``device``, the card unless named), the per-time log-density fields
    m[Nt, *grid.shape] (numpy) and metadata. ``white``: the turbulence's
    white noise, ``grid_shape`` standard normals (module docstring).
    """
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    n_core = min(24, max(1, n_antennas * 2 // 5))
    array = generate_lofar_like_array(n_core=n_core,
                                      n_remote=n_antennas - n_core,
                                      seed=seed)
    times = mjd0 + np.arange(n_times) * (dt_s / 86400.0)
    pc = zenith_phase_center(array, times.mean())
    directions = choose_directions(pc, n_directions, seed=seed + 1)

    dp = DataPack(array, directions, times, ref_antenna=0,
                  frequency_hz=frequency_hz,
                  noise_std=noise_tecu * constants.TECU / constants.TEC_SCALE)

    # geometry → grid that encloses every ray at every time
    dirs_enu = dp.directions_enu()                    # (Nt, Nd, 3)
    grid = chapman.grid_enclosing_rays(
        array.enu, dirs_enu.reshape(-1, 3), shape=grid_shape, h_min_km=0.0,
        device=dev)

    # ground-truth ionosphere: Chapman background (with day/night solar
    # modulation, matching the pipeline's prior) + frozen-flow turbulence
    from ..geometry import frames
    r_earth = None
    if curved_earth:
        r_earth = frames.gaussian_earth_radius(array.enu_frame.lat)
        cos_chi = chapman.terminator_cos_chi(grid, array.enu_frame,
                                             times.mean())
    else:
        cos_chi = float(frames.solar_cos_zenith(times.mean(),
                                                array.enu_frame))
    ne_bg = chapman.chapman_field(grid, cos_chi=cos_chi,
                                  curved=curved_earth,
                                  earth_radius_km=r_earth)
    m_bg = chapman.log_parametrize(ne_bg)
    if white is None:
        white = white_noise(grid.shape, seed + 2)
    pert0 = turbulent_log_perturbation(grid, white, amplitude=turbulence_amp)
    wind = torch.as_tensor(np.asarray(wind_kmps, np.float32), device=dev)

    from ..models.frozen_flow import advect_periodic
    ants = torch.as_tensor(array.enu.astype(np.float32), device=dev)
    m_truth = []
    dtec_obs = np.empty(dp.shape)
    for t in range(n_times):
        # frozen flow: advect the perturbation by the bulk wind
        shift = wind * (t * dt_s)
        pert_t = advect_periodic(pert0, grid, shift) if t else pert0
        m_t = m_bg + pert_t
        m_truth.append(m_t.cpu().numpy())
        origins, dvecs = rays_mod.make_ray_batch(
            ants, torch.as_tensor(dirs_enu[t].astype(np.float32),
                                  device=dev))
        rb = rays_mod.sample_straight_rays(origins, dvecs,
                                           n_samples=n_samples)
        g = tec_mod.dtec_paired(m_t, grid, rb, num_directions=n_directions,
                                i0=dp.ref_antenna)
        dtec_obs[:, t, :] = g.cpu().numpy()

    dtec_obs += rng.normal(scale=dp.noise_std)
    dp.dtec = dtec_obs

    truth = dict(grid=grid, m=np.stack(m_truth),
                 m_background=m_bg.cpu().numpy(),
                 wind_kmps=np.asarray(wind_kmps), dt_s=dt_s,
                 turbulence_amp=turbulence_amp)
    return dp, truth
