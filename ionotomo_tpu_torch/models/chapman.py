"""Chapman-layer a-priori electron density model (port of
``ionotomo_tpu.models.chapman``).

``n_e(h) = N_peak * exp(0.5 * (1 - z - exp(-z)))`` with
``z = (h - h_peak)/H``; optional solar-zenith modulation. Fields come out
on the grid's device.

Not ported yet (ROADMAP.md Queue 1, host-side geometry and data): the
reference's ``models/chapman.py:terminator_cos_chi``, which waits for
``geometry/frames.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..core.grids import Grid3D


def chapman_ne(h_km, n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0):
    """Chapman profile n_e(h) in m^-3 for a tensor of altitudes [km]."""
    z = (h_km - h_peak_km) / scale_km
    return n_peak * torch.exp(0.5 * (1.0 - z - torch.exp(-z)))


def _axis(grid: Grid3D, d: int) -> torch.Tensor:
    return grid.origin[d] + grid.spacing[d] * torch.arange(
        grid.shape[d], dtype=torch.float32, device=grid.device)


def altitude_field(grid: Grid3D, earth_radius_km=None, site_height_km=0.0):
    """True altitude above the Earth's surface for every voxel of an ENU
    grid: ``h = sqrt(r² + (R + h0 + z)²) − R`` on the osculating sphere.

    Returns an (nx, ny, nz) tensor of altitudes [km].
    """
    r_earth = (constants.EARTH_RADIUS_KM if earth_radius_km is None
               else earth_radius_km)
    x, y, z = (_axis(grid, d) for d in range(3))
    r2 = (x[:, None, None] ** 2 + y[None, :, None] ** 2)
    zc = r_earth + site_height_km + z[None, None, :]
    return torch.sqrt(r2 + zc * zc) - r_earth


def solar_zenith_factor(cos_chi, floor=0.05):
    """Day/night modulation: sqrt(max(cos χ, floor)) Chapman scaling."""
    return torch.sqrt(torch.clamp_min(torch.as_tensor(cos_chi), floor))


def chapman_field(grid: Grid3D, n_peak=1.0e12, h_peak_km=350.0,
                  scale_km=80.0, cos_chi=None, curved=False,
                  earth_radius_km=None):
    """Sample the Chapman profile onto a Grid3D (z axis = plane height, km).

    Returns n_e in m^-3 with shape ``grid.shape``. ``cos_chi`` (scalar or
    per-voxel) applies the solar-zenith factor to N_peak. With
    ``curved=True`` the profile is evaluated at each voxel's true altitude
    above the curved Earth (``altitude_field``).
    """
    if curved:
        h = altitude_field(grid, earth_radius_km)
        field = chapman_ne(h, n_peak, h_peak_km, scale_km)
    else:
        prof = chapman_ne(_axis(grid, 2), n_peak, h_peak_km, scale_km)
        field = prof[None, None, :].expand(grid.shape)
    if cos_chi is not None:
        cos_chi = torch.as_tensor(cos_chi, dtype=torch.float32,
                                  device=grid.device)
        field = field * solar_zenith_factor(cos_chi)
    return field


#: Canonical daytime mid-latitude layer stack: (name, N_peak m^-3,
#: h_peak km, scale height km, solar_sensitivity), the exponent with which
#: the layer follows the solar-zenith factor (E and F1 track the sun; the
#: transport-dominated F2 only partially fades at night).
DEFAULT_LAYERS = (
    ("E",  1.2e11, 110.0, 10.0, 1.0),
    ("F1", 2.5e11, 180.0, 40.0, 1.0),
    ("F2", 1.0e12, 350.0, 80.0, 0.5),
)


def multi_chapman_ne(h_km, layers=DEFAULT_LAYERS, cos_chi=None,
                     plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0):
    """Multi-layer profile: the sum of Chapman layers (E/F1/F2 by default)
    plus an optional exponential plasmasphere tail above the topmost peak.

    ``layers``: iterable of (name, n_peak, h_peak_km, scale_km,
    solar_sensitivity). ``cos_chi``: solar zenith cosine (scalar or
    broadcastable to h_km); each layer is modulated by sqrt(cos χ) raised
    to its sensitivity. ``plasmasphere_n0``: density of the
    exp(−(h−h_top)/H_p) tail at the topmost peak (0 disables), switched on
    by a logistic ramp over ~60 km so that it adds no gradient sheet.
    """
    h_km = torch.as_tensor(h_km, dtype=torch.float32)
    total = torch.zeros_like(h_km)
    h_top = 0.0
    for (_, n_peak, h_peak, scale, sens) in layers:
        ne = chapman_ne(h_km, n_peak, h_peak, scale)
        if cos_chi is not None:
            factor = solar_zenith_factor(torch.as_tensor(
                cos_chi, dtype=torch.float32, device=h_km.device))
            ne = ne * factor ** sens
        total = total + ne
        h_top = max(h_top, h_peak)
    if plasmasphere_n0:
        dh = h_km - h_top
        tail = plasmasphere_n0 * torch.exp(
            -torch.clamp_min(dh, 0.0) / plasmasphere_scale_km)
        total = total + tail * torch.sigmoid(dh / 60.0)
    return total


def multi_chapman_field(grid: Grid3D, layers=DEFAULT_LAYERS, cos_chi=None,
                        plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0,
                        curved=False, earth_radius_km=None):
    """Sample the multi-layer profile onto a Grid3D (z axis = plane
    height). ``cos_chi`` may be per-voxel (any shape broadcastable to
    ``grid.shape``); ``curved=True`` evaluates each voxel at its true
    altitude above the curved Earth."""
    if curved:
        h = altitude_field(grid, earth_radius_km)
    elif cos_chi is None or torch.as_tensor(cos_chi).dim() == 0:
        prof = multi_chapman_ne(_axis(grid, 2), layers, cos_chi,
                                plasmasphere_n0, plasmasphere_scale_km)
        return prof[None, None, :].expand(grid.shape)
    else:
        h = _axis(grid, 2)[None, None, :].expand(grid.shape)
    return multi_chapman_ne(h, layers, cos_chi, plasmasphere_n0,
                            plasmasphere_scale_km)


def background_ne_fn(n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0,
                     cos_chi=None, curved=False, earth_radius_km=None,
                     site_height_km=0.0, layers=None,
                     plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0):
    """Closed-form background field evaluator: ``fn(points (R, 3) ENU km)
    -> (n_e (R,) [m⁻³], ∇n_e (R, 3) [m⁻³/km])``, the gradient by autograd
    of the analytic profile (the points are independent, so the gradient
    of the summed profile is the per-point gradient the reference takes
    with ``jax.value_and_grad`` under ``vmap``). Single Chapman layer by
    default, a multi-Chapman stack with ``layers``, scalar solar-zenith
    modulation, and the curved-Earth altitude model. Per-column cos_chi
    maps are grid products and are refused."""
    if cos_chi is not None and torch.as_tensor(cos_chi).dim() != 0:
        raise ValueError("background_ne_fn needs scalar cos_chi; "
                         "per-column terminator maps are grid products")
    cc = None if cos_chi is None else float(cos_chi)
    factor = 1.0 if cc is None else float(solar_zenith_factor(cc))
    r_earth = (constants.EARTH_RADIUS_KM if earth_radius_km is None
               else float(earth_radius_km))

    def ne_of(x):
        if curved:
            zc = r_earth + site_height_km + x[:, 2]
            h = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                           + zc * zc) - r_earth
        else:
            h = x[:, 2]
        if layers is not None:
            return multi_chapman_ne(h, layers, cc, plasmasphere_n0,
                                    plasmasphere_scale_km)
        return factor * chapman_ne(h, n_peak, h_peak_km, scale_km)

    def fn(points):
        with torch.enable_grad():
            x = points.detach().requires_grad_(True)
            ne = ne_of(x)
            (grad,) = torch.autograd.grad(ne.sum(), x)
        return ne.detach(), grad

    return fn


#: Vacuum floor of the log-parametrization m = log(n_e/K_NE) ≈ -85.2
#: (the ratio floor 1e-37 is a normal f32 number).
M_FLOOR = float(np.log(1e-37))


def log_parametrize(n_e):
    """m = log(n_e / K_NE), clipped away from -inf for vanishing density.

    The clip is applied to the *ratio*: clipping n_e before the division
    would leave a subnormal after /K_NE, flushed to zero, and -inf."""
    return torch.log(torch.clamp_min(n_e / constants.K_NE, 1e-37))


def ne_from_log(m):
    """n_e = K_NE * exp(m)."""
    return constants.K_NE * torch.exp(m)


def grid_enclosing_rays(antennas_enu, directions_enu,
                        max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                        shape=(64, 64, 64), pad_km=25.0, h_min_km=None,
                        device=None) -> Grid3D:
    """A Grid3D that encloses every (antenna, direction) ray plus padding
    (host-side: numpy in, the grid on ``device``, the card by default)."""
    ants = np.atleast_2d(np.asarray(antennas_enu, np.float64))
    dirs = np.asarray(directions_enu, np.float64).reshape(-1, 3)
    ends = ants[:, None, :] + max_length_km * dirs[None, :, :]
    pts = np.concatenate([np.broadcast_to(ants[:, None, :], ends.shape)
                          .reshape(-1, 3), ends.reshape(-1, 3)], axis=0)
    lo = pts.min(axis=0) - pad_km
    hi = pts.max(axis=0) + pad_km
    if h_min_km is not None:
        lo[2] = min(lo[2], h_min_km)
    return Grid3D.from_bounds(lo, hi, shape, device=device)
