"""Ionosonde / density-probe observations: point n_e constraints (port of
``ionotomo_tpu.data.ionosonde``).

The engine's unknown is the log-density field m with n_e = K_NE·e^m, so a
log-density observation at a point is exactly linear in the model
(``forward.tec.log_ne_at``): ionosonde bottomside soundings join the
solves and filters as point rows (``anchors.assimilate_probes``,
``anchors.probe_sqrt_update``). Probes hold float32 tensors on the grid's
device; the npz format is the reference's.

The synthetic sounder's noise, which the reference draws from its PRNG
key, is fed in (``bottomside_probes(noise=...)``) or drawn from a CPU
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..core.grids import Grid3D
from ..device import host

# Sounder visibility floor: a ~1 MHz minimum sounding frequency reflects
# where f_p = 1 MHz → n_e = (1e6 / 8.98)² ≈ 1.24e10 m^-3; densities below
# are invisible to any ionosonde, so synthetic bottomside sampling starts
# there.
MIN_SOUNDER_NE = (1.0e6 / constants.PLASMA_COEF) ** 2


class NeProbes(NamedTuple):
    """Point density constraints: ``values[p] ≈ m(points[p])`` — log
    density in the model's own units log(n_e/K_NE) — weighted by the
    log-space ``noise_std`` (scalar or (P,); ≈ relative n_e error)."""

    points: torch.Tensor      # (P, 3) ENU km
    values: torch.Tensor      # (P,)
    noise_std: torch.Tensor   # scalar or (P,)


def _grid_numpy(grid: Grid3D):
    return (host(grid.origin).astype(np.float64),
            host(grid.spacing).astype(np.float64))


def _check_in_grid(grid: Grid3D, pts: np.ndarray, what: str):
    origin, spacing = _grid_numpy(grid)
    span = spacing * (np.asarray(grid.shape) - 1)
    bad = np.zeros(pts.shape[0], bool)
    for a in range(3):
        bad |= (pts[:, a] < origin[a]) | (pts[:, a] > origin[a] + span[a])
    if bad.any():
        lo, hi = origin, origin + span
        raise ValueError(
            f"{int(bad.sum())} {what} point(s) fall outside the grid "
            f"x∈[{lo[0]:.0f},{hi[0]:.0f}], y∈[{lo[1]:.0f},{hi[1]:.0f}], "
            f"z∈[{lo[2]:.0f},{hi[2]:.0f}] km — out-of-grid probes would "
            "be edge-clamped by the tricubic interpolant and bias the "
            "solve; drop them or enlarge the grid")


def probes_from_arrays(grid: Grid3D, points_enu, ne_m3, noise_frac
                       ) -> NeProbes:
    """Build probes from physical arrays: ``points_enu`` (P,3) ENU km,
    ``ne_m3`` (P,) electron densities [m^-3], ``noise_frac`` relative
    density error (scalar or (P,)). Validates positivity and grid
    containment (edge-clamped out-of-grid probes would silently bias
    every solve)."""
    pts = np.atleast_2d(np.asarray(points_enu, np.float64))
    ne = np.asarray(ne_m3, np.float64).ravel()
    if pts.shape != (ne.shape[0], 3):
        raise ValueError(f"points_enu {pts.shape} vs ne_m3 {ne.shape}: "
                         "need (P,3) points and (P,) densities")
    if not np.all(ne > 0):
        raise ValueError("ionosonde densities must be positive "
                         f"(min given: {ne.min():.3g} m^-3)")
    _check_in_grid(grid, pts, "ionosonde probe")
    noise = np.asarray(noise_frac, np.float64)
    if np.any(noise <= 0):
        raise ValueError("noise_frac must be positive")
    dev = grid.device

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return NeProbes(points=f32(pts), values=f32(np.log(ne / constants.K_NE)),
                    noise_std=f32(noise))


def probes_from_npz(grid: Grid3D, path) -> NeProbes:
    """Load the CLI npz format: ``points_enu`` (P,3) ENU km, ``ne_m3``
    (P,) [m^-3], ``noise_frac`` scalar (or (P,)) relative density error."""
    with np.load(path) as z:
        return probes_from_arrays(grid, z["points_enu"], z["ne_m3"],
                                  z["noise_frac"])


def probes_to_npz(path, probes: NeProbes):
    """Write probes back to the CLI npz format (synthetic-study /
    round-trip helper)."""
    np.savez(path,
             points_enu=host(probes.points).astype(np.float64),
             ne_m3=constants.K_NE * np.exp(
                 host(probes.values).astype(np.float64)),
             noise_frac=host(probes.noise_std).astype(np.float64))


def bottomside_probes(field_m, grid: Grid3D, stations_xy,
                      n_per_station: int = 10, noise_log: float = 0.05,
                      seed: int = 0, min_ne: float = MIN_SOUNDER_NE,
                      noise=None) -> NeProbes:
    """Simulate ionosonde soundings from a (truth) field: for each station
    at ENU ``stations_xy`` (S,2) km, sample ``n_per_station`` bottomside
    points — altitudes from where the column density first exceeds
    ``min_ne`` (the sounder's reflection floor) up to the column's density
    peak, the physically visible range — and observe the truth's log
    density there with ``noise_log`` log-space (≈ relative) noise.
    ``noise``: the (P,) standard normals behind that noise (module
    docstring). Bench/test helper; real data enters through
    ``probes_from_arrays``.
    """
    from ..forward.tec import log_ne_at

    field_m = torch.as_tensor(field_m, dtype=torch.float32,
                              device=grid.device)
    xy = np.atleast_2d(np.asarray(stations_xy, np.float64))
    origin, sp = _grid_numpy(grid)
    nz = grid.shape[2]
    # fine column scan (4× grid resolution) to locate floor and peak
    z_fine = origin[2] + sp[2] * (nz - 1) * np.linspace(0.0, 1.0, 4 * nz)
    cols = np.concatenate(
        [np.broadcast_to(xy[:, None, :], (xy.shape[0], z_fine.size, 2)),
         np.broadcast_to(z_fine[None, :, None],
                         (xy.shape[0], z_fine.size, 1))], axis=-1)
    m_cols = host(log_ne_at(field_m, grid, torch.as_tensor(
        cols.astype(np.float32), device=grid.device))).astype(np.float64)
    m_floor = np.log(min_ne / constants.K_NE)
    pts = []
    for s in range(xy.shape[0]):
        # a field holding -inf (or NaN through interpolation of one)
        # would poison np.argmax, which returns the first NaN index;
        # treat any non-finite column value as "no density"
        col = np.where(np.isfinite(m_cols[s]), m_cols[s], -np.inf)
        i_pk = int(np.argmax(col))
        vis = np.flatnonzero(col[: i_pk + 1] >= m_floor)
        if vis.size == 0:
            raise ValueError(
                f"station {s}: no bottomside density above the sounder "
                f"floor {min_ne:.2g} m^-3 — the field is empty at this "
                "column")
        # n_per_station altitudes evenly spanning [first visible, peak]
        z_lo, z_hi = z_fine[vis[0]], z_fine[i_pk]
        zs = np.linspace(z_lo, z_hi, n_per_station)
        pts.append(np.stack([np.full_like(zs, xy[s, 0]),
                             np.full_like(zs, xy[s, 1]), zs], axis=-1))
    pts = np.concatenate(pts, axis=0)
    points = torch.as_tensor(pts.astype(np.float32), device=grid.device)
    truth = log_ne_at(field_m, grid, points)
    if noise is None:
        g = torch.Generator().manual_seed(int(seed))
        noise = torch.randn(tuple(truth.shape), generator=g)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(grid.device)
    return NeProbes(points=points, values=truth + noise_log * noise,
                    noise_std=torch.tensor(noise_log, dtype=torch.float32,
                                           device=grid.device))
