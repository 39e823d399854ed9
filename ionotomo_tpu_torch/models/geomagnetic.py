"""Centered-dipole geomagnetic field model (port of
``ionotomo_tpu.models.geomagnetic``).

Supplies B for ionospheric Faraday rotation, RM = 2.631e-13 ∫ n_e B_par ds
(``forward/rm.py``): the standard centered, tilted dipole (IGRF-2025-like
pole at 80.7° N, 287.4° E, moment 7.94e22 A m²), accurate to ~10–20 % at
LOFAR latitudes, which matches the fidelity of a tomographic n_e.

``dipole_b_enu_fn`` builds a small module from the array's ENU frame
(``geometry.frames.ENUFrame``): its rotation, origin and moment are
float32 buffers on one device, and calling it evaluates B in the local ENU
basis (Tesla) at (N, 3) points in km, in the reference's f32 order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import check_full_f32
from ..device import as_tensor, resolve

# dipole moment magnitude [A m^2] and geomagnetic north pole (geocentric)
DIPOLE_MOMENT = 7.94e22
POLE_LAT_DEG = 80.7
POLE_LON_DEG = 287.4
MU0_OVER_4PI = 1e-7           # T m / A


def dipole_moment_ecef(moment=DIPOLE_MOMENT, pole_lat_deg=POLE_LAT_DEG,
                       pole_lon_deg=POLE_LON_DEG):
    """Dipole moment vector in ECEF [A m^2] (points toward the *south*
    geomagnetic pole, as Earth's does)."""
    lat = np.deg2rad(pole_lat_deg)
    lon = np.deg2rad(pole_lon_deg)
    n_pole = np.array([np.cos(lat) * np.cos(lon),
                       np.cos(lat) * np.sin(lon),
                       np.sin(lat)])
    return -moment * n_pole


def dipole_b_ecef(points_ecef_km, m_ecef=None, device=None) -> torch.Tensor:
    """Dipole B at ECEF points (km) → B in the ECEF basis [Tesla], f32.

    B(r) = μ0/4π · (3 r̂ (m·r̂) − m) / r³, r in meters. A tensor keeps its
    device; numpy points go to ``device`` (the card unless named).
    """
    if m_ecef is None:
        m_ecef = dipole_moment_ecef()
    p = as_tensor(points_ecef_km, device=device) * 1e3     # m
    m = as_tensor(m_ecef, device=p.device).to(p.device)
    r = torch.linalg.norm(p, dim=-1, keepdim=True)
    rhat = p / r
    mdr = torch.sum(m * rhat, dim=-1, keepdim=True)
    return MU0_OVER_4PI * (3.0 * rhat * mdr - m) / r ** 3


class DipoleBEnu(torch.nn.Module):
    """ENU points (N, 3) km (relative to the frame's origin) → B in the
    ENU basis [Tesla]; ``rot`` (ECEF→ENU), ``ref`` (the frame's origin,
    km) and ``m_ecef`` are f32 buffers."""

    def __init__(self, rot, ref, m_ecef):
        super().__init__()
        self.register_buffer("rot", rot)
        self.register_buffer("ref", ref)
        self.register_buffer("m_ecef", m_ecef)

    def forward(self, points_enu_km: torch.Tensor) -> torch.Tensor:
        check_full_f32()
        p_ecef = points_enu_km @ self.rot + self.ref   # rotᵀ·enu, batched
        b_ecef = dipole_b_ecef(p_ecef, self.m_ecef)
        return b_ecef @ self.rot.T                     # rot·B


def dipole_b_enu_fn(enu_frame, moment=DIPOLE_MOMENT,
                    pole_lat_deg=POLE_LAT_DEG, pole_lon_deg=POLE_LON_DEG,
                    device=None) -> DipoleBEnu:
    """The dipole's B in ``enu_frame``'s basis as a callable on (N, 3) ENU
    points in km (a ``DipoleBEnu`` on ``device``, the card unless named).
    The constants are rounded to f32 on the host, as the reference bakes
    them in."""
    dev = resolve(device)
    rot = as_tensor(np.asarray(enu_frame.rot, np.float64), device=dev)
    ref = as_tensor(np.asarray(enu_frame.ref, np.float64), device=dev)
    m_ecef = as_tensor(dipole_moment_ecef(moment, pole_lat_deg,
                                          pole_lon_deg), device=dev)
    return DipoleBEnu(rot, ref, m_ecef)
