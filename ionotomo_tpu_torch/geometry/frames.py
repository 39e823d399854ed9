"""Host-side coordinate frames: ECEF/ITRS, local ENU, and ICRS→ENU pointing
(a copy of ``ionotomo_tpu.geometry.frames``: float64 numpy, bitwise the
reference).

Design stance (SURVEY.md §7 "Host/device boundary"): all astronomical
coordinate work happens **once at setup**, on the host, in plain numpy f64,
producing flat arrays (antenna ENU offsets, per-time per-source ENU unit
vectors) that are shipped to the device. Nothing here is ever traced.

The reference uses astropy custom frames (ENU / Pointing / UVW,
SURVEY.md §2 "Coordinate frames"); astropy is not available in this image,
so the chain is implemented directly: IAU 2006 precession (Capitaine
ζ/z/θ polynomials) + truncated IAU 2000-series nutation (the 6 largest
terms, sub-arcsecond vs the full series for decades around J2000) +
equation-of-equinoxes-corrected sidereal time, then spherical trigonometry
to alt-az/ENU. Residual vs a full IAU 2000A chain: ~0.1″ from the
truncated nutation and ~23 mas from the neglected ICRS frame bias —
far below the ionospheric seeing this engine models. Set
``apply_precession_nutation=False`` for the bare-GMST legacy behaviour
(self-consistent synthetic worlds don't care; real skies do).

Conventions:
- ECEF/ITRS coordinates in km.
- ENU frame tangent at a reference ECEF point: x=East, y=North, z=Up, km.
- Times as MJD (UTC≈UT1).
- ICRS directions as (ra, dec) in radians.
"""
from __future__ import annotations

import numpy as np


# WGS84 ellipsoid (km)
WGS84_A = 6378.137
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def geodetic_to_ecef(lat, lon, height_km=0.0):
    """Geodetic (rad, rad, km) → ECEF xyz (km). WGS84."""
    lat, lon, height_km = np.broadcast_arrays(
        np.asarray(lat, np.float64), np.asarray(lon, np.float64),
        np.asarray(height_km, np.float64))
    sl, cl = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    x = (n + height_km) * cl * np.cos(lon)
    y = (n + height_km) * cl * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + height_km) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_geodetic(xyz):
    """ECEF xyz (km) → geodetic (lat, lon, height_km). Bowring's method."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    # iterate latitude
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    h = p / np.cos(lat) - n
    return lat, lon, h


def earth_curvature_radii(lat):
    """WGS84 radii of curvature at geodetic latitude ``lat`` [rad] → (Rm, Rn)
    in km: Rm = meridional (north-south), Rn = prime-vertical (east-west)."""
    sl = np.sin(np.asarray(lat, np.float64))
    w2 = 1.0 - WGS84_E2 * sl * sl
    rn = WGS84_A / np.sqrt(w2)
    rm = WGS84_A * (1.0 - WGS84_E2) / w2 ** 1.5
    return rm, rn


def gaussian_earth_radius(lat):
    """Gaussian (mean) radius of curvature sqrt(Rm*Rn) at latitude [rad], km.

    The best single spherical radius for Earth-curvature corrections over a
    local ENU window: using the osculating sphere of this radius, the
    altitude error of ``models.chapman.altitude_field`` stays ≲0.1 km out to
    ~500 km horizontal offset (vs 12–25 km of flat-Earth error there).
    """
    rm, rn = earth_curvature_radii(lat)
    return float(np.sqrt(rm * rn))


def enu_rotation(lat, lon):
    """Rows are the East/North/Up unit vectors in ECEF at (lat, lon)."""
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


class ENUFrame:
    """Local East-North-Up tangent frame at a reference ECEF point (km)."""

    def __init__(self, ref_ecef_km):
        self.ref = np.asarray(ref_ecef_km, np.float64)
        self.lat, self.lon, self.height = ecef_to_geodetic(self.ref)
        self.rot = enu_rotation(self.lat, self.lon)  # ECEF→ENU

    def from_ecef(self, xyz):
        return (np.asarray(xyz, np.float64) - self.ref) @ self.rot.T

    def to_ecef(self, enu):
        return np.asarray(enu, np.float64) @ self.rot + self.ref

    def direction_from_ecef(self, vec):
        """Rotate an ECEF direction vector into ENU (no translation)."""
        return np.asarray(vec, np.float64) @ self.rot.T


ARCSEC = np.pi / (180.0 * 3600.0)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([o, z, z], -1), np.stack([z, c, s], -1),
                     np.stack([z, -s, c], -1)], -2)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, z, -s], -1), np.stack([z, o, z], -1),
                     np.stack([s, z, c], -1)], -2)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, s, z], -1), np.stack([-s, c, z], -1),
                     np.stack([z, z, o], -1)], -2)


def precession_matrix(mjd):
    """GCRS/J2000 → mean equator & equinox of date (IAU 2006 ζ_A/z_A/θ_A,
    Capitaine et al. 2003). Shape mjd.shape + (3, 3); v_date = M @ v_icrs."""
    T = (np.asarray(mjd, np.float64) - 51544.5) / 36525.0
    zeta = (2.650545 + T * (2306.083227 + T * (0.2988499 + T * (
        0.01801828 + T * (-5.971e-6 - 3.173e-7 * T))))) * ARCSEC
    z = (-2.650545 + T * (2306.077181 + T * (1.0927348 + T * (
        0.01826837 + T * (-2.8596e-5 - 2.904e-7 * T))))) * ARCSEC
    theta = (T * (2004.191903 + T * (-0.4294934 + T * (
        -0.04182264 + T * (-7.089e-6 - 1.274e-7 * T))))) * ARCSEC
    return _rz(-z) @ _ry(theta) @ _rz(-zeta)


def mean_obliquity_rad(mjd):
    """IAU 2006 mean obliquity of the ecliptic."""
    T = (np.asarray(mjd, np.float64) - 51544.5) / 36525.0
    return (84381.406 + T * (-46.836769 + T * (-0.0001831
            + T * 0.00200340))) * ARCSEC


def nutation_angles_rad(mjd):
    """(Δψ, Δε): truncated IAU 1980/2000-series nutation — the 6 largest
    terms (≥0.07″ in Δψ), accurate to ~0.1″ for decades around J2000."""
    T = (np.asarray(mjd, np.float64) - 51544.5) / 36525.0
    d2r = np.pi / 180.0
    om = (125.04452 - 1934.136261 * T) * d2r      # lunar ascending node
    ls = (357.52772 + 35999.050340 * T) * d2r     # solar mean anomaly
    lm = (134.96298 + 477198.867398 * T) * d2r    # lunar mean anomaly
    f = (93.27191 + 483202.017538 * T) * d2r      # Moon argument of latitude
    d = (297.85036 + 445267.111480 * T) * d2r     # mean elongation
    two_lsun = 2.0 * (f - d + om)                 # ~2·solar longitude arg
    two_lmoon = 2.0 * (f + om)
    dpsi = ((-17.1996 - 0.01742 * T) * np.sin(om)
            + (-1.3187 - 0.00016 * T) * np.sin(two_lsun)
            + (-0.2274) * np.sin(two_lmoon)
            + (0.2062) * np.sin(2.0 * om)
            + (0.1426) * np.sin(ls)
            + (0.0712) * np.sin(lm)) * ARCSEC
    deps = ((9.2025 + 0.00089 * T) * np.cos(om)
            + (0.5736 - 0.00031 * T) * np.cos(two_lsun)
            + (0.0977) * np.cos(two_lmoon)
            + (-0.0895) * np.cos(2.0 * om)
            + (0.0054) * np.cos(ls)
            + (-0.0007) * np.cos(lm)) * ARCSEC
    return dpsi, deps


def nutation_matrix(mjd):
    """Mean → true equator & equinox of date."""
    eps = mean_obliquity_rad(mjd)
    dpsi, deps = nutation_angles_rad(mjd)
    return _rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)


def icrs_to_true_of_date(v_icrs, mjd):
    """Rotate ICRS cartesian vectors (..., 3) to the true equator & equinox
    of date at mjd (broadcasts: mjd.shape must broadcast with v's batch)."""
    m = nutation_matrix(mjd) @ precession_matrix(mjd)
    return np.einsum("...ij,...j->...i", m, np.asarray(v_icrs, np.float64))


def equation_of_equinoxes_rad(mjd):
    dpsi, _ = nutation_angles_rad(mjd)
    return dpsi * np.cos(mean_obliquity_rad(mjd))


def gmst_rad(mjd_ut):
    """Greenwich Mean Sidereal Time (radians), IAU-1982 linear model."""
    mjd_ut = np.asarray(mjd_ut, np.float64)
    d0 = np.floor(mjd_ut) - 51544.5          # days since J2000 at prev 0h UT
    hours = (mjd_ut % 1.0) * 24.0            # UT hours of day
    gmst_hours = (6.697374558 + 0.06570982441908 * d0
                  + 1.00273790935 * hours)
    return (gmst_hours % 24.0) * (np.pi / 12.0)


def icrs_to_enu(ra, dec, mjd, enu: ENUFrame, apply_precession_nutation=True):
    """ICRS (ra, dec) [rad] at times mjd → ENU unit vectors.

    ra/dec broadcast against mjd: returns shape broadcast(ra, mjd) + (3,).
    Equivalent to the reference's Pointing frame transform (SURVEY.md §3.2):
    precession+nutation to the true equator/equinox of date, hour angle
    from apparent sidereal time, then alt-az, then ENU components.
    """
    ra = np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    mjd = np.asarray(mjd, np.float64)
    ra, dec, mjd_b = np.broadcast_arrays(ra, dec, mjd)
    if apply_precession_nutation:
        v = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                      np.sin(dec)], axis=-1)
        v = icrs_to_true_of_date(v, mjd_b)
        ra = np.arctan2(v[..., 1], v[..., 0])
        dec = np.arcsin(np.clip(v[..., 2], -1.0, 1.0))
        lst = gmst_rad(mjd_b) + equation_of_equinoxes_rad(mjd_b) + enu.lon
    else:
        lst = gmst_rad(mjd_b) + enu.lon  # mean sidereal time only
    h = lst - ra  # hour angle
    slat, clat = np.sin(enu.lat), np.cos(enu.lat)
    sdec, cdec = np.sin(dec), np.cos(dec)
    sh, ch = np.sin(h), np.cos(h)
    sin_alt = slat * sdec + clat * cdec * ch
    # ENU components directly (az measured from North through East):
    e = -cdec * sh
    n = sdec * clat - cdec * ch * slat
    u = sin_alt
    v = np.stack([e, n, u], axis=-1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def enu_to_uvw(baselines_enu, mjd, ra, dec, enu: "ENUFrame",
               apply_precession_nutation=True):
    """Interferometric UVW coordinates of ENU baselines (km) toward a
    phase centre (ra, dec) at times mjd — the reference's UVW frame
    (SURVEY.md §2 "Coordinate frames").

    Convention: w toward the source, u toward increasing east-ish RA,
    v completing the right-handed set (toward north celestial pole
    projection). baselines_enu (..., 3); returns same shape.
    """
    if apply_precession_nutation:
        v = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                      np.sin(dec)], axis=-1)
        v = icrs_to_true_of_date(v, mjd)
        ra = np.arctan2(v[..., 1], v[..., 0])
        dec = np.arcsin(np.clip(v[..., 2], -1.0, 1.0))
        h = (gmst_rad(mjd) + equation_of_equinoxes_rad(mjd)
             + enu.lon - ra)                   # apparent hour angle
    else:
        h = gmst_rad(mjd) + enu.lon - ra  # hour angle of the phase centre
    lat = enu.lat
    # ENU -> (equatorial XYZ at the site): X toward (H=0, dec=0),
    # Y toward (H=-6h), Z toward the pole
    b = np.asarray(baselines_enu, np.float64)
    e, n, u = b[..., 0], b[..., 1], b[..., 2]
    x = -np.sin(lat) * n + np.cos(lat) * u
    y = e
    z = np.cos(lat) * n + np.sin(lat) * u
    sh, ch = np.sin(h), np.cos(h)
    sd, cd = np.sin(dec), np.cos(dec)
    uu = sh * x + ch * y
    vv = -sd * ch * x + sd * sh * y + cd * z
    ww = cd * ch * x - cd * sh * y + sd * z
    return np.stack([uu, vv, ww], axis=-1)


def solar_radec(mjd):
    """Low-precision solar ICRS (ra, dec) [rad] — ±0.01° class (adequate
    for Chapman day/night modulation; the reference used astropy's sun)."""
    mjd = np.asarray(mjd, np.float64)
    d = mjd - 51544.5
    g = np.deg2rad((357.529 + 0.98560028 * d) % 360.0)   # mean anomaly
    q = (280.459 + 0.98564736 * d) % 360.0               # mean longitude
    lam = np.deg2rad(q + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))
    eps = np.deg2rad(23.439 - 0.00000036 * d)            # obliquity
    ra = np.arctan2(np.cos(eps) * np.sin(lam), np.cos(lam)) % (2 * np.pi)
    dec = np.arcsin(np.sin(eps) * np.sin(lam))
    return ra, dec


def solar_cos_zenith(mjd, enu: ENUFrame):
    """cos of the solar zenith angle at the frame origin — the Chapman
    day/night input: pass as ``cos_chi`` to models.chapman.chapman_field.

    ``solar_radec`` returns of-date coordinates, so the hour angle uses
    apparent sidereal time directly (no precession re-application)."""
    ra, dec = solar_radec(mjd)
    h = gmst_rad(mjd) + equation_of_equinoxes_rad(mjd) + enu.lon - ra
    return (np.sin(enu.lat) * np.sin(dec)
            + np.cos(enu.lat) * np.cos(dec) * np.cos(h))


def solar_cos_zenith_field(mjd, enu: ENUFrame, x_km, y_km):
    """cos solar zenith at each horizontal ENU offset (x_km, y_km) — the
    spatially-varying day/night input for wide grids (the terminator moves
    ~28 km per minute of longitude; a ±400 km grid spans ~10° of arc).

    x_km/y_km broadcast together; returns the broadcast shape. Computed via
    the subsolar point: cos χ = sin φ sin δ + cos φ cos δ cos(λ − λ_s) with
    λ_s = α_sun − GAST. Agrees with ``solar_cos_zenith`` at the origin to
    the sub-0.1° class of ``solar_radec``.
    """
    x_km = np.asarray(x_km, np.float64)
    y_km = np.asarray(y_km, np.float64)
    ecef = enu.to_ecef(np.stack(np.broadcast_arrays(
        x_km, y_km, np.zeros_like(x_km + y_km)), axis=-1))
    lat, lon, _ = ecef_to_geodetic(ecef)
    ra, dec = solar_radec(mjd)
    gast = gmst_rad(mjd) + equation_of_equinoxes_rad(mjd)
    lon_sun = ra - gast
    return (np.sin(lat) * np.sin(dec)
            + np.cos(lat) * np.cos(dec) * np.cos(lon - lon_sun))


def enu_to_altaz(enu_vec):
    """ENU unit vector → (alt, az) in radians, az from North through East."""
    v = np.asarray(enu_vec, np.float64)
    alt = np.arcsin(np.clip(v[..., 2], -1.0, 1.0))
    az = np.arctan2(v[..., 0], v[..., 1]) % (2.0 * np.pi)
    return alt, az
