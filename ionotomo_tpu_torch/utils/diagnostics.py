"""Turbulence diagnostics: phase structure function over the array (a
numpy copy of ``ionotomo_tpu.utils.diagnostics``, bitwise on the same
inputs).

The standard characterisation of ionospheric calibration data (and of a
reconstruction's realism): D(b) = <(φ(x) − φ(x+b))²> versus baseline
length b. Kolmogorov/von Kármán turbulence gives D ∝ b^{5/3} below the
outer scale; the diffractive scale r_diff is where D = 1 rad². Host-side
numpy (a set-up and reporting tool, not a hot path), consuming either raw
(positions, values) or a DataPack's phase view.
"""
from __future__ import annotations

import numpy as np


def structure_function(positions_km, values, n_bins: int = 12):
    """Binned structure function of per-antenna samples.

    positions_km: (Na, 2|3) antenna positions; values: (Na, M) — M
    independent realisations per antenna (directions × times for phases).
    Returns (bin_center_km (B,), D (B,), n_pairs (B,)) over log-spaced
    baseline bins; empty bins carry D = nan.
    """
    p = np.asarray(positions_km, np.float64)[:, :2]
    v = np.asarray(values, np.float64)
    na = p.shape[0]
    iu, ju = np.triu_indices(na, k=1)
    b = np.linalg.norm(p[iu] - p[ju], axis=-1)            # (P,)
    d2 = np.mean((v[iu] - v[ju]) ** 2, axis=-1)           # (P,)
    lo = max(b[b > 0].min(), 1e-6)
    edges = np.geomspace(0.999 * lo, 1.001 * b.max(), n_bins + 1)
    idx = np.clip(np.digitize(b, edges) - 1, 0, n_bins - 1)
    n = np.bincount(idx, minlength=n_bins).astype(np.float64)
    s = np.bincount(idx, weights=d2, minlength=n_bins)
    r = np.bincount(idx, weights=b, minlength=n_bins)
    with np.errstate(invalid="ignore"):
        return (np.where(n > 0, r / n, np.nan),
                np.where(n > 0, s / np.maximum(n, 1), np.nan), n)


def phase_structure_function(datapack, frequency_hz=None, n_bins: int = 12):
    """Structure function of a DataPack's phases (rad²) vs baseline (km).

    Pools all (time, direction) samples as realisations. Returns
    (baseline_km, D_rad2, n_pairs)."""
    phase = datapack.phase(frequency_hz)                  # (Na, Nt, Nd)
    na = phase.shape[0]
    pos = datapack.antennas_enu()
    return structure_function(pos, phase.reshape(na, -1), n_bins=n_bins)


def fit_structure_exponent(baseline_km, d, r_max_km=None):
    """Log-log LS fit D ≈ C·b^β over valid bins (optionally b < r_max).

    Returns (beta, c, r_diff_km): r_diff is where the fit crosses 1 rad²
    (np.inf if the fit never reaches it within 10× the fitted range) —
    Kolmogorov expects beta ≈ 5/3.
    """
    r = np.asarray(baseline_km, np.float64)
    y = np.asarray(d, np.float64)
    ok = np.isfinite(r) & np.isfinite(y) & (y > 0) & (r > 0)
    if r_max_km is not None:
        ok &= r < r_max_km
    if ok.sum() < 2:
        raise ValueError("need >=2 valid structure-function bins to fit")
    lx, ly = np.log(r[ok]), np.log(y[ok])
    beta, logc = np.polyfit(lx, ly, 1)
    c = float(np.exp(logc))
    if beta <= 0:
        return float(beta), c, np.inf
    r_diff = (1.0 / c) ** (1.0 / beta)
    if r_diff > 10.0 * r[ok].max():
        r_diff = np.inf
    return float(beta), c, float(r_diff)
