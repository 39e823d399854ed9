"""Physical constants and unit conventions for the TPU-native tomography engine.

Numerical contract (SURVEY.md §8, reconstructed from the reference's physics;
reference mount was empty at build time — see SURVEY.md §0):

- Geometry is carried in **kilometres** (ENU frame of the array centre).
- Electron density ``n_e`` is carried in **m^-3**.
- Plasma frequency: ``f_p [Hz] = 8.98 * sqrt(n_e [m^-3])``.
- Refractive index (Appleton-Hartree, no B-field / collisions):
  ``n = sqrt(1 - (f_p / f)^2) = sqrt(1 - KAPPA * n_e / f^2)``.
- Log-parametrisation: ``n_e(x) = K_NE * exp(m(x))`` with ``K_NE = 1e11 m^-3``
  so that the inversion unknown ``m`` is dimensionless and positivity of
  ``n_e`` is automatic.
- TEC = integral of n_e along the ray in **m^-2**; 1 TECU = 1e16 m^-2.
  The working scale used throughout solver internals is ``TEC_SCALE = 1e13``
  (i.e. milli-TECU), matching the reference's ~1e13 working units.
"""

# n_e normalisation for the log-parametrisation m = log(n_e / K_NE).
K_NE = 1e11  # [m^-3]

# f_p = PLASMA_COEF * sqrt(n_e)  -> f_p^2 = KAPPA * n_e
PLASMA_COEF = 8.98  # [Hz m^(3/2)]
KAPPA = PLASMA_COEF * PLASMA_COEF  # ≈ 80.64  [Hz^2 m^3]

# Unit conversions.
KM_TO_M = 1.0e3
TECU = 1.0e16          # [m^-2] per TECU
TEC_SCALE = 1.0e13     # working scale for solver internals (1 mTECU)

# Earth (spherical model used by the host-side geometry; the synthetic world
# is self-consistent so a spherical Earth is exact for it).
EARTH_RADIUS_KM = 6371.0

# Dispersive phase: Δφ [rad] = PHASE_COEF · TEC [m^-2] / f [Hz]
# (e² / (4 π ε0 m_e c) = 1.3445 m²/s; PHASE_COEF = 2π × 1.3445/(2π) ... the
# standard radio-astronomy value is 8.4479745e9 rad·Hz/TECU ⇒ per m^-2:)
PHASE_COEF = 8.4479745e9 / 1.0e16  # [rad · Hz · m²]

# Default observing frequency (LOFAR HBA band centre).
DEFAULT_FREQUENCY_HZ = 150.0e6

# Default ray extent: ~1000 km slant length, ~100 quadrature samples
# (SURVEY.md §8: "straight-line length ≈ 1000 km with ~100 Simpson samples").
DEFAULT_MAX_LENGTH_KM = 1000.0
DEFAULT_N_SAMPLES = 129  # odd so composite Simpson applies exactly
