"""Turbulent ionosphere perturbations (port of
``ionotomo_tpu.models.turbulence``).

Two forms: spectral synthesis on a grid (white noise filtered by the von
Kármán amplitude with one forward/inverse 3-D FFT pair), and
``FourierModes``, an analytic band-limited realization as an explicit
random-Fourier-mode sum whose value and gradient have closed forms
everywhere, the honest data-generating world of the inversion configs.

The reference draws its white noise from ``jax.random``; here the noise
is fed in (``turbulent_log_perturbation(grid, white, ...)``), so a test
can pass the reference's own draw. ``FourierModes`` is seeded by numpy in
both packages, so its arrays are the reference's to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..device import as_tensor, resolve


def _wavenumbers(grid: Grid3D) -> torch.Tensor:
    """|k| magnitude lattice (rad/km) for the grid, rfft layout on the
    last axis."""
    nx, ny, nz = grid.shape
    dev = grid.device

    def axis(freq, d):
        return (2 * np.pi * torch.as_tensor(freq.astype(np.float32),
                                            device=dev) / grid.spacing[d])

    kx = axis(np.fft.fftfreq(nx), 0)
    ky = axis(np.fft.fftfreq(ny), 1)
    kz = axis(np.fft.rfftfreq(nz), 2)
    return torch.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                      + kz[None, None, :] ** 2)


def von_karman_amplitude(kmag, outer_scale_km=100.0, inner_scale_km=2.0,
                         exponent=-11.0 / 6.0):
    """sqrt of the von Kármán power spectrum with inner-scale rolloff:
    P(k) ∝ (k² + k0²)^(-11/6) · exp(-(k·l_i)²), k0 = 2π/L0."""
    k0 = 2 * np.pi / outer_scale_km
    li = inner_scale_km / (2 * np.pi)
    p = (kmag ** 2 + k0 ** 2) ** exponent * torch.exp(-(kmag * li) ** 2)
    return torch.sqrt(p)


def _synthesize(grid: Grid3D, white: torch.Tensor, outer_scale_km,
                inner_scale_km) -> torch.Tensor:
    """White noise (nx, ny, nz) → the unit-std von Kármán field."""
    amp = von_karman_amplitude(_wavenumbers(grid), outer_scale_km,
                               inner_scale_km)
    amp[0, 0, 0] = 0.0                                    # zero-mean field
    spec = torch.fft.rfftn(white, dim=(-3, -2, -1)) * amp
    field = torch.fft.irfftn(spec, s=grid.shape, dim=(-3, -2, -1))
    std = torch.std(field, dim=(-3, -2, -1), keepdim=True,
                    correction=0) + 1e-20
    return (field / std).to(torch.float32)


def turbulent_log_perturbation(grid: Grid3D, white, amplitude=0.5,
                               outer_scale_km=100.0, inner_scale_km=2.0):
    """One realization of a zero-mean log-n_e perturbation: amplitude ×
    the unit-std von Kármán field made from the white noise ``white``
    (nx, ny, nz) (numpy or a tensor; the reference draws it from its
    PRNG key)."""
    white = as_tensor(white, device=grid.device).to(grid.device)
    return amplitude * _synthesize(grid, white, float(outer_scale_km),
                                   float(inner_scale_km))


def turbulent_realizations(grid: Grid3D, white, amplitude=0.5,
                           outer_scale_km=100.0, inner_scale_km=2.0):
    """A batch of independent realizations, (n, *grid.shape), from white
    noise (n, nx, ny, nz); each is normalised by its own std."""
    return turbulent_log_perturbation(grid, white, amplitude, outer_scale_km,
                                      inner_scale_km)


class FourierModes:
    """Analytic band-limited von Kármán realization as an explicit
    random-Fourier-mode sum:

        m_pert(x) = a · Σ_j cos(k_j · x + φ_j),   a = amplitude·√(2/K)

    with wavevector magnitudes drawn from the normalized radial spectral
    density p(k) ∝ k²·(k² + k0²)^{-11/6}·exp(−(k l_i/2π)²) truncated to
    [0, k_max] (inverse CDF on a dense table), directions uniform on the
    sphere, phases uniform. Value and gradient have closed forms
    everywhere: no grid, no interpolant.

    The reference scans over the modes; here all modes of a chunk of
    points are summed in one (N, K) pass (full f32 matmul), so the sum's
    order differs from the scan's in the last bits. ``ks`` (K, 3),
    ``phases`` (K,) and ``amp`` live on ``device`` (the card by default).
    """

    #: (points × modes) elements one pass may hold: bounds the (N, K)
    #: temporaries (a 256³ grid of points is summed in chunks)
    PASS_ELEMENTS = 1 << 27

    def __init__(self, n_modes, amplitude, outer_scale_km, kmax_rad_km,
                 inner_scale_km=2.0, seed=0, device=None):
        rng = np.random.default_rng(seed)
        k0 = 2 * np.pi / outer_scale_km
        li = inner_scale_km / (2 * np.pi)
        kt = np.linspace(0.0, kmax_rad_km, 4097)
        pdf = kt**2 * (kt**2 + k0**2) ** (-11.0 / 6.0) \
            * np.exp(-((kt * li) ** 2))
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        kmag = np.interp(rng.uniform(size=n_modes), cdf, kt)
        u = rng.normal(size=(n_modes, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        dev = resolve(device)
        self.ks = torch.tensor((kmag[:, None] * u).astype(np.float32),
                               device=dev)
        self.phases = torch.tensor(
            rng.uniform(0, 2 * np.pi, n_modes).astype(np.float32),
            device=dev)
        self.amp = float(np.float32(amplitude * np.sqrt(2.0 / n_modes)))

    @classmethod
    def from_arrays(cls, ks: torch.Tensor, phases: torch.Tensor,
                    amp: float) -> "FourierModes":
        out = object.__new__(cls)
        out.ks, out.phases, out.amp = ks, phases, float(amp)
        return out

    def shifted(self, dx) -> "FourierModes":
        """The world advected rigidly by ``dx`` (km): exact frozen-flow
        evolution in closed form, cos(k·(x−dx)+φ) = cos(k·x+(φ−k·dx)), a
        phase shift with no grid and no periodic wrap."""
        check_full_f32()
        dx = torch.as_tensor(np.asarray(dx, np.float32),
                             device=self.ks.device)
        return FourierModes.from_arrays(self.ks, self.phases - self.ks @ dx,
                                        self.amp)

    def _chunks(self, pts: torch.Tensor):
        step = max(1, self.PASS_ELEMENTS // max(1, self.ks.shape[0]))
        return pts.split(step)

    def value(self, pts: torch.Tensor) -> torch.Tensor:
        """m_pert at pts (N, 3)."""
        check_full_f32()
        out = [torch.cos(p @ self.ks.T + self.phases).sum(-1)
               for p in self._chunks(pts)]
        return self.amp * torch.cat(out)

    def value_and_grad(self, pts: torch.Tensor):
        """(m_pert (N,), ∇m_pert (N, 3)) in 1/km, exact."""
        check_full_f32()
        vals, grads = [], []
        for p in self._chunks(pts):
            th = p @ self.ks.T + self.phases
            vals.append(torch.cos(th).sum(-1))
            grads.append(-(torch.sin(th) @ self.ks))
        return self.amp * torch.cat(vals), self.amp * torch.cat(grads)


def analytic_ne_fn(modes: FourierModes, background):
    """Closed-form turbulent-world evaluator for the callable tracer:
    n_e(x) = n_bg(x)·e^{m_pert(x)}, with the exact gradient
    ∇n_e = e^{m_pert}·(∇n_bg + n_bg·∇m_pert). ``background`` is a
    ``chapman.background_ne_fn`` evaluator."""
    def ne_and_grad(x):
        nb, gb = background(x)
        mp, gmp = modes.value_and_grad(x)
        e = torch.exp(mp)
        return nb * e, e[:, None] * (gb + nb[:, None] * gmp)
    return ne_and_grad
