"""Model priors: the smoothness operator and a stationary GP covariance
applied by FFT (port of ``laplacian`` and ``GPCovariance`` from
``ionotomo_tpu.inversion.priors``).

The covariance's spectrum is built once on the host in numpy, exactly as
the reference builds it (circulant embedding of a closed-form kernel, or
the von Kármán spectrum itself), and applied with ``torch.fft`` in f32 on
the spectrum's device (cuFFT on the card). ``fit_shell_spectrum`` fits
the stationary isotropic spectrum of sample fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grids import Grid3D

_DIMS = (-3, -2, -1)


def laplacian(field: torch.Tensor, grid: Grid3D) -> torch.Tensor:
    """Second-difference Laplacian with replicated edges (1/km² units):
    the smoothness-prior operator L of config 3's ‖L m‖²."""
    out = torch.zeros_like(field)
    for ax in range(3):
        up = torch.roll(field, -1, dims=ax)
        dn = torch.roll(field, 1, dims=ax)
        # replicate edges: roll wraps, overwrite the wrapped slabs
        last = [slice(None)] * 3
        last[ax] = slice(-1, None)
        first = [slice(None)] * 3
        first[ax] = slice(0, 1)
        up[tuple(last)] = field[tuple(last)]
        dn[tuple(first)] = field[tuple(first)]
        out = out + (up - 2.0 * field + dn) / (grid.spacing[ax] ** 2)
    return out


def _rfft_multiplicity(nx: int, ny: int, nz: int) -> np.ndarray:
    """Conjugate-pair multiplicity of the rfftn half-spectrum layout:
    interior kz planes stand for two full-FFT modes, the kz=0 (and, for
    even nz, Nyquist) planes for one."""
    w = np.full((nx, ny, nz // 2 + 1), 2.0, np.float32)
    w[:, :, 0] = 1.0
    if nz % 2 == 0:
        w[:, :, -1] = 1.0
    return w


def _kernel_values(r, kind: str, length_scale: float):
    """Stationary kernel k(r), r in km, unit variance."""
    x = r / length_scale
    if kind == "exponential":
        return np.exp(-x)
    if kind == "sqexp":
        return np.exp(-0.5 * x * x)
    if kind == "matern32":
        a = np.sqrt(3.0) * x
        return (1.0 + a) * np.exp(-a)
    if kind == "matern52":
        a = np.sqrt(5.0) * x
        return (1.0 + a + a * a / 3.0) * np.exp(-a)
    raise ValueError(f"unknown kernel kind: {kind}")


def _spectrum(shape, spacing, sigma, ls3, kind, inner_scale) -> np.ndarray:
    """The rfftn-layout PSD spectrum (f64), as the reference's ``create``
    computes it."""
    nx, ny, nz = shape
    sp = spacing
    if kind == "von_karman":
        # the turbulence spectrum itself, normalised to marginal σ²;
        # length_scale plays the outer scale L0
        ax = [np.fft.fftfreq(nx, sp[0]), np.fft.fftfreq(ny, sp[1]),
              np.fft.rfftfreq(nz, sp[2])]
        kmag = 2 * np.pi * np.sqrt(
            ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2
            + ax[2][None, None, :] ** 2)
        li = inner_scale / (2 * np.pi)
        if np.all(ls3 == ls3[0]):
            k0 = 2 * np.pi / ls3[0]
            spec = (kmag**2 + k0**2) ** (-11.0 / 6.0) \
                * np.exp(-((kmag * li) ** 2))
        else:
            # anisotropic outer scale on the stretched wavevector
            ks2 = (2 * np.pi) ** 2 * (
                (ax[0][:, None, None] * ls3[0]) ** 2
                + (ax[1][None, :, None] * ls3[1]) ** 2
                + (ax[2][None, None, :] * ls3[2]) ** 2)
            spec = (ks2 + (2 * np.pi) ** 2) ** (-11.0 / 6.0) \
                * np.exp(-((kmag * li) ** 2))
        spec[0, 0, 0] = 0.0  # zero-mean field
        # scale so that Σ_full S = N σ² (marginal variance σ² under the
        # apply/sample convention)
        w = _rfft_multiplicity(nx, ny, nz)
        n_tot = float(nx * ny * nz)
        s_full = float((spec * w).sum())
        return spec * (sigma**2 * n_tot / max(s_full, 1e-300))
    # circulant embedding of a closed-form kernel on the periodic
    # (minimum-image) distance lattice
    ax = [np.minimum(np.arange(n), n - np.arange(n)) * sp[d]
          for d, n in enumerate(shape)]
    if np.all(ls3 == ls3[0]):
        r = np.sqrt(ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2
                    + ax[2][None, None, :] ** 2)
        k = (sigma ** 2) * _kernel_values(r, kind, ls3[0])
    else:
        r = np.sqrt((ax[0][:, None, None] / ls3[0]) ** 2
                    + (ax[1][None, :, None] / ls3[1]) ** 2
                    + (ax[2][None, None, :] / ls3[2]) ** 2)
        k = (sigma ** 2) * _kernel_values(r, kind, 1.0)
    return np.maximum(np.fft.rfftn(k).real, 0.0)  # PSD-ify


@dataclasses.dataclass(frozen=True)
class GPCovariance:
    """Stationary GP covariance operator on a Grid3D, applied spectrally.

    ``spectrum`` (nx, ny, nz//2+1) f32 in the rfftn layout, PSD. The
    operators act on the last three axes, so a leading batch axis rides
    along.
    """

    spectrum: torch.Tensor
    shape: tuple
    sigma: float
    length_scale: object       # scalar, or (Lx, Ly, Lz) tuple (anisotropic)
    kind: str

    @staticmethod
    def create(grid: Grid3D, sigma=1.0, length_scale=50.0,
               kind="exponential", inner_scale=2.0) -> "GPCovariance":
        """``length_scale`` is a scalar (isotropic) or a 3-sequence (Lx,
        Ly, Lz) of per-axis correlation lengths [km] (the outer scale L0
        for ``kind="von_karman"``). The spectrum lands on the grid's
        device."""
        sp = grid.spacing.cpu().numpy().astype(np.float64)
        ls = np.asarray(length_scale, np.float64).reshape(-1)
        if ls.size not in (1, 3):
            raise ValueError(
                f"length_scale must be scalar or 3-sequence (Lx, Ly, Lz), "
                f"got {ls.size} values")
        ls_meta = (float(ls[0]) if ls.size == 1
                   else tuple(float(v) for v in ls))
        ls3 = np.full(3, ls[0]) if ls.size == 1 else ls
        spec = _spectrum(grid.shape, sp, sigma, ls3, kind, inner_scale)
        return GPCovariance(
            spectrum=torch.tensor(spec.astype(np.float32), device=grid.device),
            shape=tuple(grid.shape), sigma=float(sigma),
            length_scale=ls_meta, kind=kind)

    def _irfftn(self, spec: torch.Tensor, dtype) -> torch.Tensor:
        return torch.fft.irfftn(spec, s=self.shape, dim=_DIMS).to(dtype)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """C_m v — spectral multiply, O(N log N)."""
        spec = torch.fft.rfftn(v, dim=_DIMS) * self.spectrum
        return self._irfftn(spec, v.dtype)

    def apply_sqrt(self, v: torch.Tensor) -> torch.Tensor:
        """C_m^{1/2} v — for sampling and symmetric preconditioning."""
        spec = torch.fft.rfftn(v, dim=_DIMS) * torch.sqrt(self.spectrum)
        return self._irfftn(spec, v.dtype)

    def apply_inv(self, v: torch.Tensor, floor_ratio=1e-6) -> torch.Tensor:
        """C_m^{-1} v with a spectral floor for numerical stability."""
        floor = floor_ratio * torch.max(self.spectrum)
        spec = torch.fft.rfftn(v, dim=_DIMS) / torch.maximum(self.spectrum,
                                                             floor)
        return self._irfftn(spec, v.dtype)

    def contract(self, v: torch.Tensor) -> torch.Tensor:
        """φᵀ C_m⁻¹ φ — the prior term of the MAP objective."""
        return torch.sum(v * self.apply_inv(v))

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """Sample(s) with covariance C_m (zero mean) from white noise of
        shape ``self.shape`` or (n, *self.shape): y = F⁻¹(√S · F w). The
        noise is an argument (torch's generators cannot reproduce
        ``jax.random`` streams; tests draw it with numpy)."""
        return self.apply_sqrt(noise)


def fit_shell_spectrum(anomalies: torch.Tensor, grid: Grid3D,
                       n_bins: int = 48, ddof: int = 1) -> torch.Tensor:
    """Isotropic (shell-averaged) covariance spectrum from sample fields.

    ``anomalies``: (n, nx, ny, nz) zero-mean sample fields (e.g. ensemble
    deviations from their mean). Returns an rfftn-layout spectrum ``S``
    such that ``GPCovariance(spectrum=S, ...)`` is the best *stationary
    isotropic* approximation of the samples' covariance: the periodogram
    ``|F a|² / (n−ddof)·N`` is averaged over log-spaced shells of physical
    |k| (multiplicity-weighted for the rfft half-spectrum) and broadcast
    back per mode. Shell averaging pools thousands of modes per estimate,
    so even an 8-member ensemble yields a low-variance spectrum. The shell
    sums are ``tricubic.scatter_add_``'s, the same on every run.
    """
    from ..core.tricubic import scatter_add_

    n = anomalies.shape[0]
    nx, ny, nz = anomalies.shape[1:]
    n_tot = nx * ny * nz
    dev = anomalies.device
    f = torch.fft.rfftn(anomalies, dim=_DIMS)
    p = torch.sum(torch.abs(f) ** 2, dim=0) / (max(n - ddof, 1) * n_tot)

    sp = grid.spacing.to(torch.float32)

    def _freqs(nn, d):
        i = torch.arange(nn, device=dev)
        return torch.where(i <= nn // 2, i, i - nn) / (nn * d)
    fx = _freqs(nx, sp[0])
    fy = _freqs(ny, sp[1])
    fz = torch.arange(nz // 2 + 1, device=dev) / (nz * sp[2])
    kmag = 2 * torch.pi * torch.sqrt(fx[:, None, None] ** 2
                                     + fy[None, :, None] ** 2
                                     + fz[None, None, :] ** 2)
    dims = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    kmin = 2 * torch.pi * torch.min(1.0 / (dims * sp))
    kmax = torch.max(kmag)
    edges = torch.exp(torch.linspace(float(torch.log(0.999 * kmin)),
                                     float(torch.log(1.001 * kmax)), n_bins,
                                     device=dev))
    bins = torch.searchsorted(edges, kmag.reshape(-1))    # 0 = DC only

    w = torch.from_numpy(_rfft_multiplicity(nx, ny, nz)).to(dev).reshape(-1)
    num = scatter_add_(torch.zeros(n_bins + 1, device=dev), bins,
                       p.reshape(-1) * w)
    den = scatter_add_(torch.zeros(n_bins + 1, device=dev), bins, w)
    shell = num / torch.clamp_min(den, 1e-30)
    s = shell[bins].reshape(kmag.shape)
    s[0, 0, 0] = 0.0
    return s
