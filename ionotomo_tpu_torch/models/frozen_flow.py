"""Frozen-flow advection (Taylor's hypothesis) as a spectral shift (port of
``ionotomo_tpu.models.frozen_flow``).

``n_e(x, t+Δt) = n_e(x − v·Δt, t)``: a sub-voxel-exact translation as a
Fourier phase ramp with periodic boundary, one FFT pair (cuFFT through
``torch.fft`` on the card) and no gather. It is both the simulation's time
evolution and the Kalman filters' transition operator.

Periodicity caveat: content advected past a face re-enters on the opposite
face. Grids are built with padding beyond the ray volume, so wrapped
content stays outside the rays for the modest shifts (v·Δt ≪ grid extent)
of a 30-step observation window.

The fields may carry leading axes (an ensemble's member axis): the FFTs
run over the last three. The shift is a tensor or array-like and is never
read on the host, so a filter's time loop queues its steps without
waiting for the card.
"""
from __future__ import annotations

import math

import torch

from ..core.grids import Grid3D

_DIMS = (-3, -2, -1)


def _freqs(grid: Grid3D, device):
    nx, ny, nz = grid.shape
    kx = torch.fft.fftfreq(nx, device=device)[:, None, None]
    ky = torch.fft.fftfreq(ny, device=device)[None, :, None]
    kz = torch.fft.rfftfreq(nz, device=device)[None, None, :]
    return kx, ky, kz


def _ramp(angle: torch.Tensor) -> torch.Tensor:
    """exp(i·angle) for a real angle."""
    return torch.polar(torch.ones_like(angle), angle)


def _shear_slices(grid: Grid3D, shift: torch.Tensor):
    """ζ (nz,) ∈ [−1, 1] and the per-slice voxel shifts sx, sy (nz,) of
    the (2, 3) rigid + shear form."""
    nz = grid.shape[2]
    mean, shear = shift[0], shift[1]
    zeta = ((2.0 * torch.arange(nz, dtype=torch.float32, device=shift.device)
             - (nz - 1)) / max(nz - 1, 1))
    sx = (mean[0] + zeta * shear[0]) / grid.spacing[0]
    sy = (mean[1] + zeta * shear[1]) / grid.spacing[1]
    return zeta, sx, sy


def advect_periodic(field: torch.Tensor, grid: Grid3D, shift_km
                    ) -> torch.Tensor:
    """Translate ``field`` (..., nx, ny, nz) by ``shift_km`` with spectral
    interpolation.

    ``shift_km`` shapes:
      (3,)   rigid translation: sample the field at x − shift with
             periodic boundary (one 3-D FFT pair, no gather).
      (2,3)  rigid + vertical shear: row 0 is the mid-grid shift, row 1
             the horizontal shift *difference* reached at the grid's top
             and bottom faces; each z-slice translates by ``row0[:2] +
             ζ(z)·row1[:2]`` with ζ ∈ [−1, 1] the normalised height. A
             per-slice 2-D phase ramp (one complex 2-D FFT pair, real part
             kept: the convention for the even-size Nyquist bin under
             fractional shifts), then row 0's rigid vertical shift as a
             1-D ramp. Row 1's vertical component is ignored.
    """
    nx, ny, nz = grid.shape
    shift = torch.as_tensor(shift_km, dtype=torch.float32,
                            device=field.device)
    kx, ky, kz = _freqs(grid, field.device)
    if shift.dim() == 1:
        s = shift / grid.spacing                              # voxels
        angle = -2.0 * math.pi * (kx * s[0] + ky * s[1] + kz * s[2])
        spec = torch.fft.rfftn(field, dim=_DIMS) * _ramp(angle)
        return torch.fft.irfftn(spec, s=(nx, ny, nz), dim=_DIMS
                                ).to(field.dtype)
    _, sx, sy = _shear_slices(grid, shift)
    angle = -2.0 * math.pi * (kx * sx[None, None, :] + ky * sy[None, None, :])
    spec = torch.fft.fft2(field, dim=(-3, -2)) * _ramp(angle)
    out = torch.fft.ifft2(spec, dim=(-3, -2)).real
    angle_z = -2.0 * math.pi * kz * (shift[0, 2] / grid.spacing[2])
    spec_z = torch.fft.rfft(out, dim=-1) * _ramp(angle_z)
    return torch.fft.irfft(spec_z, n=nz, dim=-1).to(field.dtype)


def advect_periodic_tangents(field: torch.Tensor, grid: Grid3D, shift_km
                             ) -> torch.Tensor:
    """∂ advect_periodic(field, grid, shift) / ∂ shift, one field per
    component of the shift, stacked on a new leading axis in the shift's
    row-major order: (3, nx, ny, nz) for a rigid shift, (6, ...) for the
    (2, 3) form (the last, row 1's vertical component, is zero). The ramp
    is analytic in the shift, so each tangent is the same FFT pair with
    the spectrum multiplied by −2πi·k/h; the wind adaptation of the
    filters takes its Jacobian columns from here, where the reference
    takes forward tangents of the same function."""
    nx, ny, nz = grid.shape
    shift = torch.as_tensor(shift_km, dtype=torch.float32,
                            device=field.device)
    kx, ky, kz = _freqs(grid, field.device)
    h = grid.spacing

    def d_ramp(k):                        # −2πi·k as a complex factor
        a = -2.0 * math.pi * k
        return torch.complex(torch.zeros_like(a), a)

    if shift.dim() == 1:
        s = shift / h
        angle = -2.0 * math.pi * (kx * s[0] + ky * s[1] + kz * s[2])
        spec = torch.fft.rfftn(field, dim=_DIMS) * _ramp(angle)
        return torch.stack([
            torch.fft.irfftn(spec * (d_ramp(k) / h[d]), s=(nx, ny, nz),
                             dim=_DIMS).to(field.dtype)
            for d, k in enumerate((kx, ky, kz))])
    zeta, sx, sy = _shear_slices(grid, shift)
    angle = -2.0 * math.pi * (kx * sx[None, None, :] + ky * sy[None, None, :])
    spec = torch.fft.fft2(field, dim=(-3, -2)) * _ramp(angle)
    angle_z = -2.0 * math.pi * kz * (shift[0, 2] / h[2])
    ramp_z = _ramp(angle_z)

    def finish(spec_xy, factor_z=None):
        out = torch.fft.ifft2(spec_xy, dim=(-3, -2)).real
        spec_z = torch.fft.rfft(out, dim=-1) * ramp_z
        if factor_z is not None:
            spec_z = spec_z * factor_z
        return torch.fft.irfft(spec_z, n=nz, dim=-1).to(field.dtype)

    zs = zeta[None, None, :]
    d_mx = finish(spec * (d_ramp(kx) / h[0]))
    d_my = finish(spec * (d_ramp(ky) / h[1]))
    d_mz = finish(spec, d_ramp(kz) / h[2])
    d_sx = finish(spec * (d_ramp(kx) * zs / h[0]))
    d_sy = finish(spec * (d_ramp(ky) * zs / h[1]))
    return torch.stack([d_mx, d_my, d_mz, d_sx, d_sy,
                        torch.zeros_like(d_mx)])


def estimate_wind(field_a, field_b, grid: Grid3D, dt_s, n_iters=200, lr=0.05,
                  v0=(0.0, 0.0, 0.0), horizontal_only=True):
    """Estimate the bulk wind between two snapshots (Taylor hypothesis).

    Minimises ‖advect(field_a, v·Δt) − field_b‖² over v by Adam (written
    out, as in the reference); the gradient comes from ``torch.autograd``
    through ``torch.fft``. Fields should be zero-mean perturbations
    (subtract the background first). Returns (v [km/s] (3,), the loss
    history (n_iters,)).

    ``horizontal_only`` (default) pins v_z = 0: ionospheric frozen flow is
    horizontal drift, and near-vertical ray geometry leaves the vertical
    shift of reconstructed snapshots essentially unconstrained.
    """
    a = field_a - torch.mean(field_a)
    b = field_b - torch.mean(field_b)
    dev = a.device
    mask = torch.tensor([1.0, 1.0, 0.0 if horizontal_only else 1.0],
                        device=dev)
    v = torch.as_tensor(v0, dtype=torch.float32, device=dev).clone()
    m = torch.zeros(3, device=dev)
    s = torch.zeros(3, device=dev)
    hist = []
    for t in range(1, n_iters + 1):
        v_leaf = v.detach().requires_grad_(True)
        with torch.enable_grad():
            pred = advect_periodic(a, grid, (v_leaf * mask) * dt_s)
            val = torch.mean((pred - b) ** 2)
        (g,) = torch.autograd.grad(val, v_leaf)
        g = g * mask
        m = 0.9 * m + 0.1 * g
        s = 0.999 * s + 0.001 * g * g
        v = v - lr * (m / (1 - 0.9 ** t)) / (torch.sqrt(s / (1 - 0.999 ** t))
                                             + 1e-12)
        hist.append(val.detach())
    return v, torch.stack(hist)


def frozen_flow_sequence(field0, grid: Grid3D, wind_kmps, dt_s, n_steps):
    """Stack of n_steps fields advected by t·v·Δt, t = 0 .. n_steps−1."""
    wind = torch.as_tensor(wind_kmps, dtype=torch.float32,
                           device=field0.device)
    return torch.stack([advect_periodic(field0, grid, wind * (t * dt_s))
                        for t in range(n_steps)])
