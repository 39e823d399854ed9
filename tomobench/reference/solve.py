"""The prior, conjugate gradients and the MAP Gauss-Newton step, in plain
PyTorch and numpy.

The prior is a stationary von Karman covariance C on the grid, applied as
C^{1/2} v = F⁻¹(sqrt(S)·F v) with the real 3-D FFT. Its spectrum S is the
turbulence spectrum (k² + k0²)^{-11/6}·exp(−(k·l_i)²), k0 = 2π/L0, l_i =
2/(2π) km, with S(0) = 0, scaled so that Σ over the full spectrum is N·σ².

A MAP step about m_k with the prior pulled at m_p solves (I + C^{1/2} Jᵀ
C_d⁻¹ J C^{1/2}) u = C^{1/2} Jᵀ C_d⁻¹ (d − g(m_k) − J(m_p − m_k)) by a
fixed number of CG iterations, frozen once ‖r‖ ≤ tol·‖b‖, optionally from
a warm start rescaled along A x0; then m = m_p + C^{1/2} u, and the
residual is ‖(g(m_k) + J(m − m_k) − d)/σ‖.
"""
from __future__ import annotations

import numpy as np
import torch

from .operator import Bundle, Linear

_DIMS = (-3, -2, -1)


class Prior:
    def __init__(self, grid, sigma: float, outer_km: float,
                 inner_km: float = 2.0):
        nx, ny, nz = grid.shape
        sp = grid.spacing.cpu().numpy().astype(np.float64)
        fx, fy = np.fft.fftfreq(nx, sp[0]), np.fft.fftfreq(ny, sp[1])
        fz = np.fft.rfftfreq(nz, sp[2])
        k = 2 * np.pi * np.sqrt(fx[:, None, None] ** 2 + fy[None, :, None] ** 2
                                + fz[None, None, :] ** 2)
        k0 = 2 * np.pi / outer_km
        li = inner_km / (2 * np.pi)
        s = (k ** 2 + k0 ** 2) ** (-11.0 / 6.0) * np.exp(-((k * li) ** 2))
        s[0, 0, 0] = 0.0
        mult = np.full(s.shape, 2.0)
        mult[:, :, 0] = 1.0
        if nz % 2 == 0:
            mult[:, :, -1] = 1.0
        s = s * (sigma ** 2 * nx * ny * nz / (s * mult).sum())
        self.shape = (nx, ny, nz)
        self.root = torch.from_numpy(np.sqrt(s.astype(np.float32))).to(
            grid.device)

    def sqrt(self, v: torch.Tensor) -> torch.Tensor:
        return torch.fft.irfftn(torch.fft.rfftn(v, dim=_DIMS) * self.root,
                                s=self.shape, dim=_DIMS)


def cg(matvec, b, x0=None, iters=10, tol=1e-4, scale_x0=False):
    """Conjugate gradients over a flat vector, its updates frozen once it
    has converged."""
    def dot(u, v):
        return (u * v).sum()

    def safe(d):
        return torch.where(d == 0, torch.ones_like(d), d)

    x = torch.zeros_like(b) if x0 is None else x0
    if scale_x0:
        ax = matvec(x)
        den = dot(ax, ax)
        a0 = torch.where(den > 0, dot(b, ax) / safe(den), torch.zeros_like(den))
        x, r = a0 * x, b - a0 * ax
    else:
        r = b - matvec(x)
    p = r
    tol2 = (tol * torch.sqrt(dot(b, b))) ** 2
    rz = dot(r, r)
    done = rz <= tol2
    for _ in range(iters):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(done | (pap == 0), torch.zeros_like(pap),
                            rz / safe(pap))
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = dot(r, r)
        new_done = done | (rz_new <= tol2)
        beta = torch.where(new_done | (rz == 0), torch.zeros_like(rz),
                           rz_new / safe(rz))
        p = r + beta * p
        rz, done = rz_new, new_done
    return x


def map_step(bundle: Bundle, prior: Prior, d, sigma, m_prior, m_k, u0,
             iters: int, tol: float = 1e-4, tf32: bool = False):
    """One Gauss-Newton MAP step (module docstring): (m, u, residual)."""
    shape = prior.shape
    op = Linear(bundle, m_k, tf32)
    inv_cd = 1.0 / (sigma * sigma)
    dm_p = m_prior - m_k
    r_hat = d - op.g0 - op.apply(dm_p)

    def matvec(x):
        w = op.apply(prior.sqrt(x.reshape(shape))) * inv_cd
        return x + prior.sqrt(op.apply_t(w)).reshape(-1)

    rhs = prior.sqrt(op.apply_t(r_hat * inv_cd)).reshape(-1)
    u = cg(matvec, rhs, x0=u0, iters=iters, tol=tol, scale_x0=True)
    dm = dm_p + prior.sqrt(u.reshape(shape))
    res = torch.linalg.norm((op.g0 + op.apply(dm) - d) / sigma)
    return m_k + dm, u, res
