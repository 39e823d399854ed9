"""The paired differential-TEC forward model with the Hermite rule, and its
linearisation by automatic differentiation, in plain PyTorch.

For a straight bundle of R = Na·Nd rays with S samples each (uniform
spacing ds per ray, ray r = i·Nd + k), the data of antenna i and
direction k are

    dTEC[i, k] = (Σ_n q_n (n_e(x_ikn) − n_e(x_0kn)) ds_ik
                 + ((f'_ik,0 − f'_ik,S) − (f'_0k,0 − f'_0k,S)) ds_ik²/12)
                 · 1e3 / 1e13,

q the trapezoid weights, n_e = 1e11·exp(m) with m the field model's
interpolant, and f' = n_e·(∇m · t̂) the path derivative at a ray's first
and last sample, t̂ the unit tangent of its first and last segment. J is
``torch.func.jvp`` of that map and Jᵀ ``torch.func.vjp``: the reference
derives what the program writes out by hand.
"""
from __future__ import annotations

import torch

from .interp import contract, model as field_model, rnd

K_NE = 1e11
SCALE = 1.0e3 / 1.0e13


class Bundle:
    """What depends only on the ray samples: the stencils of every sample
    and of the end samples (with gradient weights), the end tangents and
    the trapezoid weights."""

    def __init__(self, grid, points: torch.Tensor, ds: torch.Tensor,
                 n_dirs: int, model: str):
        self.model = field_model(model)
        stencil = self.model.stencil
        self.grid = grid
        self.r, self.s = points.shape[:2]
        self.na, self.nd = self.r // n_dirs, n_dirs
        self.ds = ds.reshape(self.na, self.nd)
        self.idx, self.w = stencil(grid, points.reshape(-1, 3))
        ends = torch.cat([points[:, 0], points[:, -1]], 0)
        seg = torch.cat([points[:, 1] - points[:, 0],
                         points[:, -1] - points[:, -2]], 0)
        self.t_hat = seg / torch.linalg.norm(seg, dim=-1, keepdim=True)
        self.e_idx, self.e_w, self.e_g = stencil(grid, ends, grad=True)
        q = torch.ones(self.s, device=points.device)
        q[0] = q[-1] = 0.5
        self.q = q

    def table(self, m: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        """The model's table of a field (..., nx, ny, nz), flattened."""
        m = self.model.table(m, tf32)
        return m.reshape(m.shape[:-3] + (-1,))

    def forward(self, m: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        """dTEC (..., Na·Nd) of fields m (..., nx, ny, nz)."""
        lead = m.shape[:-3]
        flat = self.table(m, tf32)
        ne = K_NE * torch.exp(contract(flat, self.idx, self.w, tf32))
        ne = ne.reshape(lead + (self.na, self.nd, self.s))
        vals = rnd(flat[..., self.e_idx], tf32)
        m_e = (vals * rnd(self.e_w, tf32)).sum(-1)
        gm_e = (vals[..., None] * rnd(self.e_g, tf32)).sum(-2)
        dnds = K_NE * torch.exp(m_e) * (gm_e * self.t_hat).sum(-1)
        corr = (dnds[..., :self.r] - dnds[..., self.r:]).reshape(
            lead + (self.na, self.nd))
        corr = corr - corr[..., 0:1, :]
        dne = ne - ne[..., 0:1, :, :]
        out = ((rnd(dne, tf32) * self.q).sum(-1) * self.ds
               + corr * self.ds * self.ds / 12.0) * SCALE
        return out.reshape(lead + (-1,))


class Linear:
    """The forward over a bundle linearised about fields m0 (..., nx, ny,
    nz): ``g0``, ``apply`` (J) and ``apply_t`` (Jᵀ)."""

    def __init__(self, bundle: Bundle, m0: torch.Tensor, tf32: bool = False):
        self.f = lambda m: bundle.forward(m, tf32)
        self.m0 = m0
        self.g0, self._vjp = torch.func.vjp(self.f, m0)

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        return torch.func.jvp(self.f, (self.m0,), (dm,))[1]

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        return self._vjp(y)[0]
