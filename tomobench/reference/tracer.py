"""The bent-ray tracer in plain PyTorch: d/ds (n t̂) = ∇n, dx/ds = t̂, with
p = n·t̂, n = sqrt(1 − KAPPA·n_e/f²) clipped at 1e-6 (its gradient zero
where clipped), n_e = 1e11·exp(m) from the field model's interpolant.
Velocity-Verlet leapfrog, one field evaluation a step, TEC by the Hermite
rule h/2·(f₀ + f₁) + h²/12·(f₀′ − f₁′) a step."""
from __future__ import annotations

import numpy as np
import torch

from .interp import model as field_model, rnd

K_NE = 1e11
KAPPA = 8.98 * 8.98


def trace(field: torch.Tensor, grid, origins: torch.Tensor,
          directions: torch.Tensor, frequency_hz: float, length_km: float,
          n_steps: int, model: str = "zp", tf32: bool = False):
    """(endpoints (R, 3), TEC (R,) in 1e13 m⁻²) of rays from ``origins``
    along unit ``directions`` over ``length_km`` in ``n_steps`` steps."""
    fm = field_model(model)
    stencil = fm.stencil
    flat = fm.table(field, tf32).reshape(-1)

    def ne_vg(x):
        idx, w, g = stencil(grid, x, grad=True)
        vals = rnd(flat[idx], tf32)
        m = (vals * rnd(w, tf32)).sum(-1)
        gm = (vals[..., None] * rnd(g, tf32)).sum(-2)
        ne = K_NE * torch.exp(m)
        return ne, ne[:, None] * gm

    dev = origins.device
    h = torch.tensor(np.float32(length_km / n_steps), device=dev)
    inv_f2 = torch.tensor(np.float32(1.0 / (frequency_hz * frequency_hz)),
                          device=dev)
    w = KAPPA * inv_f2
    unit = 1.0e3 / 1.0e13

    def rhs(x, p):
        ne, gne = ne_vg(x)
        clipped = 1.0 - w * ne <= 1e-6
        n = torch.sqrt(torch.clamp_min(1.0 - w * ne, 1e-6))
        gn = torch.where(clipped[:, None], 0.0, (-0.5 * w / n)[:, None] * gne)
        t = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        return gn, ne, (gne * t).sum(-1)

    ne0, _ = ne_vg(origins)
    wf = KAPPA / (frequency_hz * frequency_hz)
    p = torch.sqrt(torch.clamp_min(1.0 - wf * ne0, 1e-6))[:, None] \
        * directions
    gn, ne, dne = rhs(origins, p)
    x = origins
    tau = torch.zeros(origins.shape[0], dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        p_half = p + (0.5 * h) * gn
        x = x + h * (p_half / torch.linalg.norm(p_half, dim=-1, keepdim=True))
        gn_new, ne_new, dne_new = rhs(x, p_half)
        p = p_half + (0.5 * h) * gn_new
        tau = tau + ((0.5 * h) * (ne + ne_new)
                     + (h * h / 12.0) * (dne - dne_new)) * unit
        gn, ne, dne = gn_new, ne_new, dne_new
    return x, tau
