"""Prior hyperparameter selection for the voxel inversion by generalised
cross-validation (port of ``ionotomo_tpu.inversion.model_selection``).

    GCV(σ, L) = R · ‖(I − S) r‖² / (R − tr S)²,
    S = J C Jᵀ (J C Jᵀ + C_d)⁻¹   (the data-space influence matrix)

S·y is one covariance-preconditioned CG solve (map_gauss_newton's
machinery); tr S is Hutchinson's estimate over Rademacher probes. The
residual and the probes go through one batched CG (``batch_dims=1``), a
member axis of the operator (K2b and K3b on the card), where the
reference vmaps its probe solves. The probes are fed in; without them
``select_prior`` draws them from ``utils.draws.rademacher`` keyed by its
seed, one set for every candidate as the reference's one key gives.
"""
from __future__ import annotations

import torch

from ..core import linalg
from ..core.grids import Grid3D
from ..geometry.rays import RayBundle
from .priors import GPCovariance
from .solvers import _dtec_operator, _noise_vector

#: The constant that keys the GCV probes (``utils.draws.rademacher``).
DRAW_GCV = 0x6C5


def gcv_score(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m0,
              cov: GPCovariance, num_directions: int, probes, i0: int = 0,
              cg_iters: int = 30, cg_tol: float = 1e-4) -> torch.Tensor:
    """GCV score of one prior candidate (lower is better), a 0-d tensor.

    Linearises about m0 (normally the prior mean; Hermite quadrature on
    the cubic model, the reference's defaults) and scores how well the
    posterior generalises: the numerator is the leave-out-like residual,
    the denominator penalises the effective degrees of freedom tr S,
    estimated with the Rademacher ``probes`` (n_probes, n_data).
    """
    m0 = torch.as_tensor(m0, dtype=torch.float32, device=grid.device)
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32, device=m0.device)
    d = d_obs.reshape(-1)
    cd_diag = _noise_vector(noise_std, d_obs.shape, d) ** 2
    inv_cd = 1.0 / cd_diag
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m0)
    r = d - g0
    z = torch.as_tensor(probes, dtype=r.dtype, device=r.device)
    ys = torch.cat([r[None], z])               # the residual, then probes
    n_sys = ys.shape[0]
    shape = (n_sys,) + tuple(grid.shape)

    def matvec(u):
        v = cov.apply_sqrt(u.reshape(shape))
        w = apply_j(v) * inv_cd
        return u + cov.apply_sqrt(apply_jt(w)).reshape(n_sys, -1)

    # S y = J·dm(y): the data-space prediction of the MAP update fitted to
    # the data residual y, every y one system of the batch
    rhs = cov.apply_sqrt(apply_jt(ys * inv_cd)).reshape(n_sys, -1)
    u, _ = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol,
                     batch_dims=1)
    s_y = apply_j(cov.apply_sqrt(u.reshape(shape)))
    n_data = r.shape[0]
    tr_s = torch.mean(torch.sum(z * s_y[1:], dim=-1))
    tr_s = torch.clamp(tr_s, 0.0, n_data - 1.0)
    resid = torch.sum(((r - s_y[0]) / torch.sqrt(cd_diag)) ** 2)
    return n_data * resid / (n_data - tr_s) ** 2


def select_prior(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m0,
                 candidates, num_directions: int, probes=None, seed: int = 0,
                 i0: int = 0, cg_iters: int = 30, n_probes: int = 4):
    """Score a list of prior candidates and return the winner.

    candidates: iterable of dicts accepted by ``GPCovariance.create``
    (sigma, length_scale, kind). ``probes`` (n_probes, n_data): the
    Rademacher probes, shared by every candidate (None: drawn from
    ``seed``). Returns (best_cov, best_params, scores) with scores a
    list of floats aligned to candidates.
    """
    from ..utils.draws import rademacher

    candidates = list(candidates)
    if probes is None:
        n_data = int(torch.as_tensor(d_obs).numel())
        probes = rademacher(seed, DRAW_GCV, 0, (n_probes, n_data))
    scores, covs = [], []
    for params in candidates:
        cov = GPCovariance.create(grid, **params)
        covs.append(cov)
        scores.append(float(gcv_score(
            grid, rays, d_obs, noise_std, m0, cov,
            num_directions=num_directions, probes=probes, i0=i0,
            cg_iters=cg_iters)))
    best = min(range(len(scores)), key=scores.__getitem__)
    return covs[best], candidates[best], scores
