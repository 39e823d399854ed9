"""Empirical-Bayes prior hyperparameter estimation from the dTEC data
(port of ``ionotomo_tpu.inversion.empirical_bayes``).

Estimate the GPCovariance hyperparameters (σ_m, L) — and a common
noise rescaling ρ — from the observed dTEC by maximising the exact
linear-Gaussian marginal likelihood

    r = d − g(m_prior) ~ N(0, S(γ, L)),   S = γ·J C₀(L) Jᵀ + ρ²·σ_n² I

with J the linearised dTEC operator about the prior mean, C₀ the
unit-variance covariance and γ = σ_m². In whitened form S̃ = γ·Ã + ρ²·I,
so one spectral factorisation of Ã prices the whole (γ, ρ) plane in
closed form; only the outer loop over candidate L re-factorises. Two
factorisation regimes, as in the reference:

- **dense** (n ≤ ``dense_threshold``, the pipeline's set-up scale): Ã
  assembled from n batched matvecs, 128 identity columns a batch (a
  member axis of the operator: K2b and K3b on the card), then one (n, n)
  eigendecomposition on the host in f64 (the ρ axis lives in the
  small-eigenvalue tail of a ~10-decade spectrum; f32 leaves ~1 %
  log-evidence error there). Exact for every (γ, ρ).
- **slq**: stochastic Lanczos quadrature (Ubaru–Chen–Saad 2017) with
  full reorthogonalisation over a batch of Rademacher probes plus the
  data seed, (n_probes + 1)·k matvecs. Accurate for the γ axis only.

The probes are fed in (``probes``); without them ``fit_hyperparameters``
draws them from ``utils.draws.rademacher`` keyed by its seed.
"""
from __future__ import annotations


import numpy as np
import torch

from ..core.grids import Grid3D
from ..device import host
from ..geometry.rays import RayBundle
from .priors import GPCovariance
from .solvers import _dtec_operator, _noise_vector

#: The constant that keys the Lanczos probes (``utils.draws.rademacher``).
DRAW_SLQ = 0x51C0


def _lanczos_batch(matvec, v0s: torch.Tensor, k: int):
    """Lanczos with full reorthogonalisation over a batch of seeds.

    ``v0s`` (m, n) unit-norm seeds; ``matvec`` maps (m, n) → (m, n).
    Returns (alphas (m, k), betas (m, k-1)). Breakdown (β → 0: the Krylov
    space is exhausted) freezes the recursion: the spurious trailing Ritz
    values get ~zero quadrature weight.
    """
    m, n = v0s.shape
    V = torch.zeros((m, k, n), dtype=v0s.dtype, device=v0s.device)
    V[:, 0] = v0s
    v, v_prev = v0s, torch.zeros_like(v0s)
    beta_prev = torch.zeros(m, dtype=v0s.dtype, device=v0s.device)
    alphas, betas = [], []
    for j in range(k):
        w = matvec(v)
        alpha = torch.sum(w * v, dim=1)
        w = w - alpha[:, None] * v - beta_prev[:, None] * v_prev
        # full reorthogonalisation against all stored vectors (V holds
        # zeros beyond step j, which project to nothing)
        proj = torch.sum(V * w[:, None, :], dim=-1)
        w = w - torch.sum(proj[:, :, None] * V, dim=1)
        beta = torch.linalg.norm(w, dim=1)
        ok = beta > 1e-7
        v_next = torch.where(ok[:, None],
                             w / torch.clamp_min(beta, 1e-30)[:, None], v)
        if j + 1 < k:
            V[:, j + 1] = torch.where(ok[:, None], v_next,
                                      torch.zeros_like(v_next))
        v, v_prev = (torch.where(ok[:, None], v_next, v),
                     torch.where(ok[:, None], v, v_prev))
        beta_prev = torch.where(ok, beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta_prev)
    return torch.stack(alphas, 1), torch.stack(betas, 1)[:, :-1]


def _ritz(alphas: torch.Tensor, betas: torch.Tensor):
    """Ritz values θ (m, k) and quadrature weights w = (e₁ᵀq)² (m, k)
    from batched Lanczos tridiagonals."""
    T = (torch.diag_embed(alphas) + torch.diag_embed(betas, 1)
         + torch.diag_embed(betas, -1))
    theta, Q = torch.linalg.eigh(T)
    return theta, Q[:, 0, :] ** 2


def _whitened_operator(grid, rays, d_obs, noise_std, m_prior, cov_unit,
                       num_directions, i0, quadrature, interp):
    """Shared prep: the whitened residual r̃, the batched matvec of
    Ã = D^{-1/2} J C₀ Jᵀ D^{-1/2} over (b, n) blocks, and the logdet of
    the noise whitener. Heteroscedastic noise is absorbed by the
    whitening, so the family stays affine: logdet S = logdet S̃ + Σ log
    σᵢ²."""
    m_prior = torch.as_tensor(m_prior, dtype=torch.float32,
                              device=grid.device)
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32,
                            device=m_prior.device)
    d = d_obs.reshape(-1)
    apply_j, apply_jt, g0 = _dtec_operator(
        grid, rays, num_directions, i0, m_prior, None,
        quadrature=quadrature, interp=interp)
    sd = _noise_vector(noise_std, d_obs.shape, d)
    inv_sd = 1.0 / torch.clamp_min(sd, 1e-30)
    r = inv_sd * (d - g0)
    logdet_noise = 2.0 * torch.sum(torch.log(sd))

    def a_batched(y):
        v = cov_unit.apply(apply_jt(inv_sd * y))
        return inv_sd * apply_j(v)

    return a_batched, r, logdet_noise


def _assemble_dense(grid, rays, d_obs, noise_std, m_prior, cov_unit,
                    num_directions, i0, quadrature, interp, chunk=128):
    """Ã assembled column block by column block (``chunk`` identity
    columns a batch, so the batched grid-sized intermediates stay
    bounded): n matvecs."""
    a_batched, r, logdet_noise = _whitened_operator(
        grid, rays, d_obs, noise_std, m_prior, cov_unit, num_directions,
        i0, quadrature, interp)
    n = r.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=r.device)
    A = torch.cat([a_batched(eye[c:c + chunk])
                   for c in range(0, n, chunk)])  # row i = (Ã e_i)ᵀ
    return A, r, logdet_noise


def _slq_summary(grid, rays, d_obs, noise_std, m_prior, cov_unit,
                 num_directions, i0, quadrature, interp, probes,
                 lanczos_iters):
    """Ritz values + Gauss-quadrature weights for the Rademacher
    ``probes`` (n_probes, n) and the data seed: one batched Lanczos."""
    a_batched, r, logdet_noise = _whitened_operator(
        grid, rays, d_obs, noise_std, m_prior, cov_unit, num_directions,
        i0, quadrature, interp)
    n = r.shape[0]
    z = torch.as_tensor(probes, dtype=torch.float32, device=r.device)
    z = z / torch.sqrt(torch.tensor(float(n)))
    r_norm = torch.linalg.norm(r)
    seeds = torch.cat([z, (r / torch.clamp_min(r_norm, 1e-30))[None]], 0)
    alphas, betas = _lanczos_batch(a_batched, seeds, lanczos_iters)
    theta, w = _ritz(alphas, betas)
    theta = torch.clamp_min(theta, 0.0)   # Ã is PSD: clip f32 Ritz leakage
    return theta, w, r_norm, logdet_noise


def log_marginal_family(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                        m_prior, cov_unit: GPCovariance, gammas,
                        num_directions: int, i0: int = 0,
                        quadrature: str = "hermite",
                        interp: str = "cubic", n_probes: int = 8,
                        lanczos_iters: int = 48, probes=None,
                        noise_scales=None, method: str = "slq", seed: int = 0):
    """log ML(γ[, ρ]) for S = γ·J C₀ Jᵀ + ρ²·diag(σ_n²), priced from one
    spectral factorisation (module docstring). Returns (log_ml (n_γ,),
    diag) when ``noise_scales`` is None, else (log_ml (n_γ, n_ρ), diag),
    as float64 numpy.

    ``method="slq"``: stochastic Lanczos quadrature over the Rademacher
    ``probes`` (n_probes, n_data; None: drawn from ``seed``).
    ``method="dense"``: Ã assembled and eigendecomposed, exact for every
    (γ, ρ); use it wherever ρ is fitted.
    """
    if method == "dense":
        A, r, logdet_noise = _assemble_dense(
            grid, rays, d_obs, noise_std, m_prior, cov_unit,
            num_directions, i0, quadrature, interp)
        A64 = host(A).astype(np.float64)
        r64 = host(r).astype(np.float64)
        n = r64.shape[0]
        lam, U = np.linalg.eigh(0.5 * (A64 + A64.T))
        lam = np.maximum(lam, 0.0)
        proj2 = (U.T @ r64) ** 2
        r_norm2 = float(r64 @ r64)
        th_z = lam[None, :]                 # exact spectrum, weight 1/n
        w_z = np.full((1, n), 1.0 / n)
        th_r, w_r = lam, proj2 / max(r_norm2, 1e-30)
        ld_noise = float(logdet_noise)
    else:
        n = int(torch.as_tensor(d_obs).numel())
        if probes is None:
            from ..utils.draws import rademacher
            probes = rademacher(seed, DRAW_SLQ, 0, (n_probes, n))
        th, w, r_norm, logdet_noise = _slq_summary(
            grid, rays, d_obs, noise_std, m_prior, cov_unit,
            num_directions, i0, quadrature, interp, probes, lanczos_iters)
        th = host(th).astype(np.float64)
        w = host(w).astype(np.float64)
        th_z, w_z = th[:-1], w[:-1]   # probe runs → logdet
        th_r, w_r = th[-1], w[-1]     # data-seeded run → quadratic form
        r_norm2 = float(r_norm) ** 2
        ld_noise = float(logdet_noise)

    gammas_np = np.asarray(host(gammas), np.float64).ravel()
    rho2s = (np.asarray([1.0], np.float64) if noise_scales is None
             else np.asarray(host(noise_scales), np.float64).ravel() ** 2)
    # pricing is closed form in the factorisation: on the host in f64 for
    # both methods
    g = gammas_np[:, None, None]                     # (nγ, 1, 1)
    p = rho2s[None, :, None]                         # (1, nρ, 1)
    logdet = n * np.mean(
        np.sum(w_z[None, None] * np.log(g[..., None] * th_z[None, None]
                                        + p[..., None]), axis=-1),
        axis=-1) + ld_noise                          # (nγ, nρ)
    quad = r_norm2 * np.sum(w_r / (g * th_r[None, None] + p), axis=-1)
    log_ml = -0.5 * (quad + logdet + n * np.log(2 * np.pi))
    if noise_scales is None:
        log_ml = log_ml[:, 0]
    return log_ml, {"ritz_probe": th_z, "ritz_data": th_r,
                    "r_norm": np.sqrt(r_norm2)}


def fit_hyperparameters(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                        m_prior, num_directions: int,
                        length_scales, sigmas, kind: str = "von_karman",
                        i0: int = 0, quadrature: str = "hermite",
                        interp: str = "cubic", n_probes: int = 8,
                        lanczos_iters: int = 48, seed: int = 0,
                        noise_scales=None, dense_threshold: int = 4096,
                        probes=None):
    """Maximise the dTEC marginal likelihood over (σ_m, L[, ρ]) grids.

    Host loop over ``length_scales`` (each L one spectral
    factorisation); the σ_m axis, and with ``noise_scales`` the ρ axis,
    priced in closed form from each. Data spaces up to
    ``dense_threshold`` rows use the exact dense family; larger ones SLQ
    over ``probes`` (n_probes, n_data; None: drawn from ``seed``, the
    same probes for every L as the reference's one key gives). Returns
    (sigma*, length_scale*, ll_table (n_L, n_σ), fitted GPCovariance);
    with ``noise_scales``: (sigma*, length_scale*, rho*, ll_table (n_L,
    n_σ, n_ρ), fitted GPCovariance).
    """
    length_scales = [float(v) for v in np.asarray(length_scales).ravel()]
    sigmas = np.asarray(sigmas, np.float64).ravel()
    n_data = int(torch.as_tensor(d_obs).numel())
    lanczos_iters = min(lanczos_iters, n_data)
    method = "dense" if n_data <= dense_threshold else "slq"
    if method == "slq" and probes is None:
        from ..utils.draws import rademacher
        probes = rademacher(seed, DRAW_SLQ, 0, (n_probes, n_data))
    gammas = np.asarray(sigmas ** 2, np.float32)
    rhos = (None if noise_scales is None
            else np.asarray(noise_scales, np.float64).ravel()
            .astype(np.float32))
    rows = []
    for ell in length_scales:
        cov_l = GPCovariance.create(grid, sigma=1.0, length_scale=ell,
                                    kind=kind)
        ll, _ = log_marginal_family(grid, rays, d_obs, noise_std, m_prior,
                                    cov_l, gammas, num_directions, i0,
                                    quadrature, interp, n_probes,
                                    lanczos_iters, probes=probes,
                                    noise_scales=rhos, method=method)
        rows.append(np.asarray(ll))
    table = np.stack(rows)             # (n_L, n_sigma[, n_rho])
    idx = np.unravel_index(int(np.argmax(table)), table.shape)
    sigma_star = float(sigmas[idx[1]])
    ell_star = float(length_scales[idx[0]])
    cov_star = GPCovariance.create(grid, sigma=sigma_star,
                                   length_scale=ell_star, kind=kind)
    if noise_scales is None:
        return sigma_star, ell_star, table, cov_star
    rho_star = float(np.asarray(noise_scales, np.float64).ravel()[idx[2]])
    return sigma_star, ell_star, rho_star, table, cov_star
