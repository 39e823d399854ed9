"""Matrix-free Krylov solvers (port of ``cg`` and ``lsqr`` from
``ionotomo_tpu.core.linalg``).

The reference's rules hold: a fixed trip count with masked convergence.
Once a system converges its updates are frozen by ``torch.where``, so the
loop never asks the host whether to stop: no ``.item()``, ``bool(t)`` or
``float(t)`` inside it, and the device runs ahead of the Python loop. The
solvers take flat tensors (the reference's pytree operands are not
needed by the port's callers).

Not ported: the reference's ``core/linalg.py:subspace_eigs`` (ROADMAP.md
Queue 1, diagnostics only) and ``spectral_preconditioner`` (skipped by
design).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveInfo(NamedTuple):
    iterations: torch.Tensor     # iteration at which convergence froze (or max)
    residual_norm: torch.Tensor  # final ‖r‖ (CG) or ‖Aᵀr‖ (LSQR)
    converged: torch.Tensor      # bool


def _vdot(a: torch.Tensor, b: torch.Tensor, batch_dims: int = 0
          ) -> torch.Tensor:
    """⟨a, b⟩; with ``batch_dims`` leading system axes, one product per
    system, kept broadcastable against a and b."""
    if batch_dims == 0:
        return torch.sum(a * b)
    return torch.sum(a * b, dim=tuple(range(batch_dims, a.dim())),
                     keepdim=True)


def _safe(den: torch.Tensor) -> torch.Tensor:
    """den with zeros replaced by 1, for a guarded division."""
    return torch.where(den == 0, torch.ones_like(den), den)


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       max_iters: int = 100, tol: float = 1e-6,
       preconditioner: Callable | None = None, scale_x0: bool = False,
       batch_dims: int = 0):
    """Conjugate gradients for an SPD ``matvec``.

    ``batch_dims``: the number of leading axes of ``b`` that index
    independent systems solved at once (an ensemble's member axis);
    ``matvec`` then maps the whole batch. Every scalar of the iteration
    (α, β, the convergence mask, the iteration count) is per system, masked
    per system, which is what ``jax.vmap`` of the reference's ``cg`` does;
    ``SolveInfo``'s fields then have the batch's shape.

    Stops updating (masked) once ‖r‖ ≤ tol·‖b‖. Returns (x, SolveInfo).
    ``scale_x0``: rescale the warm start to α·x0 with α = ⟨b, A x0⟩/
    ⟨A x0, A x0⟩ before iterating (the 1-D least-squares minimiser along
    it; α = 0 recovers a cold start when the guess is useless), reusing
    the A x0 product for r0.
    """
    x0 = torch.zeros_like(b) if x0 is None else x0
    M = preconditioner or (lambda v: v)

    def dot(u, v):
        return _vdot(u, v, batch_dims)

    if scale_x0:
        ax0 = matvec(x0)
        denom = dot(ax0, ax0)
        alpha0 = torch.where(denom > 0, dot(b, ax0) / _safe(denom),
                             torch.zeros_like(denom))
        x0 = alpha0 * x0
        r0 = b - alpha0 * ax0
    else:
        r0 = b - matvec(x0)
    z = M(r0)
    p = z
    tol2 = (tol * torch.sqrt(dot(b, b))) ** 2
    rz = dot(r0, z)
    x, r = x0, r0
    done = rz <= tol2
    it = torch.zeros_like(done, dtype=torch.int32)
    for _ in range(max_iters):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(done | (pap == 0), torch.zeros_like(pap),
                            rz / _safe(pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = dot(r, z)
        rr = dot(r, r)
        new_done = done | (rr <= tol2)
        beta = torch.where(new_done | (rz == 0), torch.zeros_like(rz),
                           rz_new / _safe(rz))
        p = z + beta * p
        it = it + (~new_done).to(torch.int32)
        rz, done = rz_new, new_done
    rnorm = torch.sqrt(dot(r, r))
    lead = b.shape[:batch_dims]
    return x, SolveInfo(iterations=it.reshape(lead),
                        residual_norm=rnorm.reshape(lead),
                        converged=done.reshape(lead))


def lsqr(aop: Callable, atop: Callable, b: torch.Tensor,
         x_shape_like: torch.Tensor, damp: float = 0.0,
         max_iters: int = 100, tol: float = 1e-6):
    """LSQR (Paige–Saunders bidiagonalisation) for min ‖Ax − b‖² +
    damp²‖x‖². aop: x → Ax, atop: y → Aᵀy; ``x_shape_like`` gives the
    model-space zero. Masked fixed-iteration form. Returns (x, SolveInfo)
    with residual_norm the exact final ‖Aᵀ(b − Ax) − damp²x‖ (one extra
    aop and atop after the loop)."""
    def norm(v):
        return torch.sqrt(torch.sum(v * v))

    x = torch.zeros_like(x_shape_like)
    beta = norm(b)
    u = b / _safe(beta)
    v_raw = atop(u)
    alpha = norm(v_raw)
    v = v_raw / _safe(alpha)
    w = v
    phibar = beta
    rhobar = alpha
    # stopping: ‖Aᵀr‖ ≤ tol·‖A‖·‖r‖ proxy via tol·alpha0·beta0
    thresh = tol * alpha * beta
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    done = alpha * beta <= thresh
    for _ in range(max_iters):
        # bidiagonalisation
        u_raw = aop(v) - alpha * u
        beta_n = norm(u_raw)
        u_n = u_raw / _safe(beta_n)
        v_raw = atop(u_n) - beta_n * v
        alpha_n = norm(v_raw)
        v_n = v_raw / _safe(alpha_n)
        # damped rotation
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
        c1 = rhobar / _safe(rhobar1)
        phibar_d = c1 * phibar
        # Givens rotation
        rho = torch.sqrt(rhobar1 ** 2 + beta_n ** 2)
        c = rhobar1 / _safe(rho)
        s = beta_n / _safe(rho)
        theta = s * alpha_n
        rhobar_n = -c * alpha_n
        phi = c * phibar_d
        phibar_n = s * phibar_d

        step = torch.where(done, torch.zeros_like(phi), phi / _safe(rho))
        x = x + step * w
        w_n = v_n - (theta / _safe(rho)) * w
        w = torch.where(done, w, w_n)
        u = torch.where(done, u, u_n)
        v = torch.where(done, v, v_n)
        # ‖Aᵀr‖ ≈ |phibar · alpha · c| (phibar carries an alternating sign
        # through the signed damping rotation)
        atr = torch.abs(phibar_n * alpha_n * c)
        new_done = done | (atr <= thresh)
        it = it + (~new_done).to(torch.int32)
        alpha = torch.where(done, alpha, alpha_n)
        beta = torch.where(done, beta, beta_n)
        phibar = torch.where(done, phibar, phibar_n)
        rhobar = torch.where(done, rhobar, rhobar_n)
        done = new_done
    atr_final = norm(atop(b - aop(x)) - (damp * damp) * x)
    return x, SolveInfo(iterations=it, residual_norm=atr_final,
                        converged=done)
