"""Bent-ray Fermat tracer (port of ``ionotomo_tpu.geometry.fermat``).

Rays in an isotropic refractive medium obey d/ds (n t̂) = ∇n, dx/ds = t̂.
With p := n·t̂ this is the first-order system dx/ds = p/|p|,
dp/ds = ∇n(x), n = sqrt(1 − KAPPA·n_e/f²) the cold-plasma
Appleton–Hartree index, n_e = K_NE·exp(m(x)) from the interpolated
log-density field. The TEC path integral rides along as extra state.

``trace_rays`` with ``method="leapfrog"`` and a zp field model runs
kernel K1 on CUDA tensors: all steps of a ray in one thread, one launch.
Every other combination, and every CPU tensor, runs ``_trace_impl``, the
port of the reference's integrator loop (a Python loop in place of
``lax.scan``); on CUDA its zp field evaluations are kernel K1e.
``trace_rays_ref`` is the plain PyTorch version of the whole tracer.

Not ported yet (ROADMAP.md Queue 1 item 12): ``trace_rays_split``,
``trace_rays_callable``, ``straight_line_limit_error``, the stochastic
beam trace and ``beam_noise_for_epoch``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants, kernels
from ..core import boxspline
from ..core.grids import Grid3D
from ..device import as_tensor
from .rays import RayBundle


def refractive_index(ne, frequency_hz):
    """n = sqrt(1 − KAPPA·n_e/f²), clipped above 0 for over-dense plasma."""
    w = constants.KAPPA / (frequency_hz * frequency_hz)
    return torch.sqrt(torch.clamp_min(1.0 - w * ne, 1e-6))


def log_field_ne_vg(interp_vg):
    """Adapt a log-density evaluator ``interp_vg(x) -> (m, ∇m)`` to the
    integrator's (n_e, ∇n_e) contract: n_e = K_NE·e^m, ∇n_e = n_e·∇m
    [m⁻³/km]."""

    def ne_vg(x):
        m, gm = interp_vg(x)
        ne = constants.K_NE * torch.exp(m)
        return ne, ne[:, None] * gm

    return ne_vg


def _rhs(ne_vg, x: torch.Tensor, p: torch.Tensor, inv_f2: torch.Tensor):
    """Batched ODE right-hand side.

    x, p: (R, 3). Returns (dx/ds (R,3), dp/ds (R,3), n_e (R,), dn_e/ds).
    One field evaluation serves all four. Where the over-dense clip is
    active n is held constant, so its gradient is zeroed too.
    """
    ne, gne = ne_vg(x)                                    # (R,), (R, 3)
    w = constants.KAPPA * inv_f2
    clipped = 1.0 - w * ne <= 1e-6                        # over-dense plasma
    n = torch.sqrt(torch.clamp_min(1.0 - w * ne, 1e-6))   # (R,)
    grad_n = torch.where(clipped[:, None], 0.0,
                         (-0.5 * w / n)[:, None] * gne)   # (R, 3)
    tangent = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    dne_ds = torch.einsum("rd,rd->r", gne, tangent)
    return tangent, grad_n, ne, dne_ds


def _not_ported(interp: str, item: str):
    return NotImplementedError(
        f"interp={interp!r} is not ported to ionotomo_tpu_torch yet "
        f"(ROADMAP.md {item}); the port has the zp model ('zp', "
        f"'zp<order>')")


def _zp_table(field_m: torch.Tensor, grid: Grid3D, interp: str):
    """The prefiltered (nx*ny, nz) zp coefficient table, or raise for the
    field models the port does not have yet."""
    if interp == "cubic":
        raise _not_ported(interp, "Queue 1 item 6, kernel K5")
    if interp.startswith("zpc"):     # before "zp": shared prefix
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    if interp.startswith("zp"):
        nx, ny, nz = grid.shape
        order = boxspline.zp_order(interp)
        return boxspline.prefilter(field_m, order).reshape(nx * ny, nz)
    if interp == "quadratic":
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    raise ValueError(f"unknown interp: {interp!r}")


def field_evaluator(field_m: torch.Tensor, grid: Grid3D,
                    interp: str = "cubic"):
    """Build the log-density ``(m, ∇m)`` evaluator for a C¹ field model,
    paying the prefilter once. Only the zp model (``zp``/``zp<order>``:
    Zwart-Powell box spline ⊗ quadratic-z, 8 row gathers) is ported;
    ``cubic``, ``zpc*`` and ``quadratic`` raise NotImplementedError."""
    coef2d = _zp_table(field_m, grid, interp)
    return lambda x: boxspline.interp_rows_with_grad(coef2d, grid, x)


def _step_constants(frequency_hz, max_length_km, n_steps):
    """K1's f32 scalars as the plain integrator rounds them: h =
    f32(L/n_steps), h·h/12, w_rhs = f32(KAPPA)·f32(1/f²) (the _rhs
    value), w_n = f32(KAPPA/f² in f64) (the refractive_index value), K_NE
    and the TEC unit."""
    h = np.float32(max_length_km / n_steps)
    inv_f2 = np.float32(1.0 / (frequency_hz * frequency_hz))
    return dict(
        h=float(h),
        hh12=float(h * h / np.float32(12.0)),
        w_rhs=float(np.float32(constants.KAPPA) * inv_f2),
        w_n=float(np.float32(constants.KAPPA / (frequency_hz
                                                * frequency_hz))),
        k_ne=float(np.float32(constants.K_NE)),
        tec_unit=float(np.float32(constants.KM_TO_M / constants.TEC_SCALE)),
    )


def trace_rays(field_m: torch.Tensor, grid: Grid3D, origins: torch.Tensor,
               directions: torch.Tensor, frequency_hz,
               max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
               n_steps: int = 128, keep_path: bool = True,
               method: str = "rk4", interp: str = "cubic"):
    """Trace all rays at once; returns (RayBundle, tec).

    origins, directions: (R, 3), directions unit-norm; numpy inputs go
    to the grid's device, tensors keep theirs. The bundle holds
    n_steps+1 uniformly-spaced (in arc length) sample positions per ray;
    ``tec`` is the path integral of n_e in TEC_SCALE working units. With
    ``keep_path=False`` only the endpoints are kept.

    Integrators: ``rk4`` (4 field evaluations per step, the accuracy
    reference) and ``leapfrog`` (velocity Verlet, one field evaluation per
    step, Hermite 4th-order TEC; leapfrog@64 is the production
    configuration). On CUDA, leapfrog over zp is kernel K1.
    """
    origins = as_tensor(origins, device=grid.device)
    directions = as_tensor(directions, device=grid.device)
    if origins.is_cuda and method == "leapfrog":
        coef2d = _zp_table(field_m, grid, interp)
        c = _step_constants(frequency_hz, max_length_km, n_steps)
        x_end, tau, path = kernels.trace_leapfrog_zp(
            coef2d, grid, origins.contiguous(), directions.contiguous(),
            n_steps, keep_path, **c)
        pts = path if keep_path else torch.stack([origins, x_end], dim=1)
        ds = torch.full((origins.shape[0],), c["h"], dtype=torch.float32,
                        device=origins.device)
        return RayBundle(points=pts, ds=ds), tau
    interp_vg = field_evaluator(field_m, grid, interp)
    return _trace_impl(log_field_ne_vg(interp_vg), origins, directions,
                       frequency_hz, max_length_km, n_steps, keep_path,
                       method)


def trace_rays_ref(field_m: torch.Tensor, grid: Grid3D,
                   origins: torch.Tensor, directions: torch.Tensor,
                   frequency_hz,
                   max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                   n_steps: int = 128, keep_path: bool = True,
                   method: str = "rk4", interp: str = "cubic"):
    """Plain PyTorch version of ``trace_rays`` (and so of K1): the
    ``_trace_impl`` loop over the plain zp evaluator, on any device."""
    coef2d = _zp_table(field_m, grid, interp)
    return _trace_impl(
        log_field_ne_vg(lambda x: boxspline.interp_rows_with_grad_ref(
            coef2d, grid, x)),
        origins, directions, frequency_hz, max_length_km, n_steps,
        keep_path, method)


def _trace_impl(ne_vg, origins, directions, frequency_hz,
                max_length_km, n_steps, keep_path, method):
    """Integrator core over an arbitrary (n_e, ∇n_e) field evaluator
    (see _rhs; log-density evaluators wrap via log_field_ne_vg)."""
    origins = torch.as_tensor(origins, dtype=torch.float32)
    directions = torch.as_tensor(directions, dtype=torch.float32,
                                 device=origins.device)
    dev = origins.device
    h32 = np.float32(max_length_km / n_steps)
    h = torch.tensor(h32, device=dev)
    inv_f2 = torch.tensor(np.float32(1.0 / (frequency_hz * frequency_hz)),
                          device=dev)
    # initial momentum p0 = n(x0)·t̂0
    ne0_init, _ = ne_vg(origins)
    n0 = refractive_index(ne0_init, frequency_hz)
    p0 = n0[:, None] * directions

    tau = torch.zeros(origins.shape[0], dtype=torch.float32, device=dev)
    tec_unit = constants.KM_TO_M / constants.TEC_SCALE
    path = []

    if method == "rk4":
        x, p = origins, p0
        for _ in range(n_steps):
            k1x, k1p, ne1, _ = _rhs(ne_vg, x, p, inv_f2)
            k2x, k2p, ne2, _ = _rhs(ne_vg, x + 0.5 * h * k1x,
                                    p + 0.5 * h * k1p, inv_f2)
            k3x, k3p, ne3, _ = _rhs(ne_vg, x + 0.5 * h * k2x,
                                    p + 0.5 * h * k2p, inv_f2)
            k4x, k4p, ne4, _ = _rhs(ne_vg, x + h * k3x,
                                    p + h * k3p, inv_f2)
            sixth = h / 6.0
            x = x + sixth * (k1x + 2 * k2x + 2 * k3x + k4x)
            p = p + sixth * (k1p + 2 * k2p + 2 * k3p + k4p)
            tau = tau + sixth * (ne1 + 2 * ne2 + 2 * ne3 + ne4) * tec_unit
            if keep_path:
                path.append(x)

    elif method == "leapfrog":
        # velocity-Verlet: carry (x, p, ∇n(x), n_e(x), dn_e/ds(x), τ); one
        # field evaluation per step. TEC by the Hermite rule: ∫ f ds over a
        # step ≈ h/2·(f₀+f₁) + h²/12·(f₀′−f₁′).
        _, gn, ne, dne = _rhs(ne_vg, origins, p0, inv_f2)
        x, p = origins, p0
        for _ in range(n_steps):
            p_half = p + (0.5 * h) * gn
            x = x + h * (p_half / torch.linalg.norm(p_half, dim=-1,
                                                    keepdim=True))
            _, gn_new, ne_new, dne_new = _rhs(ne_vg, x, p_half, inv_f2)
            p = p_half + (0.5 * h) * gn_new
            tau = tau + ((0.5 * h) * (ne + ne_new)
                         + (h * h / 12.0) * (dne - dne_new)) * tec_unit
            gn, ne, dne = gn_new, ne_new, dne_new
            if keep_path:
                path.append(x)

    else:
        raise ValueError(f"unknown method: {method}")

    if keep_path:
        pts = torch.stack([origins] + path, dim=1)
    else:
        pts = torch.stack([origins, x], dim=1)
    ds = torch.full((origins.shape[0],), float(h32), dtype=torch.float32,
                    device=dev)
    return RayBundle(points=pts, ds=ds), tau
