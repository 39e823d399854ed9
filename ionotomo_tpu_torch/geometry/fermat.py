"""Bent-ray Fermat tracer (port of ``ionotomo_tpu.geometry.fermat``).

Rays in an isotropic refractive medium obey d/ds (n t̂) = ∇n, dx/ds = t̂.
With p := n·t̂ this is the first-order system dx/ds = p/|p|,
dp/ds = ∇n(x), n = sqrt(1 − KAPPA·n_e/f²) the cold-plasma
Appleton–Hartree index, n_e = K_NE·exp(m(x)) from the interpolated
log-density field. The TEC path integral rides along as extra state.

``trace_rays`` runs one kernel on CUDA tensors, all steps of a ray in one
thread, one launch, the field model's own (``_tracer_kernel``): with
``method="leapfrog"`` K1 over zp, K1c over the tricubic model
(``interp="cubic"``, the default), K1z over zpc and K1q over the
triquadratic model; with ``method="rk4"`` K1r over the same four. Every
CPU tensor runs ``_trace_impl``, the port of the reference's integrator
loop (a Python loop in place of ``lax.scan``).
``trace_rays_ref`` is the plain PyTorch version of the whole tracer.
``trace_rays_callable`` runs the same loop over a closed-form field.

``trace_rays_split`` traces a closed-form Chapman background plus the
tricubic model of a gridded perturbation (kernel K1s on CUDA,
``trace_rays_split_ref`` its plain version). ``trace_rays_stochastic``
traces a beam of jittered rays around each ray in one tracer call, and
``beam_noise_for_epoch`` maps its TEC spread to dTEC noise; their
randomness is fed in (standard normals, or a ``torch.Generator``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants, kernels
from ..core import boxspline, triquadratic, tricubic, zpcubic
from ..core.field_models import field_model
from ..core.grids import Grid3D
from ..device import as_tensor
from ..models.chapman import ChapmanBackground
from .rays import RayBundle, make_ray_batch


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


def field_evaluator(field_m: torch.Tensor, grid: Grid3D,
                    interp: str = "cubic"):
    """Build the log-density ``(m, ∇m)`` evaluator for a C¹ field model,
    paying any prefilter once: ``cubic`` (Catmull-Rom tricubic, 16 row
    gathers, kernel K5 on CUDA), ``zp``/``zp<order>`` (Zwart-Powell box
    spline ⊗ quadratic-z, 8 row gathers, kernel K1e), ``zpc``/
    ``zpc<order>`` (Zwart-Powell ⊗ Catmull-Rom z, 8 row gathers, kernel
    K6z) or ``quadratic`` (triquadratic B-spline, 9 row gathers, kernel
    K6q)."""
    model = field_model(interp)
    table = model.table(field_m, grid)
    return lambda x: model.rows.interp_rows_with_grad(table, grid, x)


#: Each field model's name in its tracer kernels'
#: (``kernels.trace_<method>_<name>``).
_TRACER_MODEL = {boxspline: "zp", tricubic: "cubic", zpcubic: "zpc",
                 triquadratic: "quad"}


def _tracer_kernel(model, method):
    """The model's own tracer kernel for ``method``, one table keyed by
    (model, method): leapfrog K1 on zp, K1c on cubic, K1z on zpc, K1q on
    quadratic; rk4 K1r on the same four (each reads its model's table)."""
    return getattr(kernels, f"trace_{method}_{_TRACER_MODEL[model.rows]}")


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
    configuration). On CUDA, either is one kernel, the field model's
    (``_tracer_kernel``).
    """
    origins = as_tensor(origins, device=grid.device)
    directions = as_tensor(directions, device=grid.device)
    if origins.is_cuda and method in ("leapfrog", "rk4"):
        model = field_model(interp)
        kernel = _tracer_kernel(model, method)
        table = model.table(field_m, grid).contiguous()
        c = _step_constants(frequency_hz, max_length_km, n_steps)
        x_end, tau, path = kernel(table, grid, origins.contiguous(),
                                  directions.contiguous(), n_steps,
                                  keep_path, **c)
        return _kernel_bundle(origins, x_end, path, c["h"]), tau
    interp_vg = field_evaluator(field_m, grid, interp)
    return _trace_impl(log_field_ne_vg(interp_vg), origins, directions,
                       frequency_hz, max_length_km, n_steps, keep_path,
                       method)


def _kernel_bundle(origins, x_end, path, h):
    """A tracer kernel's outputs as ``_trace_impl`` returns its bundle: the
    path, or the origins and endpoints without one."""
    pts = path if path is not None else torch.stack([origins, x_end], dim=1)
    ds = torch.full((origins.shape[0],), h, dtype=torch.float32,
                    device=origins.device)
    return RayBundle(points=pts, ds=ds)


def trace_rays_ref(field_m: torch.Tensor, grid: Grid3D,
                   origins: torch.Tensor, directions: torch.Tensor,
                   frequency_hz,
                   max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                   n_steps: int = 128, keep_path: bool = True,
                   method: str = "rk4", interp: str = "cubic"):
    """Plain PyTorch version of ``trace_rays`` (and so of K1, K1c, K1z,
    K1q and K1r):
    the ``_trace_impl`` loop over the field model's plain evaluator, on
    any device."""
    model = field_model(interp)
    table = model.table(field_m, grid)
    return _trace_impl(
        log_field_ne_vg(lambda x: model.rows.interp_rows_with_grad_ref(
            table, grid, x)),
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


def split_perturbation(field_m: torch.Tensor, grid: Grid3D, background):
    """The split tracer's perturbation table (nx*ny, nz) [m⁻³]: δ = K_NE·
    e^m − n_e,bg at the grid points, the points from the f32 axes as
    ``grid.axes()`` gives them, the background's value only (a
    ``ChapmanBackground``'s ``value``: no gradient is taken)."""
    nx, ny, nz = grid.shape
    pts = torch.stack(torch.meshgrid(*grid.axes(), indexing="ij"),
                      dim=-1).reshape(-1, 3)
    ne_bg = (background.value(pts) if isinstance(background, ChapmanBackground)
             else background(pts)[0])
    pert = constants.K_NE * torch.exp(field_m) - ne_bg.reshape(grid.shape)
    return pert.reshape(nx * ny, nz)


def _split_ne_vg(pert2d, grid, background, interp_vg):
    """The split field's evaluator: background + the perturbation's
    tricubic value and gradient (``interp_vg``), as (nb + d, gb + gd)."""

    def ne_vg(x):
        d, gd = interp_vg(pert2d, grid, x)
        nb, gb = background(x)
        return nb + d, gb + gd

    return ne_vg


def trace_rays_split(field_m: torch.Tensor, grid: Grid3D, origins,
                     directions, frequency_hz, background,
                     max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                     n_steps: int = 32, keep_path: bool = True,
                     method: str = "leapfrog"):
    """Split-field bent trace: n_e = the closed-form ``background``
    (``models.chapman.background_ne_fn``) + the tricubic model of the
    perturbation grid δ = K_NE·e^m − n_e,bg(grid points), formed once per
    call (``split_perturbation``). Returns (RayBundle, tec) as
    ``trace_rays``. On CUDA, leapfrog or rk4 is one launch of K1s, which
    evaluates the background in closed form from its parameters (a
    background other than a ``ChapmanBackground`` raises there); on the
    CPU the plain ``_trace_impl`` loop."""
    origins = as_tensor(origins, device=grid.device)
    directions = as_tensor(directions, device=grid.device)
    pert2d = split_perturbation(field_m, grid, background)
    if origins.is_cuda and method in ("leapfrog", "rk4"):
        if not isinstance(background, ChapmanBackground):
            raise TypeError(f"trace_rays_split on CUDA evaluates the "
                            f"background in its kernel and takes a "
                            f"ChapmanBackground (background_ne_fn), got "
                            f"{type(background).__name__}")
        c = _step_constants(frequency_hz, max_length_km, n_steps)
        x_end, tau, path = kernels.trace_split(
            pert2d.contiguous(), grid, origins.contiguous(),
            directions.contiguous(), n_steps, keep_path,
            rk4=method == "rk4",
            background=background.kernel_params(origins.device), **c)
        return _kernel_bundle(origins, x_end, path, c["h"]), tau
    return _trace_impl(_split_ne_vg(pert2d, grid, background,
                                    tricubic.interp_rows_with_grad),
                       origins, directions, frequency_hz, max_length_km,
                       n_steps, keep_path, method)


def trace_rays_split_ref(field_m: torch.Tensor, grid: Grid3D, origins,
                         directions, frequency_hz, background,
                         max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                         n_steps: int = 32, keep_path: bool = True,
                         method: str = "leapfrog"):
    """Plain PyTorch version of ``trace_rays_split`` (and so of K1s): the
    ``_trace_impl`` loop over ``tricubic.interp_rows_with_grad_ref`` of δ
    plus the background's ``__call__``, on any device."""
    pert2d = split_perturbation(field_m, grid, background)
    return _trace_impl(_split_ne_vg(pert2d, grid, background,
                                    tricubic.interp_rows_with_grad_ref),
                       origins, directions, frequency_hz, max_length_km,
                       n_steps, keep_path, method)


def trace_rays_callable(ne_and_grad, origins, directions, frequency_hz,
                        max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                        n_steps: int = 128, keep_path: bool = True,
                        method: str = "rk4"):
    """Bent trace over a closed-form field evaluator ``ne_and_grad(x (R,
    3)) → (n_e (R,), ∇n_e (R, 3) [m⁻³/km])``: no grid, no interpolant.
    For analytic worlds such as ``models.turbulence.analytic_ne_fn``, so
    that no solver's interpolation model defines the truth. Origins and
    directions are tensors (they keep their device) or go to the card."""
    origins = as_tensor(origins)
    directions = as_tensor(directions, device=origins.device)
    return _trace_impl(ne_and_grad, origins, directions, frequency_hz,
                       max_length_km, n_steps, keep_path, method)


def straight_line_limit_error(field_m, grid, origins, directions,
                              frequency_hz, max_length_km, n_steps=128):
    """Max endpoint deviation [km] from the straight path: a diagnostic,
    and the n→1 invariant (a bent ray becomes straight at zero density or
    high frequency)."""
    bundle, _ = trace_rays(field_m, grid, origins, directions, frequency_hz,
                           max_length_km, n_steps)
    origins = as_tensor(origins, device=grid.device)
    directions = as_tensor(directions, device=grid.device)
    straight_end = origins + max_length_km * directions
    return torch.linalg.norm(bundle.points[:, -1] - straight_end, dim=-1)


def _standard_normals(noise, shape, device) -> torch.Tensor:
    """``noise`` as standard normals of ``shape`` on ``device``: a tensor or
    array of that shape as it is, or a ``torch.Generator``'s draw (on the
    generator's device). Never global random state."""
    if isinstance(noise, torch.Generator):
        eps = torch.randn(shape, generator=noise, dtype=torch.float32,
                          device=noise.device)
        return eps.to(device)
    eps = as_tensor(noise, device=device).to(device)
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"noise must have shape {tuple(shape)}, got "
                         f"{tuple(eps.shape)}")
    return eps


def beam_directions(directions, noise, n_paths: int, jitter_rad: float):
    """The launch directions of a beam around each ray, (n_paths, R, 3):
    path 0 the ray itself, paths 1.. its direction jittered by
    ``jitter_rad``·ε along a transverse orthonormal basis (e1 = d × ĥ
    normalised, ĥ = ẑ unless |d_z| ≥ 0.9, then x̂; e2 = d × e1), each
    normalised. ``noise``: ε, standard normals of shape (n_paths − 1, R,
    2), or a ``torch.Generator`` to draw them from."""
    r = directions.shape[0]
    dev = directions.device
    helper = torch.where(directions[:, 2:3].abs() < 0.9,
                         torch.tensor([0.0, 0.0, 1.0], device=dev),
                         torch.tensor([1.0, 0.0, 0.0], device=dev))
    e1 = torch.linalg.cross(directions, helper.expand_as(directions))
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(directions, e1)
    eps = (_standard_normals(noise, (n_paths - 1, r, 2), dev)
           * np.float32(jitter_rad))
    d_pert = (directions[None] + eps[..., 0:1] * e1[None]
              + eps[..., 1:2] * e2[None])
    d_all = torch.cat([directions[None], d_pert], dim=0)
    return d_all / torch.linalg.norm(d_all, dim=-1, keepdim=True)


def trace_rays_stochastic(field_m: torch.Tensor, grid: Grid3D, origins,
                          directions, frequency_hz, noise, n_paths: int = 8,
                          jitter_rad: float = None,
                          max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                          n_steps: int = 64, method: str = "leapfrog",
                          interp: str = "cubic"):
    """Beam-ensemble (stochastic) trace for the strong-turbulence regime:
    ``n_paths`` rays per (origin, direction), the launch directions of
    ``beam_directions`` (``noise``: standard normals (n_paths − 1, R, 2),
    or a ``torch.Generator``; ``jitter_rad`` defaults to the Fresnel angle
    sqrt(λ/L)). Returns (tec_mean, tec_std, endpoint_rms), each (R,): the
    beam-averaged TEC, its population std over the paths (the chaotic
    forward-model error bar) and the rms 3-D distance of the path
    endpoints from their mean. All n_paths × R rays go through one
    ``trace_rays`` call, paths outermost; every ray's outputs are those of
    its own trace."""
    origins = as_tensor(origins, device=grid.device)
    directions = as_tensor(directions, device=grid.device)
    if jitter_rad is None:
        lam_km = 299792.458 / float(frequency_hz)      # c [km/s] / f
        jitter_rad = float(lam_km / max_length_km) ** 0.5
    d_all = beam_directions(directions, noise, n_paths, jitter_rad)
    r = origins.shape[0]
    bundle, tec = trace_rays(field_m, grid, origins.repeat(n_paths, 1),
                             d_all.reshape(-1, 3), frequency_hz,
                             max_length_km, n_steps=n_steps, keep_path=False,
                             method=method, interp=interp)
    tec_p = tec.reshape(n_paths, r)
    ends = bundle.points[:, -1].reshape(n_paths, r, 3)
    end_mu = ends.mean(0)
    endpoint_rms = torch.sqrt(((ends - end_mu[None]) ** 2).sum(-1).mean(0))
    return tec_p.mean(0), tec_p.std(0, correction=0), endpoint_rms


def beam_noise_for_epoch(field_m: torch.Tensor, grid: Grid3D, antennas_enu,
                         directions_enu, frequency_hz, noise,
                         n_paths: int = 8, num_directions: int = None,
                         i0: int = 0, jitter_rad: float = None,
                         max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                         n_steps: int = 64, method: str = "leapfrog",
                         interp: str = "cubic") -> torch.Tensor:
    """Per-(antenna, direction) dTEC observation-noise inflation from the
    chaotic beam spread: one ``trace_rays_stochastic`` beam per (antenna ×
    direction) ray of ``make_ray_batch``, its TEC spreads mapped to dTEC
    noise rows by ``forward.tec.dtec_noise_from_beam``. Returns (Na, Nd) in
    TEC working units; add it in quadrature to the instrument noise.
    ``noise`` as for ``trace_rays_stochastic`` (the same noise, the same
    inflation)."""
    from ..forward.tec import dtec_noise_from_beam

    dirs = as_tensor(directions_enu, device=grid.device)
    origins, dvecs = make_ray_batch(
        as_tensor(antennas_enu, device=grid.device), dirs)
    _, tec_std, _ = trace_rays_stochastic(
        field_m, grid, origins, dvecs, frequency_hz, noise,
        n_paths=n_paths, jitter_rad=jitter_rad,
        max_length_km=max_length_km, n_steps=n_steps, method=method,
        interp=interp)
    nd = dirs.shape[0] if num_directions is None else int(num_directions)
    return dtec_noise_from_beam(tec_std, nd, i0)
