"""TEC path integrals, the paired differential-TEC forward equation and
its linearisation (port of the parts of ``ionotomo_tpu.forward.tec`` the
bent-ray and inversion slices use).

Units: ray geometry in km, n_e in m^-3; TEC returned in working units of
``constants.TEC_SCALE`` m^-2 (1e13 = 1 mTECU).

The value gathers run through ``core.boxspline.interp_rows`` (kernel K2
on CUDA) and the Hermite endpoint derivatives through
``interp_rows_with_grad`` (kernel K1e on CUDA). The gather is monolithic:
the reference's chunking of large batches bounds a gathered pencil block
that the kernels never build, so it is not ported.

``PairedDtecLinear`` is the linearised paired-dTEC operator J about a
field m0 and its transpose, written out where the reference takes
``jax.linearize`` and ``jax.linear_transpose`` of ``dtec_paired_q``:
J δm = Q(n_e(m0) ⊙ R P δm) + the Hermite endpoint terms, Jᵀ y =
Pᵀ Rᵀ(n_e ⊙ Qᵀ y) + Pᵀ K1eᵀ(endpoint cotangents), with P the prefilter,
R ``rows_value`` (K2, and K3 through its autograd backward) and Q the
paired quadrature.

Not ported yet (ROADMAP.md Queue 1 item 7): ``dtec``, ``tec_linear``,
``tec_linear_adjoint``, ``vtec_map``, ``ray_coverage``,
``dtec_noise_from_beam``, and the cubic/zpc field models.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core import boxspline, tricubic
from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..geometry.fermat import _not_ported, _zp_table
from ..geometry.rays import RayBundle, simpson_weights, trapezoid_weights


def _ref_row(arr: torch.Tensor, i0: int) -> torch.Tensor:
    """arr[i0], the reference antenna's row (unsharded)."""
    return arr[i0]


def _coef2d(field_m: torch.Tensor, grid: Grid3D, interp: str
            ) -> torch.Tensor:
    """The (nx*ny, nz) row-gather table of the zp model: the prefiltered
    box-spline coefficient grid (one matmul + ``order`` 5-point stencil
    passes). Other field models raise NotImplementedError."""
    return _zp_table(field_m, grid, interp)


def _rows_of(interp: str):
    if interp.startswith("zpc"):
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    if interp.startswith("zp"):
        return boxspline
    if interp == "cubic":
        raise _not_ported(interp, "Queue 1 item 6, kernel K5")
    raise KeyError(interp)


def _interp_fast(field_m: torch.Tensor, grid: Grid3D, pts2d: torch.Tensor,
                 interp: str = "cubic") -> torch.Tensor:
    """Row-gather interpolation of the log-density at points (N, 3) under
    the selected field model, in one pass over all points."""
    mod = _rows_of(interp)
    table = _coef2d(field_m, grid, interp)
    return mod.interp_rows(table, grid, pts2d)


def ne_at(field_m: torch.Tensor, grid: Grid3D, points: torch.Tensor,
          interp: str = "cubic") -> torch.Tensor:
    """n_e [m^-3] at points (..., 3) from the log-density field m."""
    shape = points.shape[:-1]
    m = _interp_fast(field_m, grid, points.reshape(-1, 3), interp)
    return constants.K_NE * torch.exp(m).reshape(shape)


def log_ne_at(field_m: torch.Tensor, grid: Grid3D, points: torch.Tensor,
              interp: str = "cubic") -> torch.Tensor:
    """Log-density m = log(n_e/K_NE) at points (..., 3): the forward
    operator of point-density observations, exactly linear in m."""
    shape = points.shape[:-1]
    m = _interp_fast(field_m, grid, points.reshape(-1, 3), interp)
    return m.reshape(shape)


def tec_from_log_values(m_values: torch.Tensor, rays: RayBundle
                        ) -> torch.Tensor:
    """Simpson TEC quadrature from log-density samples m (R·N,) or (R, N)
    along the bundle."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * torch.exp(m_values).reshape(r, n)
    w = simpson_weights(n, ne.dtype, ne.device)
    integral = torch.einsum("rn,n->r", ne, w) * rays.ds * constants.KM_TO_M
    return integral / constants.TEC_SCALE


def _paired_simpson_ne(ne: torch.Tensor, w: torch.Tensor, rays: RayBundle,
                       i0: int) -> torch.Tensor:
    """Paired Simpson dTEC (Na, Nd) from densities ne (Na, Nd, N) [m⁻³]
    (or their tangents: the map is linear in ne) and the Simpson weights
    w (N,)."""
    check_full_f32()
    na, nd, _ = ne.shape
    dne = ne - _ref_row(ne, i0)[None, :, :]
    ds = rays.ds.reshape(na, nd)
    out = torch.einsum("akn,n->ak", dne, w) * ds * constants.KM_TO_M
    return out / constants.TEC_SCALE


def _paired_simpson_ne_t(y: torch.Tensor, w: torch.Tensor, rays: RayBundle,
                         i0: int) -> torch.Tensor:
    """Transpose of ``_paired_simpson_ne``: (Na, Nd) → (Na, Nd, N)."""
    na, nd = y.shape
    ds = rays.ds.reshape(na, nd)
    s = (y / constants.TEC_SCALE) * constants.KM_TO_M * ds
    ct = s[:, :, None] * w[None, None, :]
    return _ref_row_t(ct, i0)


def _ref_row_t(ct: torch.Tensor, i0: int) -> torch.Tensor:
    """Transpose of x ↦ x − x[i0] over the leading (antenna) axis."""
    out = ct.clone()
    out[i0] -= ct.sum(0)
    return out


def dtec_paired_from_log_values(m_values: torch.Tensor, rays: RayBundle,
                                num_directions: int, i0: int = 0
                                ) -> torch.Tensor:
    """Cancellation-free paired-dTEC Simpson quadrature from log-density
    samples: the reference antenna's samples are subtracted sample-wise
    before the reduction."""
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * torch.exp(m_values).reshape(na, num_directions, n)
    return _paired_simpson_ne(ne, simpson_weights(n, ne.dtype, ne.device),
                              rays, i0)


def tec(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
        interp: str = "cubic") -> torch.Tensor:
    """TEC per ray, (R,), in TEC_SCALE working units (Simpson)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return tec_from_log_values(m, rays)


def dtec_paired(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                num_directions: int, i0: int = 0,
                interp: str = "cubic") -> torch.Tensor:
    """Cancellation-free differential TEC (Simpson), (Na, Nd).

    All rays of the engine share one arc-length grid s_n = n·ds per
    direction, so dTEC[i,k] = Σ_n w_n · (n_e(x_{i,k,n}) − n_e(x_{i0,k,n}))
    · ds, valid for bent paths too. ``rays`` is the row-major (antenna ×
    direction) flat batch of ``make_ray_batch``.
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return dtec_paired_from_log_values(m, rays, num_directions, i0)


def _endpoint_tangents(points: torch.Tensor):
    """(ends (2R,3), unit tangents (2R,3)) at each ray's first and last
    sample, from the first/last path segments."""
    seg0 = points[:, 1] - points[:, 0]
    seg1 = points[:, -1] - points[:, -2]
    t_hat = torch.cat([seg0, seg1], dim=0)
    t_hat = t_hat / torch.linalg.norm(t_hat, dim=-1, keepdim=True)
    ends = torch.cat([points[:, 0], points[:, -1]], dim=0)
    return ends, t_hat


def endpoint_dne_ds_from(m_ends: torch.Tensor, gm_ends: torch.Tensor,
                         t_hat: torch.Tensor):
    """dn_e/ds = K_NE·e^m · (∇m·t̂) [m⁻³/km] at the 2R endpoint samples.
    Returns (d_first (R,), d_last (R,))."""
    check_full_f32()
    r = m_ends.shape[0] // 2
    ne = constants.K_NE * torch.exp(m_ends)
    dnds = ne * torch.einsum("pd,pd->p", gm_ends, t_hat)
    return dnds[:r], dnds[r:]


def tec_hermite_from_values(m_values: torch.Tensor, d0: torch.Tensor,
                            d1: torch.Tensor, rays: RayBundle
                            ) -> torch.Tensor:
    """Hermite TEC quadrature from log-density samples m (R·N,) and the
    n_e path derivatives at the first/last samples (R,) each [m⁻³/km]."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * torch.exp(m_values).reshape(r, n)
    w = trapezoid_weights(n, ne.dtype, ne.device)
    integral = (torch.einsum("rn,n->r", ne, w) * rays.ds
                + (d0 - d1) * (rays.ds * rays.ds) / 12.0)
    return integral * (constants.KM_TO_M / constants.TEC_SCALE)


def _paired_hermite_ne(ne: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                       w: torch.Tensor, rays: RayBundle, i0: int
                       ) -> torch.Tensor:
    """Paired Hermite dTEC (Na, Nd) from densities ne (Na, Nd, N), the
    endpoint path derivatives d0, d1 (R,) (or their tangents: linear) and
    the trapezoid weights w (N,)."""
    check_full_f32()
    na, nd, _ = ne.shape
    dne = ne - _ref_row(ne, i0)[None, :, :]
    corr = (d0 - d1).reshape(na, nd)
    corr = corr - _ref_row(corr, i0)[None, :]
    ds = rays.ds.reshape(na, nd)
    out = (torch.einsum("akn,n->ak", dne, w) * ds + corr * ds * ds / 12.0)
    return out * (constants.KM_TO_M / constants.TEC_SCALE)


def _paired_hermite_ne_t(y: torch.Tensor, w: torch.Tensor, rays: RayBundle,
                         i0: int):
    """Transpose of ``_paired_hermite_ne``: (Na, Nd) → (ct_ne (Na, Nd, N),
    ct_d0 (R,)); the cotangent of d1 is −ct_d0."""
    na, nd = y.shape
    ds = rays.ds.reshape(na, nd)
    s = y * (constants.KM_TO_M / constants.TEC_SCALE)
    ct_ne = _ref_row_t((s * ds)[:, :, None] * w[None, None, :], i0)
    ct_corr = _ref_row_t(s * ds * ds / 12.0, i0)
    return ct_ne, ct_corr.reshape(-1)


def dtec_paired_hermite_from_values(m_values: torch.Tensor,
                                    d0: torch.Tensor, d1: torch.Tensor,
                                    rays: RayBundle, num_directions: int,
                                    i0: int = 0) -> torch.Tensor:
    """Paired-dTEC twin of ``tec_hermite_from_values`` (sample-wise
    reference-antenna subtraction of values AND endpoint derivatives)."""
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * torch.exp(m_values).reshape(na, num_directions, n)
    return _paired_hermite_ne(ne, d0, d1,
                              trapezoid_weights(n, ne.dtype, ne.device),
                              rays, i0)


def _endpoint_dne_ds(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                     interp: str = "cubic"):
    """Path derivative of n_e at each ray's first and last sample,
    dn_e/ds = n_e · (∇m · t̂), with tangents from the first/last path
    segments. Returns (d_first (R,), d_last (R,)) in m⁻³/km."""
    ends, t_hat = _endpoint_tangents(rays.points)             # (2R, 3)
    m, gm = _rows_of(interp).interp_rows_with_grad(
        _coef2d(field_m, grid, interp), grid, ends)
    return endpoint_dne_ds_from(m, gm, t_hat)


def tec_hermite(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                interp: str = "cubic") -> torch.Tensor:
    """Gradient-augmented (composite cubic-Hermite) TEC per ray, (R,):
    trapezoid values + ds²/12·(f'_first − f'_last)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return tec_hermite_from_values(m, d0, d1, rays)


def dtec_paired_hermite(field_m: torch.Tensor, grid: Grid3D,
                        rays: RayBundle, num_directions: int, i0: int = 0,
                        interp: str = "cubic") -> torch.Tensor:
    """Cancellation-free paired dTEC under the Hermite rule, (Na, Nd)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return dtec_paired_hermite_from_values(m, d0, d1, rays,
                                           num_directions, i0)


def dtec_paired_q(field_m, grid, rays, num_directions, i0=0,
                  quadrature: str = "simpson", interp: str = "cubic"):
    """Paired dTEC under the named quadrature ("simpson" or "hermite")."""
    if quadrature == "hermite":
        return dtec_paired_hermite(field_m, grid, rays, num_directions, i0,
                                   interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return dtec_paired(field_m, grid, rays, num_directions, i0, interp)


def tec_q(field_m, grid, rays, quadrature: str = "simpson",
          interp: str = "cubic"):
    """TEC per ray under the named quadrature ("simpson" or "hermite")."""
    if quadrature == "hermite":
        return tec_hermite(field_m, grid, rays, interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return tec(field_m, grid, rays, interp)


class PairedDtecLinear:
    """The paired-dTEC forward ``dtec_paired_q`` linearised about a field
    m0 on the zp model, with its exact transpose, over fixed ray samples.

    ``apply(δm)`` (grid.shape) → (Na·Nd,) and ``apply_t(y)`` (Na·Nd,) →
    grid.shape; ``g0`` (Na·Nd,) is the forward at m0. With t = P δm the
    tangent coefficient table:

        J δm = Q(n_e ⊙ R t, δd₀, δd₁),
        δd = n_e·δm_e·(∇m0·t̂) + n_e·(∇δm_e·t̂)     (Hermite endpoints)
        Jᵀ y = Pᵀ[Rᵀ(n_e ⊙ Q_neᵀ y) + K1eᵀ(c·n_e·(∇m0·t̂), c·n_e·t̂)],
        c = Q_dᵀ y,

    n_e at m0 on the samples and endpoints, δm_e and ∇δm_e the tangent's
    value and gradient there (K1e on t). Everything that depends only on
    m0 and the samples (point setup, weights, n_e, the K3 and K1eᵀ plans)
    is built once here; an application is a prefilter, one gather or
    scatter and the quadrature.

    On CUDA tensors R is ``rows_value`` (K2) and Rᵀ its autograd
    backward (K3), the endpoint terms K1e and K1eᵀ.
    ``dtec_paired_linear_ref`` builds the same operator from the plain
    versions (``*_ref``) of those four, on any device.
    """

    def __init__(self, field_m0: torch.Tensor, grid: Grid3D,
                 rays: RayBundle, num_directions: int, i0: int = 0,
                 quadrature: str = "hermite", interp: str = "cubic"):
        check_full_f32()
        if quadrature not in ("hermite", "simpson"):
            raise ValueError(f"unknown quadrature: {quadrature!r}")
        _rows_of(interp)                      # raises for unported models
        self.grid, self.rays, self.i0 = grid, rays, i0
        self.order = boxspline.zp_order(interp)
        self.hermite = quadrature == "hermite"
        r, self.n = rays.points.shape[:2]
        self.na, self.nd = r // num_directions, num_directions
        nx, ny, nz = grid.shape
        self.table_shape = (nx * ny, nz)
        weights = trapezoid_weights if self.hermite else simpson_weights
        self.w = weights(self.n, torch.float32, rays.points.device)

        pts = rays.points.reshape(-1, 3)
        bx, by, bz, u, v, w = boxspline._neighborhood(grid, pts)
        dx, dy, wxy = boxspline._xy_weights(u, v, with_grad=False)
        self.ri = boxspline._row_index(bx, by, dx, dy, grid).contiguous()
        self.zi = (bz[:, None] + torch.arange(
            -1, 2, dtype=torch.int32, device=bz.device)[None, :]).contiguous()
        self.wxy = wxy.contiguous()
        self.wz = boxspline._qb_weights(w).contiguous()
        if self.hermite:
            self.ends, self.t_hat = _endpoint_tangents(rays.points)
        table0 = boxspline.prefilter(field_m0, self.order).reshape(
            self.table_shape)
        m_values = self._setup(table0)
        self.ne = constants.K_NE * torch.exp(m_values)
        ne3 = self.ne.reshape(self.na, self.nd, self.n)
        if not self.hermite:
            self.g0 = _paired_simpson_ne(ne3, self.w, rays, i0).reshape(-1)
            return
        m_e, gm_e = self._value_grad(table0)
        self.ne_e = constants.K_NE * torch.exp(m_e)
        self.slope = torch.einsum("pd,pd->p", gm_e, self.t_hat)
        d0, d1 = endpoint_dne_ds_from(m_e, gm_e, self.t_hat)
        self.g0 = _paired_hermite_ne(ne3, d0, d1, self.w, rays,
                                     i0).reshape(-1)

    def _setup(self, table0: torch.Tensor) -> torch.Tensor:
        """Build what every application reuses, and return R table0: on
        CUDA the K3 and K1eᵀ plans; R's transpose is rows_value's autograd
        backward (K3), taken through one retained graph of R over a zero
        table."""
        cuda = self.ri.is_cuda
        plan = (tricubic.build_row_plan(self.ri, self.table_shape[0],
                                        self.zi[:, 0],
                                        boxspline.ZP_LIVE_TRANSLATES)
                if cuda else None)
        self.row_plan = plan
        self.end_plan = (boxspline.endpoint_plan(self.grid, self.ends)
                         if cuda and self.hermite else None)
        self._leaf = torch.zeros(self.table_shape, device=self.ri.device,
                                 requires_grad=True)
        with torch.enable_grad():
            self._graph = tricubic.rows_value(self._leaf, self.ri, self.wxy,
                                              self.zi, self.wz, True, plan)
        return tricubic.rows_value(table0, self.ri, self.wxy, self.zi,
                                   self.wz, True, plan)

    def _rows(self, table: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value(table, self.ri, self.wxy, self.zi,
                                   self.wz, True)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        (table_ct,) = torch.autograd.grad(self._graph, self._leaf, ct,
                                          retain_graph=True)
        return table_ct

    def _value_grad(self, table: torch.Tensor):
        return boxspline.interp_rows_with_grad(table, self.grid, self.ends)

    def _value_grad_t(self, ct_value, ct_grad) -> torch.Tensor:
        return boxspline.interp_rows_with_grad_transpose(
            self.grid, self.ends, ct_value, ct_grad, self.end_plan)

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        """J δm: field tangent (grid.shape) → dTEC tangent (Na·Nd,)."""
        check_full_f32()
        t = boxspline.prefilter(dm, self.order).reshape(self.table_shape)
        dne = (self.ne * self._rows(t)).reshape(self.na, self.nd, self.n)
        if not self.hermite:
            return _paired_simpson_ne(dne, self.w, self.rays,
                                      self.i0).reshape(-1)
        dm_e, dgm_e = self._value_grad(t)
        dd = ((self.ne_e * dm_e) * self.slope
              + self.ne_e * torch.einsum("pd,pd->p", dgm_e, self.t_hat))
        r = dd.shape[0] // 2
        return _paired_hermite_ne(dne, dd[:r], dd[r:], self.w, self.rays,
                                  self.i0).reshape(-1)

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """Jᵀ y: dTEC cotangent (Na·Nd,) → field cotangent (grid.shape)."""
        y = y.reshape(self.na, self.nd)
        if not self.hermite:
            ct_ne = _paired_simpson_ne_t(y, self.w, self.rays, self.i0)
        else:
            ct_ne, ct_d0 = _paired_hermite_ne_t(y, self.w, self.rays,
                                                self.i0)
        table_ct = self._rows_t(self.ne * ct_ne.reshape(-1))
        if self.hermite:
            ct_d = torch.cat([ct_d0, -ct_d0]) * self.ne_e
            table_ct = table_ct + self._value_grad_t(
                ct_d * self.slope, ct_d[:, None] * self.t_hat)
        return boxspline.prefilter_transpose(
            table_ct.reshape(self.grid.shape), self.order)


def dtec_paired_linear(field_m0, grid, rays, num_directions, i0=0,
                       quadrature: str = "hermite", interp: str = "cubic"
                       ) -> PairedDtecLinear:
    """``dtec_paired_q`` linearised about ``field_m0`` (kernels K2, K3,
    K1e and K1eᵀ on CUDA)."""
    return PairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                            quadrature, interp)


class _PlainPairedDtecLinear(PairedDtecLinear):
    """``PairedDtecLinear`` with R, Rᵀ, K1e and K1eᵀ replaced by their
    plain versions."""

    def _setup(self, table0: torch.Tensor) -> torch.Tensor:
        return self._rows(table0)

    def _rows(self, table: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value_ref(table, self.ri, self.wxy, self.zi,
                                       self.wz, True)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value_transpose_ref(
            ct, self.ri, self.wxy, self.zi, self.wz, self.table_shape)

    def _value_grad(self, table: torch.Tensor):
        return boxspline.interp_rows_with_grad_ref(table, self.grid,
                                                   self.ends)

    def _value_grad_t(self, ct_value, ct_grad) -> torch.Tensor:
        return boxspline.interp_rows_with_grad_transpose_ref(
            self.grid, self.ends, ct_value, ct_grad)


def dtec_paired_linear_ref(field_m0, grid, rays, num_directions, i0=0,
                           quadrature: str = "hermite", interp: str = "cubic"
                           ) -> PairedDtecLinear:
    """Plain PyTorch version of ``dtec_paired_linear``: the same operator
    built from the ``*_ref`` primitives, on any device."""
    return _PlainPairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                                  quadrature, interp)
