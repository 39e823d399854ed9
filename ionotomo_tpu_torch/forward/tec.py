"""TEC path integrals, the paired differential-TEC forward equation, its
linearisation and the linear ray–voxel projection with its transpose
(port of ``ionotomo_tpu.forward.tec``).

Units: ray geometry in km, n_e in m^-3; TEC returned in working units of
``constants.TEC_SCALE`` m^-2 (1e13 = 1 mTECU).

Every function takes ``interp``, the field model (``core.field_models``:
"cubic", the default, or "zp"/"zp<order>"). The value gathers run
through the model's ``interp_rows`` (kernel K2 on CUDA) and the Hermite
endpoint derivatives through its ``interp_rows_with_grad`` (kernel K5 on
cubic, K1e on zp). The gather is monolithic: the reference's chunking of
large batches bounds a gathered pencil block that the kernels never
build, so it is not ported.

``PairedDtecLinear`` is the linearised paired-dTEC operator J about a
field m0 and its transpose, written out where the reference takes
``jax.linearize`` and ``jax.linear_transpose`` of ``dtec_paired_q``:
J δm = Q(n_e(m0) ⊙ R P δm) + the Hermite endpoint terms, Jᵀ y =
Pᵀ Rᵀ(n_e ⊙ Qᵀ y) + Pᵀ Eᵀ(endpoint cotangents), with P the model's
table map (the prefilter on zp, the identity on cubic), R ``rows_value``
(K2, and K3 through its autograd backward), E the model's value +
gradient (K5ᵀ or K1eᵀ as its transpose) and Q the paired quadrature.

``tec_linear_adjoint`` (and so ``ray_coverage``) is Pᵀ of
``rows_value_transpose``: kernel K3 over the model's row plan, where the
reference scatters 64 stencil weights per sample on cubic.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core import tricubic
from ..core.field_models import field_model
from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..geometry.rays import RayBundle, simpson_weights, trapezoid_weights


def _ref_row(arr: torch.Tensor, i0: int) -> torch.Tensor:
    """arr[i0], the reference antenna's row (unsharded)."""
    return arr[i0]


def _coef2d(field_m: torch.Tensor, grid: Grid3D, interp: str
            ) -> torch.Tensor:
    """The (nx*ny, nz) row-gather table of the chosen field model: a free
    view of the field for "cubic", the prefiltered box-spline coefficient
    grid for "zp"."""
    return field_model(interp).table(field_m, grid)


def _rows_of(interp: str):
    """The module of the field model's row-gather evaluators."""
    return field_model(interp).rows


def _interp_fast(field_m: torch.Tensor, grid: Grid3D, pts2d: torch.Tensor,
                 interp: str = "cubic") -> torch.Tensor:
    """Row-gather interpolation of the field at points (N, 3) under the
    selected field model, in one pass over all points."""
    model = field_model(interp)
    return model.rows.interp_rows(model.table(field_m, grid), grid, pts2d)


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


def dtec(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
         num_directions: int, i0: int = 0,
         interp: str = "cubic") -> torch.Tensor:
    """Differential TEC w.r.t. reference antenna ``i0``, (Na, Nd), as the
    difference of two TEC integrals (for bundles with per-antenna ds;
    ``dtec_paired`` is the cancellation-free form). ``rays`` is the
    row-major (antenna × direction) flat batch: ray r = i*Nd + k."""
    t = tec(field_m, grid, rays, interp).reshape(-1, num_directions)
    return t - _ref_row(t, i0)[None, :]


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
    m0 under the field model ``interp``, with its exact transpose, over
    fixed ray samples.

    ``apply(δm)`` (grid.shape) → (Na·Nd,) and ``apply_t(y)`` (Na·Nd,) →
    grid.shape; ``g0`` (Na·Nd,) is the forward at m0. With t = P δm the
    tangent table:

        J δm = Q(n_e ⊙ R t, δd₀, δd₁),
        δd = n_e·δm_e·(∇m0·t̂) + n_e·(∇δm_e·t̂)     (Hermite endpoints)
        Jᵀ y = Pᵀ[Rᵀ(n_e ⊙ Q_neᵀ y) + Eᵀ(c·n_e·(∇m0·t̂), c·n_e·t̂)],
        c = Q_dᵀ y,

    n_e at m0 on the samples and endpoints, δm_e and ∇δm_e the tangent's
    value and gradient there (E on t). Everything that depends only on
    m0 and the samples (point setup, weights, n_e, the two scatter plans)
    is built once here; an application is P, one gather or scatter and
    the quadrature. P, the point setup, E and the plans are the field
    model's (``core.field_models``).

    On CUDA tensors R is ``rows_value`` (K2) and Rᵀ its autograd
    backward (K3); E and Eᵀ are K5 and K5ᵀ on cubic, K1e and K1eᵀ on zp.
    ``dtec_paired_linear_ref`` builds the same operator from the plain
    versions (``*_ref``) of those four, on any device.
    """

    def __init__(self, field_m0: torch.Tensor, grid: Grid3D,
                 rays: RayBundle, num_directions: int, i0: int = 0,
                 quadrature: str = "hermite", interp: str = "cubic"):
        check_full_f32()
        if quadrature not in ("hermite", "simpson"):
            raise ValueError(f"unknown quadrature: {quadrature!r}")
        self.model = field_model(interp)      # raises for unported models
        self.grid, self.rays, self.i0 = grid, rays, i0
        self.hermite = quadrature == "hermite"
        r, self.n = rays.points.shape[:2]
        self.na, self.nd = r // num_directions, num_directions
        nx, ny, nz = grid.shape
        self.table_shape = (nx * ny, nz)
        weights = trapezoid_weights if self.hermite else simpson_weights
        self.w = weights(self.n, torch.float32, rays.points.device)

        self.ri, self.wxy, self.zi, self.wz = self.model.rows.row_setup(
            grid, rays.points.reshape(-1, 3))
        if self.hermite:
            self.ends, self.t_hat = _endpoint_tangents(rays.points)
        table0 = self.model.table(field_m0, grid)
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
        CUDA the two scatter plans; R's transpose is rows_value's autograd
        backward (K3), taken through one retained graph of R over a zero
        table."""
        cuda = self.ri.is_cuda
        rows = self.model.rows
        plan = (rows.row_plan(self.ri, self.zi, self.table_shape[0])
                if cuda else None)
        self.row_plan = plan
        self.end_plan = (rows.endpoint_plan(self.grid, self.ends)
                         if cuda and self.hermite else None)
        self._leaf = torch.zeros(self.table_shape, device=self.ri.device,
                                 requires_grad=True)
        with torch.enable_grad():
            self._graph = tricubic.rows_value(
                self._leaf, self.ri, self.wxy, self.zi, self.wz,
                self.model.xy_first, plan)
        return self._rows(table0)

    def _rows(self, table: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value(table, self.ri, self.wxy, self.zi,
                                   self.wz, self.model.xy_first)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        (table_ct,) = torch.autograd.grad(self._graph, self._leaf, ct,
                                          retain_graph=True)
        return table_ct

    def _value_grad(self, table: torch.Tensor):
        return self.model.rows.interp_rows_with_grad(table, self.grid,
                                                     self.ends)

    def _value_grad_t(self, ct_value, ct_grad) -> torch.Tensor:
        return self.model.rows.interp_rows_with_grad_transpose(
            self.grid, self.ends, ct_value, ct_grad, self.end_plan)

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        """J δm: field tangent (grid.shape) → dTEC tangent (Na·Nd,)."""
        check_full_f32()
        t = self.model.table(dm, self.grid).contiguous()
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
        return self.model.table_t(table_ct, self.grid)


def dtec_paired_linear(field_m0, grid, rays, num_directions, i0=0,
                       quadrature: str = "hermite", interp: str = "cubic"
                       ) -> PairedDtecLinear:
    """``dtec_paired_q`` linearised about ``field_m0`` (on CUDA kernels
    K2 and K3, with K5 and K5ᵀ on cubic or K1e and K1eᵀ on zp)."""
    return PairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                            quadrature, interp)


class _PlainPairedDtecLinear(PairedDtecLinear):
    """``PairedDtecLinear`` with R, Rᵀ, E and Eᵀ replaced by their plain
    versions."""

    def _setup(self, table0: torch.Tensor) -> torch.Tensor:
        return self._rows(table0)

    def _rows(self, table: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value_ref(table, self.ri, self.wxy, self.zi,
                                       self.wz, self.model.xy_first)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        return tricubic.rows_value_transpose_ref(
            ct, self.ri, self.wxy, self.zi, self.wz, self.table_shape)

    def _value_grad(self, table: torch.Tensor):
        return self.model.rows.interp_rows_with_grad_ref(table, self.grid,
                                                         self.ends)

    def _value_grad_t(self, ct_value, ct_grad) -> torch.Tensor:
        return self.model.rows.interp_rows_with_grad_transpose_ref(
            self.grid, self.ends, ct_value, ct_grad)


def dtec_paired_linear_ref(field_m0, grid, rays, num_directions, i0=0,
                           quadrature: str = "hermite", interp: str = "cubic"
                           ) -> PairedDtecLinear:
    """Plain PyTorch version of ``dtec_paired_linear``: the same operator
    built from the ``*_ref`` primitives, on any device."""
    return _PlainPairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                                  quadrature, interp)


def tec_linear(ne_field: torch.Tensor, grid: Grid3D, rays: RayBundle,
               interp: str = "cubic") -> torch.Tensor:
    """TEC as a *linear* operator of the n_e field itself (m^-3 in,
    working units out): the ray–voxel projection applied matrix-free."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    v = _interp_fast(ne_field, grid, rays.points.reshape(-1, 3), interp)
    w = simpson_weights(n, v.dtype, v.device)
    return (torch.einsum("rn,n->r", v.reshape(r, n), w) * rays.ds
            * constants.KM_TO_M / constants.TEC_SCALE)


def tec_linear_adjoint(y: torch.Tensor, grid: Grid3D, rays: RayBundle,
                       interp: str = "cubic") -> torch.Tensor:
    """Exact transpose of ``tec_linear``: data space (R,) → voxel grid.

    Pᵀ Rᵀ of y_r·w_n·ds_r·1e3/TEC_SCALE per sample, Rᵀ being
    ``rows_value_transpose`` on the field model's rows: kernel K3 over
    the model's row plan on CUDA (deterministic), ``index_add_`` of the
    scalar contributions on the CPU. On cubic the reference writes the
    same scatter through the 64 stencil weights of ``interp_weights``; on
    zp it takes ``jax.linear_transpose``, which includes Pᵀ."""
    model = field_model(interp)
    r, n = rays.points.shape[:2]
    nx, ny, nz = grid.shape
    ri, wxy, zi, wz = model.rows.row_setup(grid, rays.points.reshape(-1, 3))
    wq = simpson_weights(n, y.dtype, y.device)
    coef = (y[:, None] * wq[None, :] * rays.ds[:, None]
            * (constants.KM_TO_M / constants.TEC_SCALE)).reshape(-1)
    plan = model.rows.row_plan(ri, zi, nx * ny) if coef.is_cuda else None
    table_ct = tricubic.rows_value_transpose(coef.contiguous(), ri, wxy, zi,
                                             wz, (nx * ny, nz), plan)
    return model.table_t(table_ct, grid)


def ray_coverage(grid: Grid3D, rays: RayBundle,
                 interp: str = "cubic") -> torch.Tensor:
    """Per-voxel sampling weight: the adjoint of the path integral applied
    to ones, i.e. how much ray path (in quadrature-weight units) touches
    each voxel. A diagnostic, and the mask of the constrained region."""
    ones = torch.ones((rays.num_rays,), dtype=torch.float32,
                      device=rays.points.device)
    return tec_linear_adjoint(ones, grid, rays, interp)


def vtec_map(field_m: torch.Tensor, grid: Grid3D) -> torch.Tensor:
    """Vertical TEC map: ∫ n_e dz per (x, y) column, (nx, ny) in
    TEC_SCALE working units; Simpson over the grid's own z axis."""
    check_full_f32()
    ne = constants.K_NE * torch.exp(field_m)               # (nx, ny, nz)
    w = simpson_weights(grid.shape[2], ne.dtype, ne.device)
    dz = grid.spacing[2] * constants.KM_TO_M
    return torch.einsum("xyz,z->xy", ne, w) * dz / constants.TEC_SCALE


def dtec_noise_from_beam(tec_std: torch.Tensor, num_directions: int,
                         i0: int = 0) -> torch.Tensor:
    """Per-(antenna, direction) dTEC observation-noise contribution from
    per-ray TEC spreads: σ_dTEC = sqrt(σ_ad² + σ_{i0,d}²), the reference
    antenna's own row exactly 0."""
    sd = torch.as_tensor(tec_std).reshape(-1, num_directions)
    out = torch.sqrt(sd ** 2 + sd[i0][None, :] ** 2)
    is_ref = torch.arange(sd.shape[0], device=sd.device)[:, None] == i0
    return torch.where(is_ref, 0.0, out)
