"""TEC path integrals, the paired differential-TEC forward equation, its
linearisation and the linear ray–voxel projection with its transpose
(port of ``ionotomo_tpu.forward.tec``).

Units: ray geometry in km, n_e in m^-3; TEC returned in working units of
``constants.TEC_SCALE`` m^-2 (1e13 = 1 mTECU).

Every function takes ``interp``, the field model (``core.field_models``:
"cubic", the default, "zp"/"zp<order>" or "zpc"/"zpc<order>"; "quadratic"
raises ValueError, as in the reference, whose operators do not take it).
The value gathers run through the model's ``interp_rows`` (kernel K2 on
CUDA) and the Hermite endpoint derivatives through its
``interp_rows_with_grad`` (kernel K5 on cubic, K1e on zp, K6z on zpc).
The gather is monolithic: the reference's chunking of large batches
bounds a gathered pencil block that the kernels never build, so it is
not ported.

``PairedDtecLinear`` is the linearised paired-dTEC operator J about a
field m0 and its transpose, written out where the reference takes
``jax.linearize`` and ``jax.linear_transpose`` of ``dtec_paired_q``:
J δm = Q(n_e(m0) ⊙ R P δm) + the Hermite endpoint terms, Jᵀ y =
Pᵀ Rᵀ(n_e ⊙ Qᵀ y) + Pᵀ Eᵀ(endpoint cotangents), with P the model's
table map (the prefilter on zp and zpc, the identity on cubic), R
``rows_value`` (K2) and Rᵀ ``rows_value_transpose`` (K3), E the model's
value + gradient (K5ᵀ, K1eᵀ or K6zᵀ as its transpose) and Q the paired
quadrature. What depends only on the ray samples is a ``DtecGeometry``,
built once per bundle and shared by every linearisation over it;
fields, tangents and cotangents may carry a leading member axis (K2b,
K3b). ``tec_linear_op`` is the same operator without the antenna
pairing (absolute-TEC anchor rows) and ``LogNeLinear`` the linear map
of ``log_ne_at`` (probe rows).

``tec_linear_adjoint`` (and so ``ray_coverage``) is Pᵀ of
``rows_value_transpose``: kernel K3 over the model's row plan, where the
reference scatters 64 stencil weights per sample on cubic.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core import boxspline, tricubic
from ..core.field_models import operator_model
from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..geometry.rays import RayBundle, simpson_weights, trapezoid_weights


def _ref_row(arr: torch.Tensor, i0: int) -> torch.Tensor:
    """arr[i0], the reference antenna's row (unsharded)."""
    return arr[i0]


def _sub_ref(x: torch.Tensor, i0, axis: int) -> torch.Tensor:
    """x − x[i0] along the antenna axis ``axis`` (negative: leading member
    axes ride along); ``i0`` None leaves x as it is (absolute TEC)."""
    if i0 is None:
        return x
    return x - x.select(axis, i0).unsqueeze(axis)


def _sub_ref_t(ct: torch.Tensor, i0, axis: int) -> torch.Tensor:
    """Transpose of ``_sub_ref``."""
    if i0 is None:
        return ct
    out = ct.clone()
    out.select(axis, i0).sub_(ct.sum(axis))
    return out


def _coef2d(field_m: torch.Tensor, grid: Grid3D, interp: str
            ) -> torch.Tensor:
    """The (nx*ny, nz) row-gather table of the chosen field model: a free
    view of the field for "cubic", the prefiltered coefficient grid for
    "zp" and "zpc"."""
    return operator_model(interp).table(field_m, grid)


def _rows_of(interp: str):
    """The module of the field model's row-gather evaluators."""
    return operator_model(interp).rows


def _interp_fast(field_m: torch.Tensor, grid: Grid3D, pts2d: torch.Tensor,
                 interp: str = "cubic") -> torch.Tensor:
    """Row-gather interpolation of the field at points (N, 3) under the
    selected field model, in one pass over all points."""
    model = operator_model(interp)
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
                       i0) -> torch.Tensor:
    """Paired Simpson dTEC (..., Na, Nd) from densities ne (..., Na, Nd, N)
    [m⁻³] (or their tangents: the map is linear in ne) and the Simpson
    weights w (N,). ``i0`` None: no pairing, the TEC per ray."""
    check_full_f32()
    na, nd = ne.shape[-3:-1]
    dne = _sub_ref(ne, i0, -3)
    ds = rays.ds.reshape(na, nd)
    out = torch.einsum("...n,n->...", dne, w) * ds * constants.KM_TO_M
    return out / constants.TEC_SCALE


def _paired_simpson_ne_t(y: torch.Tensor, w: torch.Tensor, rays: RayBundle,
                         i0) -> torch.Tensor:
    """Transpose of ``_paired_simpson_ne``: (..., Na, Nd) → (..., Na, Nd,
    N)."""
    na, nd = y.shape[-2:]
    ds = rays.ds.reshape(na, nd)
    s = (y / constants.TEC_SCALE) * constants.KM_TO_M * ds
    return _sub_ref_t(s[..., None] * w, i0, -3)


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
    """TEC per ray, (R,), in TEC_SCALE working units (Simpson); over a
    ray-sharded bundle, the sharded operator's forward."""
    if _sharded(rays, None):
        return _sharded_forward(field_m, grid, rays, None, None, "simpson",
                                interp)
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
                       w: torch.Tensor, rays: RayBundle, i0
                       ) -> torch.Tensor:
    """Paired Hermite dTEC (..., Na, Nd) from densities ne (..., Na, Nd,
    N), the endpoint path derivatives d0, d1 (..., R) (or their tangents:
    linear) and the trapezoid weights w (N,). ``i0`` None: no pairing."""
    check_full_f32()
    na, nd = ne.shape[-3:-1]
    dne = _sub_ref(ne, i0, -3)
    corr = _sub_ref((d0 - d1).reshape(d0.shape[:-1] + (na, nd)), i0, -2)
    ds = rays.ds.reshape(na, nd)
    out = (torch.einsum("...n,n->...", dne, w) * ds + corr * ds * ds / 12.0)
    return out * (constants.KM_TO_M / constants.TEC_SCALE)


def _paired_hermite_ne_t(y: torch.Tensor, w: torch.Tensor, rays: RayBundle,
                         i0):
    """Transpose of ``_paired_hermite_ne``: (..., Na, Nd) → (ct_ne (...,
    Na, Nd, N), ct_d0 (..., R)); the cotangent of d1 is −ct_d0."""
    na, nd = y.shape[-2:]
    ds = rays.ds.reshape(na, nd)
    s = y * (constants.KM_TO_M / constants.TEC_SCALE)
    ct_ne = _sub_ref_t((s * ds)[..., None] * w, i0, -3)
    ct_corr = _sub_ref_t(s * ds * ds / 12.0, i0, -2)
    return ct_ne, ct_corr.reshape(y.shape[:-2] + (-1,))


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
    """Paired dTEC under the named quadrature ("simpson" or "hermite");
    over a ray-sharded bundle, the sharded operator's forward."""
    if _sharded(rays, None):
        return _sharded_forward(field_m, grid, rays, num_directions, i0,
                                quadrature, interp).reshape(
            field_m.shape[:-3] + (-1, num_directions))
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


class DtecGeometry:
    """What the linearised operators reuse while the ray samples stay
    fixed, whatever field they are linearised about: the field model's
    point set-up on the samples (``ri``, ``wxy``, ``zi``, ``wz``), the
    quadrature weights, the Hermite endpoints with their unit tangents,
    and on CUDA the two scatter plans (``row_plan`` for K3/K3b,
    ``end_plan`` for K1eᵀ or K5ᵀ), each a sort of its pairs, and K2's
    ``point_order()``, a sort of its points built at the first unbatched
    gather (an ensemble's K2b takes none). A filter
    that linearises about a new field every step over the same bundle
    builds this once and passes it to every ``PairedDtecLinear``.

    ``num_directions`` None: no antenna pairing, every ray its own row
    (the absolute-TEC operator ``TecLinear``). ``plans=False`` builds no
    plan (the plain-version operators take none)."""

    def __init__(self, grid: Grid3D, rays: RayBundle, num_directions,
                 i0=0, quadrature: str = "hermite", interp: str = "cubic",
                 plans: bool = True):
        check_full_f32()
        if quadrature not in ("hermite", "simpson"):
            raise ValueError(f"unknown quadrature: {quadrature!r}")
        self.model = operator_model(interp)   # ValueError for quadratic
        self.grid, self.rays = grid, rays
        self.quadrature, self.interp = quadrature, interp
        self.hermite = quadrature == "hermite"
        r, self.n = rays.points.shape[:2]
        if num_directions is None:
            self.na, self.nd, self.i0 = r, 1, None
        else:
            self.na, self.nd, self.i0 = r // num_directions, num_directions, i0
        nx, ny, nz = grid.shape
        self.table_shape = (nx * ny, nz)
        weights = trapezoid_weights if self.hermite else simpson_weights
        self.w = weights(self.n, torch.float32, rays.points.device)
        rows = self.model.rows
        self.ri, self.wxy, self.zi, self.wz = rows.row_setup(
            grid, rays.points.reshape(-1, 3))
        self.ends = self.t_hat = None
        if self.hermite:
            self.ends, self.t_hat = _endpoint_tangents(rays.points)
        cuda = plans and self.ri.is_cuda
        self.row_plan = (rows.row_plan(self.ri, self.zi, self.table_shape[0])
                         if cuda else None)
        self._order_on_cuda, self._point_order = cuda, None
        self.end_plan = (rows.endpoint_plan(grid, self.ends)
                         if cuda and self.hermite else None)

    def point_order(self):
        """K2's order of the samples (``tricubic.PointOrder``), built at
        the first call and kept; None where the geometry builds no plans
        (the CPU, the plain-version operators)."""
        if self._point_order is None and self._order_on_cuda:
            self._point_order = self.model.rows.point_order(
                self.ri, self.wxy, self.zi, self.wz, self.grid.shape)
        return self._point_order


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
    value and gradient there (E on t). What depends only on the samples
    is a ``DtecGeometry`` (built here unless given: ``geometry=``); what
    depends on m0 (n_e, the endpoint slopes, g0) is built here (from m0's
    table ``table0`` where the caller made it already: the shards of a
    ray-sharded operator share one). An application is P, one gather or
    scatter and the quadrature.

    **Member axis.** m0, δm and y may carry one leading axis (B, ...): the
    members of an ensemble over the shared geometry. Then R is kernel K2b
    and Rᵀ kernel K3b, one launch for all members; on zp E is the batched
    K1e, one launch too, over the member pack of the table that K2b reads
    (``tricubic.member_pack``, made once in the application); E on cubic
    and zpc and Eᵀ (20,000 points a bundle) launch their unbatched kernels
    once per member. An operator linearised about one field also takes batched
    δm and y (the square-root anchor update applies one K to all
    anomalies).

    On CUDA tensors R is ``rows_value`` (K2, K2b) and Rᵀ
    ``rows_value_transpose`` (K3, K3b) over the geometry's plan; E and Eᵀ
    are K5 and K5ᵀ on cubic, K1e and K1eᵀ on zp, K6z and K6zᵀ on zpc. Eᵀ
    adds into Rᵀ's fresh table in place (K5ᵀ and K6zᵀ at the touched cells
    only; K1eᵀ's whole table is added). ``dtec_paired_linear_ref``
    builds the same operator from the plain versions (``*_ref``) of those,
    on any device.
    """

    _plans = True

    def __init__(self, field_m0: torch.Tensor, grid: Grid3D,
                 rays: RayBundle, num_directions, i0=0,
                 quadrature: str = "hermite", interp: str = "cubic",
                 geometry: DtecGeometry = None, table0=None):
        geo = geometry or DtecGeometry(grid, rays, num_directions, i0,
                                       quadrature, interp, self._plans)
        self.geometry = geo
        if table0 is None:
            table0 = geo.model.table(field_m0, grid).contiguous()
        lead = table0.shape[:-2]
        pack = self._pack(table0)
        self.ne = constants.K_NE * torch.exp(self._rows(table0, pack))
        ne3 = self.ne.reshape(lead + (geo.na, geo.nd, geo.n))
        if not geo.hermite:
            self.g0 = _paired_simpson_ne(ne3, geo.w, rays, geo.i0).reshape(
                lead + (-1,))
            return
        m_e, gm_e = self._value_grad(table0, pack)
        del pack
        self.ne_e = constants.K_NE * torch.exp(m_e)
        self.slope = torch.einsum("...pd,pd->...p", gm_e, geo.t_hat)
        dnds = self.ne_e * self.slope
        r = geo.ends.shape[0] // 2
        self.g0 = _paired_hermite_ne(ne3, dnds[..., :r], dnds[..., r:], geo.w,
                                     rays, geo.i0).reshape(lead + (-1,))

    def __getattr__(self, name):
        # the geometry's fields (ri, row_plan, ends, na, ...) read as the
        # operator's own
        if name == "geometry":
            raise AttributeError(name)
        return getattr(self.geometry, name)

    def _pack(self, table: torch.Tensor):
        """The member pack of a (B, R, nz) table on the card, which K2b
        and the batched K1e both read: made once an application, dropped
        with it. None for one table and on the CPU."""
        if table.dim() == 3 and table.is_cuda:
            return tricubic.member_pack(table)
        return None

    def _rows(self, table: torch.Tensor, pack=None) -> torch.Tensor:
        geo = self.geometry
        return tricubic.rows_value(
            table, geo.ri, geo.wxy, geo.zi, geo.wz, geo.model.xy_first,
            order=geo.point_order() if table.dim() == 2 else None,
            pack=pack)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        geo = self.geometry
        return tricubic.rows_value_transpose(
            ct.contiguous(), geo.ri, geo.wxy, geo.zi, geo.wz,
            geo.table_shape, geo.row_plan)

    def _value_grad(self, table: torch.Tensor, pack=None):
        """E: value and gradient at the endpoints. For a (B, R, nz) table:
        all members at once on zp (the batched K1e over ``pack``), member
        by member on cubic and zpc."""
        geo = self.geometry
        rows = geo.model.rows
        if table.dim() == 2:
            return rows.interp_rows_with_grad(table, geo.grid, geo.ends)
        if rows is boxspline:
            return rows.interp_rows_with_grad_batched(table, geo.grid,
                                                      geo.ends, pack)
        vals, grads = zip(*(rows.interp_rows_with_grad(t, geo.grid, geo.ends)
                            for t in table))
        return torch.stack(vals), torch.stack(grads)

    def _value_grad_t_add_(self, table, ct_value, ct_grad) -> torch.Tensor:
        """table += Eᵀ(ct), in place, member by member for (B, P) and (B,
        P, 3) cotangents into a (B, R, nz) table; returns ``table``."""
        geo = self.geometry
        add_ = geo.model.rows.interp_rows_with_grad_transpose_add_
        if ct_value.dim() == 1:
            return add_(table, geo.grid, geo.ends, ct_value, ct_grad,
                        geo.end_plan)
        for t, cv, cg in zip(table, ct_value, ct_grad):
            add_(t, geo.grid, geo.ends, cv, cg, geo.end_plan)
        return table

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        """J δm: field tangent (..., *grid.shape) → dTEC tangent (...,
        Na·Nd)."""
        check_full_f32()
        geo = self.geometry
        t = geo.model.table(dm, geo.grid).contiguous()
        pack = self._pack(t)
        dne = self.ne * self._rows(t, pack)
        lead = dne.shape[:-1]
        dne = dne.reshape(lead + (geo.na, geo.nd, geo.n))
        if not geo.hermite:
            return _paired_simpson_ne(dne, geo.w, geo.rays, geo.i0).reshape(
                lead + (-1,))
        dm_e, dgm_e = self._value_grad(t, pack)
        del pack
        dd = ((self.ne_e * dm_e) * self.slope
              + self.ne_e * torch.einsum("...pd,pd->...p", dgm_e, geo.t_hat))
        r = dd.shape[-1] // 2
        return _paired_hermite_ne(dne, dd[..., :r], dd[..., r:], geo.w,
                                  geo.rays, geo.i0).reshape(lead + (-1,))

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """Jᵀ y: dTEC cotangent (..., Na·Nd) → field cotangent (...,
        *grid.shape)."""
        geo = self.geometry
        lead = y.shape[:-1]
        y = y.reshape(lead + (geo.na, geo.nd))
        if not geo.hermite:
            ct_ne = _paired_simpson_ne_t(y, geo.w, geo.rays, geo.i0)
        else:
            ct_ne, ct_d0 = _paired_hermite_ne_t(y, geo.w, geo.rays, geo.i0)
        table_ct = self._rows_t(self.ne * ct_ne.reshape(lead + (-1,)))
        if geo.hermite:
            # into Rᵀ's fresh table, in place
            ct_d = torch.cat([ct_d0, -ct_d0], dim=-1) * self.ne_e
            table_ct = self._value_grad_t_add_(
                table_ct, ct_d * self.slope, ct_d[..., None] * geo.t_hat)
        return geo.model.table_t(table_ct, geo.grid)


def dtec_paired_over(field_m: torch.Tensor, geometry: DtecGeometry
                     ) -> torch.Tensor:
    """``dtec_paired`` (Simpson) of ``field_m`` over a prepared Simpson
    ``DtecGeometry``, the forward alone: (..., Na·Nd) for a field (...,
    *grid.shape). A leading member axis is one K2b launch on the card,
    over its member pack. Equals the ``g0`` of the operator linearised
    about the same field over the same geometry."""
    geo = geometry
    if geo.hermite:
        raise ValueError("dtec_paired_over needs a Simpson geometry")
    if _sharded(None, geo):
        from ..parallel.sharding import sharded_dtec_forward
        return sharded_dtec_forward(field_m, geo)
    table = geo.model.table(field_m, geo.grid).contiguous()
    lead = table.shape[:-2]
    ne = _ne_over(table, geo).reshape(lead + (geo.na, geo.nd, geo.n))
    return _paired_simpson_ne(ne, geo.w, geo.rays, geo.i0).reshape(
        lead + (-1,))


def _ne_over(table: torch.Tensor, geo: DtecGeometry) -> torch.Tensor:
    """n_e (..., R·N) at a geometry's samples of a (R, nz) table, or of a
    (B, R, nz) one (one K2b launch on the card, over its member pack)."""
    batched = table.dim() == 3
    m = tricubic.rows_value(
        table, geo.ri, geo.wxy, geo.zi, geo.wz, geo.model.xy_first,
        order=None if batched else geo.point_order(),
        pack=tricubic.member_pack(table) if batched and table.is_cuda
        else None)
    return constants.K_NE * torch.exp(m)


def _dnds_over(table: torch.Tensor, geo: DtecGeometry) -> torch.Tensor:
    """The path derivative n_e·(∇m·t̂) (..., 2R) at a Hermite geometry's
    endpoints of a (R, nz) table, or member by member of a (B, R, nz)
    one."""
    if table.dim() == 3:
        return torch.stack([_dnds_over(t, geo) for t in table])
    m_e, gm_e = geo.model.rows.interp_rows_with_grad(table, geo.grid,
                                                     geo.ends)
    return (constants.K_NE * torch.exp(m_e)) * torch.einsum(
        "pd,pd->p", gm_e, geo.t_hat)


def _sharded_forward(field_m, grid, rays, num_directions, i0, quadrature,
                     interp):
    """The forward alone over a ray-sharded bundle, over a geometry that
    builds no plans."""
    from ..parallel.sharding import sharded_dtec_forward
    return sharded_dtec_forward(field_m, dtec_geometry(
        grid, rays, num_directions, i0, quadrature, interp, plans=False))


def _sharded(rays, geometry) -> bool:
    """A ray-sharded bundle (``parallel.sharding.ShardedRayBundle``) or
    its geometry."""
    if geometry is not None:
        return not isinstance(geometry, DtecGeometry)
    return not isinstance(rays, RayBundle)


def dtec_geometry(grid: Grid3D, rays, num_directions, i0=0,
                  quadrature: str = "hermite", interp: str = "cubic",
                  plans: bool = True):
    """The geometry of a bundle, keyed on its type: a ``DtecGeometry``,
    or for a ray-sharded bundle the ``parallel.sharding.
    ShardedDtecGeometry`` (one geometry a shard), so that no solver
    branches on sharding."""
    if _sharded(rays, None):
        from ..parallel.sharding import ShardedDtecGeometry
        return ShardedDtecGeometry(grid, rays, num_directions, i0,
                                   quadrature, interp, plans)
    return DtecGeometry(grid, rays, num_directions, i0, quadrature, interp,
                        plans)


def dtec_paired_linear(field_m0, grid, rays, num_directions, i0=0,
                       quadrature: str = "hermite", interp: str = "cubic",
                       geometry: DtecGeometry = None) -> PairedDtecLinear:
    """``dtec_paired_q`` linearised about ``field_m0`` (on CUDA kernels
    K2 and K3, or K2b and K3b for a field with a member axis, with K5 and
    K5ᵀ on cubic, K1e and K1eᵀ on zp, K6z and K6zᵀ on zpc); over a
    ray-sharded bundle, ``parallel.sharding.ShardedPairedDtecLinear``."""
    if _sharded(rays, geometry):
        from ..parallel.sharding import ShardedPairedDtecLinear
        return ShardedPairedDtecLinear(field_m0, grid, rays, num_directions,
                                       i0, quadrature, interp, geometry)
    return PairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                            quadrature, interp, geometry)


class _PlainPairedDtecLinear(PairedDtecLinear):
    """``PairedDtecLinear`` with R, Rᵀ, E and Eᵀ replaced by their plain
    versions (and no plans)."""

    _plans = False

    def _pack(self, table: torch.Tensor):
        return None

    def _rows(self, table: torch.Tensor, pack=None) -> torch.Tensor:
        geo = self.geometry
        return tricubic.rows_value_ref(table, geo.ri, geo.wxy, geo.zi,
                                       geo.wz, geo.model.xy_first)

    def _rows_t(self, ct: torch.Tensor) -> torch.Tensor:
        geo = self.geometry
        return tricubic.rows_value_transpose_ref(
            ct, geo.ri, geo.wxy, geo.zi, geo.wz, geo.table_shape)

    def _value_grad(self, table: torch.Tensor, pack=None):
        geo = self.geometry
        ref = geo.model.rows.interp_rows_with_grad_ref
        if table.dim() == 2:
            return ref(table, geo.grid, geo.ends)
        vals, grads = zip(*(ref(t, geo.grid, geo.ends) for t in table))
        return torch.stack(vals), torch.stack(grads)

    def _value_grad_t_add_(self, table, ct_value, ct_grad) -> torch.Tensor:
        geo = self.geometry
        ref = geo.model.rows.interp_rows_with_grad_transpose_ref
        if ct_value.dim() == 1:
            return table + ref(geo.grid, geo.ends, ct_value, ct_grad)
        return table + torch.stack([ref(geo.grid, geo.ends, cv, cg)
                                    for cv, cg in zip(ct_value, ct_grad)])


def dtec_paired_linear_ref(field_m0, grid, rays, num_directions, i0=0,
                           quadrature: str = "hermite", interp: str = "cubic",
                           geometry: DtecGeometry = None
                           ) -> PairedDtecLinear:
    """Plain PyTorch version of ``dtec_paired_linear``: the same operator
    built from the ``*_ref`` primitives, on any device."""
    if _sharded(rays, geometry):
        from ..parallel.sharding import ShardedPairedDtecLinear
        return ShardedPairedDtecLinear(field_m0, grid, rays, num_directions,
                                       i0, quadrature, interp, geometry,
                                       part_cls=_PlainPairedDtecLinear)
    return _PlainPairedDtecLinear(field_m0, grid, rays, num_directions, i0,
                                  quadrature, interp, geometry)


def tec_linear_op(field_m0, grid, rays, quadrature: str = "simpson",
                  interp: str = "cubic", geometry: DtecGeometry = None,
                  ref: bool = False) -> PairedDtecLinear:
    """The absolute-TEC forward ``tec_q`` linearised about ``field_m0``:
    the paired operator without the reference-antenna pairing, every ray
    its own row, (R,) data. ``g0`` is ``tec_q(field_m0)``. The rows of the
    absolute-TEC anchors (``inversion.anchors``). ``ref``: on the plain
    versions."""
    cls = _PlainPairedDtecLinear if ref else PairedDtecLinear
    return cls(field_m0, grid, rays, None, None, quadrature, interp,
               geometry)


class LogNeLinear:
    """``log_ne_at`` as a linear operator with its transpose: R P over
    fixed points (N, 3), the rows of point-density probes. ``apply``
    (..., *grid.shape) → (..., N) and ``apply_t`` back; ``g0`` is the
    operator on ``field_m0`` (the map is exactly linear in m). K2 and K3
    (K2b, K3b with a member axis) on CUDA."""

    def __init__(self, field_m0, grid: Grid3D, points: torch.Tensor,
                 interp: str = "cubic"):
        self.model = operator_model(interp)
        self.grid = grid
        nx, ny, nz = grid.shape
        self.table_shape = (nx * ny, nz)
        self.shape = tuple(points.shape[:-1])
        self.setup = self.model.rows.row_setup(grid, points.reshape(-1, 3))
        ri, _, zi, _ = self.setup
        self.row_plan = (self.model.rows.row_plan(ri, zi, nx * ny)
                         if ri.is_cuda else None)
        self._point_order = None
        self.g0 = self.apply(field_m0)

    def point_order(self):
        """K2's order of the points, built at the first unbatched gather
        on CUDA and kept (as ``DtecGeometry.point_order``)."""
        if self._point_order is None and self.setup[0].is_cuda:
            self._point_order = self.model.rows.point_order(
                *self.setup, self.grid.shape)
        return self._point_order

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        t = self.model.table(dm, self.grid).contiguous()
        out = tricubic.rows_value(
            t, *self.setup, self.model.xy_first,
            order=self.point_order() if t.dim() == 2 else None)
        return out.reshape(out.shape[:-1] + self.shape)

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        lead = y.shape[:y.dim() - len(self.shape)]
        table_ct = tricubic.rows_value_transpose(
            y.reshape(lead + (-1,)).contiguous(), *self.setup,
            self.table_shape, self.row_plan)
        return self.model.table_t(table_ct, self.grid)


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
    model = operator_model(interp)
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
