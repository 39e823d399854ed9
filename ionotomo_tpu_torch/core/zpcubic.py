"""ZP-xy × cubic-z hybrid field model, ``interp="zpc"`` (port of
``ionotomo_tpu.core.zpcubic``).

    f(x, y, z) = Σ_{k,l} ZP(x−k, y−l) · Σ_m c_{k,l,m} CR(z−m)

The Zwart–Powell element in the gathered (x, y) plane (the box spline's
8-row gather and xy quasi-interpolation prefilter) and the interpolating
Catmull–Rom cubic along z (the tricubic model's 4 taps, no z prefilter).
The coefficient grid comes from ``prefilter``; the evaluators take it
reshaped to (nx*ny, nz).

On CUDA tensors the evaluators run the hand-written kernels: the value
path's gather-and-contract is K2 (``core.tricubic.rows_value`` at K=8,
L=4, xy first, with K3 as its transpose; ``point_order`` the order K2 runs
a fixed point set in), value + gradient is K6z and its transpose with
respect to the table K6zᵀ, which adds into a given table over a plan of
occupied rows (``endpoint_plan``). On CPU tensors they run the plain
versions in this module. ``interp_rows_with_grad_taps_ref`` is K6z's and
K1z's evaluator summed in the kernels' order, and
``interp_rows_with_grad_packed_ref`` K1z's evaluator over K1c's z-tap pack
(``core.tricubic.pack_z_taps_ref``), bitwise equal to that twin.

Where the clamped z taps of the bottom and top cell bases land on one
lane, the reference's dense z band sums their weights before it
contracts; the kernels' evaluator and its twins merge them the same way
(``_merged_z_weights``).

``prefilter_transpose`` is Pᵀ, written out for the reason
``core.boxspline.prefilter_transpose`` gives.
"""
from __future__ import annotations

import torch

from .. import kernels
from .boxspline import (ZP_LIVE_TRANSLATES, _apply_a_xy, _row_index,
                        _xy_weights)
from .grids import Grid3D
from .precision import check_full_f32
from .tricubic import (_catmull_rom_dweights, _catmull_rom_weights, _z_band,
                       build_point_order, build_row_plan, rows_value,
                       scatter_add_)


def zpc_order(interp: str) -> int:
    """Parse ``"zpc"`` / ``"zpc<order>"`` → xy-prefilter Neumann order
    (``"zpc"`` ≡ ``"zpc2"``, exact quadratic reproduction). Raises on
    anything else."""
    if interp == "zpc":
        return 2
    if interp.startswith("zpc") and interp[3:].isdigit():
        order = int(interp[3:])
        if order >= 2:
            return order
    raise ValueError(
        f"unknown zpc interp spec {interp!r} (use 'zpc' or 'zpc<order>=2>')")


def prefilter(field: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Samples (..., nx, ny, nz) → hybrid coefficient grid: the ZP xy
    quasi-interpolation only (the box spline prefilter's xy half); the z
    axis stays raw samples, which Catmull–Rom interpolates directly.
    Leading axes (an ensemble's members) ride along."""
    acc = field
    d = field
    for _ in range(order):
        d = d - _apply_a_xy(d)
        acc = acc + d
    return acc


def prefilter_transpose(coef: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Pᵀ: a coefficient-grid cotangent (..., nx, ny, nz) → field
    cotangent, Σ_{j≤order} (I − Aᵀ)ʲ over (x, y) with Aᵀ = A (see
    ``core.boxspline.prefilter_transpose``: written out so that no
    autograd scatter adds by atomics on the card). zpc has no z matrix."""
    acc = coef
    d = coef
    for _ in range(order):
        d = d - _apply_a_xy(d)
        acc = acc + d
    return acc


def _neighborhood(grid: Grid3D, points: torch.Tensor):
    """xy: the nearest-lattice ZP set-up (box spline contract); z: the
    floor-based 4-tap Catmull–Rom stencil (tricubic contract). Returns (bx,
    by (N,) int32; u, v (N,) signed xy offsets; zi (N, 4) int32 clamped z
    taps; fz (N,) z cell fraction in [0, 1])."""
    t = grid.world_to_index(points)
    shape = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(shape)), shape - 1.0)
    bxy = torch.minimum(torch.maximum(torch.round(t[:, :2]),
                                      torch.ones_like(shape[:2])),
                        shape[:2] - 2.0)
    u = t[:, 0] - bxy[:, 0]
    v = t[:, 1] - bxy[:, 1]
    nz = grid.shape[2]
    bz = torch.clamp(torch.floor(t[:, 2]), 0.0, nz - 2.0)
    fz = t[:, 2] - bz
    zi = (bz.to(torch.int32)[:, None]
          + torch.arange(-1, 3, dtype=torch.int32, device=t.device)[None, :])
    zi = torch.clamp(zi, 0, nz - 1)
    b = bxy.to(torch.int32)
    return b[:, 0], b[:, 1], u, v, zi, fz


def row_setup(grid: Grid3D, points: torch.Tensor):
    """What ``rows_value`` takes for the zpc value at points (N, 3): (ri
    (N, 8) int32, wxy (N, 8), zi (N, 4) int32, wz (N, 4)), contiguous.
    wz are the Catmull–Rom weights as the reference passes them, unmerged:
    ``rows_value``'s dense band sums those of a shared lane."""
    bx, by, u, v, zi, fz = _neighborhood(grid, points)
    dx, dy, wxy = _xy_weights(u, v, with_grad=False)
    ri = _row_index(bx, by, dx, dy, grid)
    return (ri.contiguous(), wxy.contiguous(), zi.contiguous(),
            _catmull_rom_weights(fz).contiguous())


#: The translate whose row is the base cell's in every piece: (0, 0), as
#: the box spline's.
BASE_TRANSLATE = 2


def point_order(ri, wxy, zi, wz, grid_shape):
    """K2's order of ``row_setup``'s points, by their base cell (row
    ri[:, 2], z the cell base zi[:, 1]; ``core.tricubic.PointOrder``)."""
    return build_point_order(ri, wxy, zi, wz, BASE_TRANSLATE, grid_shape)


def row_plan(ri: torch.Tensor, zi: torch.Tensor, n_rows: int):
    """The K3 plan of ``row_setup``'s pairs: the 7 live translates of each
    point (the 8th has weight 0), sorted within a row by the cell base,
    the second z tap (the first is clamped at the bottom edge, so two
    bases share it)."""
    return build_row_plan(ri, n_rows, zi[:, 1], live=ZP_LIVE_TRANSLATES)


def endpoint_plan(grid: Grid3D, points: torch.Tensor):
    """The K6zᵀ plan of fixed points: their 7 live (point, translate)
    pairs, ids n·8 + t, sorted by table row and cell base and cut into
    segments, occupied rows only, with each row's range of cell bases."""
    ri, _, zi, _ = row_setup(grid, points)
    return build_row_plan(ri, grid.shape[0] * grid.shape[1], zi[:, 1],
                          live=ZP_LIVE_TRANSLATES, occupied_rows=True)


def interp_rows(coef2d: torch.Tensor, grid: Grid3D, points: torch.Tensor
                ) -> torch.Tensor:
    """Row-gather hybrid interpolation — one 8-row gather group per point,
    4 z taps: ``rows_value`` (kernel K2 on CUDA, K3 as its transpose), xy
    first. ``coef2d`` is ``prefilter(field)`` reshaped to (nx*ny, nz)."""
    return rows_value(coef2d, *row_setup(grid, points), xy_first=True)


def interp_rows_with_grad_ref(coef2d: torch.Tensor, grid: Grid3D,
                              points: torch.Tensor):
    """Plain PyTorch version of K6z: value + physical gradient from the
    same 8-row gather, contracted xy first against the dense Catmull–Rom
    z bands, as the reference does."""
    check_full_f32()
    bx, by, u, v, zi, fz = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    rows = coef2d[_row_index(bx, by, dx, dy, grid).long()]
    nz = grid.shape[2]
    s = torch.einsum("nkz,nk->nz", rows, wxy)
    su = torch.einsum("nkz,nk->nz", rows, wu)
    sv = torch.einsum("nkz,nk->nz", rows, wv)
    band = _z_band(zi, _catmull_rom_weights(fz), nz)
    dband = _z_band(zi, _catmull_rom_dweights(fz), nz)
    value = torch.einsum("nz,nz->n", s, band)
    du = torch.stack([
        torch.einsum("nz,nz->n", su, band),
        torch.einsum("nz,nz->n", sv, band),
        torch.einsum("nz,nz->n", s, dband),
    ], dim=-1)
    return value, du / grid.spacing[None, :]


def _merged_z_weights(zi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 4 z-tap weights w (N, 4) as the dense band holds them: where
    the clamped taps 0 and 1 (bottom) or 2 and 3 (top) are one lane, the
    second's weight is added onto the first's and the second weighs 0."""
    w = w.clone()
    for a, b in ((0, 1), (2, 3)):
        same = zi[:, a] == zi[:, b]
        w[:, a] = torch.where(same, w[:, a] + w[:, b], w[:, a])
        w[:, b] = torch.where(same, 0.0, w[:, b])
    return w


def _live_setup(grid: Grid3D, points: torch.Tensor):
    """The 7 live rows (N, 7), the z taps (N, 4), the merged z weights and
    their derivatives (N, 4) each, and the xy weights (wxy, wu, wv), (N,
    7) each, of the kernels' evaluator."""
    bx, by, u, v, zi, fz = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    live = slice(0, ZP_LIVE_TRANSLATES)
    ri = _row_index(bx, by, dx, dy, grid)[:, live]
    wz = _merged_z_weights(zi, _catmull_rom_weights(fz))
    dwz = _merged_z_weights(zi, _catmull_rom_dweights(fz))
    return ri, zi, wz, dwz, (wxy[:, live], wu[:, live], wv[:, live])


def _contract_taps(taps: torch.Tensor, wz: torch.Tensor, dwz: torch.Tensor,
                   weights, grid: Grid3D):
    """Value (N,) and physical gradient (N, 3) from the 4 z taps (N, 7, 4)
    of each point's 7 live rows, in zpc_eval.cuh's order: each tap's sums
    over the rows from zero, row by row, then the (merged) z weights tap
    by tap from zero, and the gradient divided by the spacing last."""
    wxy, wu, wv = weights
    s = su = sv = 0.0
    for k in range(ZP_LIVE_TRANSLATES):
        s = s + wxy[:, k, None] * taps[:, k]
        su = su + wu[:, k, None] * taps[:, k]
        sv = sv + wv[:, k, None] * taps[:, k]
    v = du = dv = dw = 0.0
    for l in range(4):
        v = v + wz[:, l] * s[:, l]
        du = du + wz[:, l] * su[:, l]
        dv = dv + wz[:, l] * sv[:, l]
        dw = dw + dwz[:, l] * s[:, l]
    return v, torch.stack([du, dv, dw], dim=-1) / grid.spacing[None, :]


def interp_rows_with_grad_taps_ref(coef2d: torch.Tensor, grid: Grid3D,
                                   points: torch.Tensor):
    """``interp_rows_with_grad_ref`` as K6z and K1z sum it: the 7 live
    rows' 4 z taps gathered from the table and contracted in
    zpc_eval.cuh's order (``_contract_taps``). The unpacked twin of
    ``interp_rows_with_grad_packed_ref``."""
    check_full_f32()
    ri, zi, wz, dwz, weights = _live_setup(grid, points)
    taps = coef2d[ri.long()[:, :, None], zi.long()[:, None, :]]
    return _contract_taps(taps, wz, dwz, weights, grid)


def interp_rows_with_grad_packed_ref(packed: torch.Tensor, grid: Grid3D,
                                     points: torch.Tensor):
    """``interp_rows_with_grad_taps_ref`` reading K1c's packed table
    (``core.tricubic.pack_z_taps_ref``) as K1z does: one 4-tap entry per
    live row at the point's cell base zi[:, 1]. Bitwise equal to it."""
    check_full_f32()
    ri, zi, wz, dwz, weights = _live_setup(grid, points)
    taps = packed[zi[:, 1].long()[:, None], ri.long()]
    return _contract_taps(taps, wz, dwz, weights, grid)


def interp_rows_with_grad(coef2d: torch.Tensor, grid: Grid3D,
                          points: torch.Tensor):
    """Value (N,) + physical gradient (N, 3) at points (N, 3): kernel K6z
    on CUDA, ``interp_rows_with_grad_ref`` on the CPU."""
    if points.is_cuda:
        return kernels.zpc_value_grad(coef2d, grid, points)
    return interp_rows_with_grad_ref(coef2d, grid, points)


def value_grad_transpose_terms(grid: Grid3D, points: torch.Tensor,
                               ct_value: torch.Tensor,
                               ct_grad: torch.Tensor):
    """The 7·4 scalar contributions per point of K6zᵀ and their flat table
    indices, (N·28,) each: live row t, tap l receives
    w_t·(c_v·wz_l + c_gz/h_z·dwz_l) + wu_t·c_gx/h_x·wz_l
    + wv_t·c_gy/h_y·wz_l, with the merged z weights."""
    nz = grid.shape[2]
    ri, zi, wz, dwz, (wxy, wu, wv) = _live_setup(grid, points)
    cg = ct_grad / grid.spacing[None, :]
    s_ct = ct_value[:, None] * wz + cg[:, 2:3] * dwz          # (N, 4)
    contrib = (wxy[:, :, None] * s_ct[:, None, :]
               + wu[:, :, None] * (cg[:, 0:1] * wz)[:, None, :]
               + wv[:, :, None] * (cg[:, 1:2] * wz)[:, None, :])
    flat = ri.long()[:, :, None] * nz + zi.long()[:, None, :]
    return flat.reshape(-1), contrib.reshape(-1)


def interp_rows_with_grad_transpose_ref(grid: Grid3D, points: torch.Tensor,
                                        ct_value: torch.Tensor,
                                        ct_grad: torch.Tensor
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K6zᵀ: the (nx*ny, nz) table cotangent of
    ``interp_rows_with_grad`` for a value cotangent (N,) and a gradient
    cotangent (N, 3), added in a fixed order by ``tricubic.scatter_add_``
    (reproducible on every device)."""
    nx, ny, nz = grid.shape
    flat, contrib = value_grad_transpose_terms(grid, points, ct_value,
                                               ct_grad)
    out = torch.zeros(nx * ny * nz, dtype=ct_value.dtype,
                      device=ct_value.device)
    return scatter_add_(out, flat, contrib).reshape(nx * ny, nz)


def interp_rows_with_grad_transpose_add_(table: torch.Tensor, grid: Grid3D,
                                         points: torch.Tensor,
                                         ct_value: torch.Tensor,
                                         ct_grad: torch.Tensor, plan=None
                                         ) -> torch.Tensor:
    """table += the transpose of ``interp_rows_with_grad`` with respect to
    the table, in place; returns ``table``. Kernel K6zᵀ on CUDA (over
    ``plan`` from ``endpoint_plan``, built here if not given), which reads
    and writes only the cells the stencils touch; on the CPU ``table.add_``
    of ``interp_rows_with_grad_transpose_ref``. Either way each cell is
    rounded as table + (the transpose alone)."""
    if not points.is_cuda:
        return table.add_(interp_rows_with_grad_transpose_ref(
            grid, points, ct_value, ct_grad))
    if plan is None:
        plan = endpoint_plan(grid, points)
    return kernels.zpc_value_grad_bwd(table, grid, points.contiguous(),
                                      ct_value.contiguous(),
                                      ct_grad.contiguous(), plan)


def interp(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor
           ) -> torch.Tensor:
    """Convenience wrapper over the row path for a 3-D coefficient grid."""
    nx, ny, nz = grid.shape
    return interp_rows(coef.reshape(nx * ny, nz), grid, points)


def interp_with_grad(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor):
    nx, ny, nz = grid.shape
    return interp_rows_with_grad(coef.reshape(nx * ny, nz), grid, points)
