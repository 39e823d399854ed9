"""C¹ triquadratic B-spline interpolation, ``interp="quadratic"`` (port of
``ionotomo_tpu.core.triquadratic``), and the quadratic B-spline pieces
the box spline shares.

The table holds the field's B-spline coefficients c, from ``prefilter``
(the exact inverse of (c_{j-1} + 6 c_j + c_{j+1})/8 = f_j along each axis,
three dense f32 matmuls), never the raw samples; the evaluators take it
reshaped to (nx*ny, nz). A point's stencil is 3×3 rows × 3 z taps about
its nearest lattice point (9 row gathers).

On CUDA tensors ``interp_rows`` is ``core.tricubic.rows_value`` at K=9,
L=3, z first (K2's generic kernel), and ``interp_rows_with_grad`` kernel
K6q; on CPU tensors the plain versions in this module.
``interp_rows_with_grad_taps_ref`` is K6q's and K1q's evaluator summed in
the kernels' order, and ``interp_rows_with_grad_packed_ref`` K1q's
evaluator over K1's z-tap pack (``core.boxspline.pack_z_taps_ref``: the
quadratic z stencil is the zp one), bitwise equal to that twin.

The reference has no operator on this model (``forward.tec`` raises
ValueError for it, ``core.field_models``), so there is no transpose here.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .grids import Grid3D
from .precision import check_full_f32


@lru_cache(maxsize=64)
def _prefilter_matrix(n: int) -> np.ndarray:
    """Exact inverse of the 1-D interpolation system (f64 → f32, cached).

    Interior rows (c_{j-1} + 6 c_j + c_{j+1})/8 = f_j; boundary rows are
    the identity (linear-extrapolation closure). The inverse of the
    diagonally-dominant tridiagonal system is dense with geometrically
    decaying off-diagonals. The cached array is shared: callers copy it
    into a tensor and never write to it.
    """
    if n < 3:
        return np.eye(n, dtype=np.float32)
    B = np.zeros((n, n), np.float64)
    B[0, 0] = 1.0
    B[n - 1, n - 1] = 1.0
    idx = np.arange(1, n - 1)
    B[idx, idx - 1] = 1.0 / 8.0
    B[idx, idx] = 6.0 / 8.0
    B[idx, idx + 1] = 1.0 / 8.0
    return np.linalg.inv(B).astype(np.float32)


def _qb_weights(u: torch.Tensor) -> torch.Tensor:
    """Quadratic B-spline weights for offsets (-1, 0, 1); (..., 3)."""
    return torch.stack([
        0.5 * (0.5 - u) ** 2,
        0.75 - u * u,
        0.5 * (0.5 + u) ** 2,
    ], dim=-1)


def _qb_dweights(u: torch.Tensor) -> torch.Tensor:
    """d/du of the quadratic B-spline weights; (..., 3)."""
    return torch.stack([u - 0.5, -2.0 * u, u + 0.5], dim=-1)


@lru_cache(maxsize=16)
def _matrix(n: int, device: torch.device) -> torch.Tensor:
    """``_prefilter_matrix(n)`` on ``device``, kept so that repeated
    prefilters copy nothing from the host."""
    return torch.as_tensor(_prefilter_matrix(n), device=device)


def prefilter(field: torch.Tensor) -> torch.Tensor:
    """Field samples (..., nx, ny, nz) → B-spline coefficient grid, same
    shape (leading axes ride along). Three dense per-axis matmuls in full
    f32."""
    check_full_f32()
    nx, ny, nz = field.shape[-3:]
    dev = field.device
    c = torch.einsum("ai,...ijk->...ajk", _matrix(nx, dev), field)
    c = torch.einsum("bj,...ajk->...abk", _matrix(ny, dev), c)
    return torch.einsum("ck,...abk->...abc", _matrix(nz, dev), c)


def _neighborhood(grid: Grid3D, points: torch.Tensor):
    """Per-axis 3-point stencil indices and signed offsets: points (N, 3)
    → (idx (N, 3, 3) int32, frac (N, 3), the offset from the nearest
    sample, in [-0.5, 0.5] inside and up to ±1 in the clamped boundary
    half-cells)."""
    t = grid.world_to_index(points)
    shape = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(shape)), shape - 1.0)
    base = torch.minimum(torch.maximum(torch.round(t),
                                       torch.ones_like(shape)), shape - 2.0)
    frac = t - base
    offsets = torch.arange(-1, 2, dtype=torch.int32, device=t.device)
    idx = base.to(torch.int32)[..., None] + offsets             # (N, 3, 3)
    return idx, frac


def _block_setup(grid: Grid3D, points: torch.Tensor):
    """Flat voxel indices (N, 3, 3, 3) of each point's stencil, and the
    weights of the coefficient at each."""
    idx, frac = _neighborhood(grid, points)
    _, ny, nz = grid.shape
    flat = ((idx[:, 0, :, None, None] * ny + idx[:, 1, None, :, None]) * nz
            + idx[:, 2, None, None, :])
    wx, wy, wz = (_qb_weights(frac[:, d]) for d in range(3))
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return flat, w


def interp(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor
           ) -> torch.Tensor:
    """Triquadratic interpolation of a coefficient grid at points (N, 3)
    by the 27-scalar block gather (plain PyTorch on every device; the
    obviously-correct twin of the row path)."""
    flat, w = _block_setup(grid, points)
    blocks = coef.reshape(-1)[flat.long()]
    return torch.sum(blocks * w, dim=(1, 2, 3))


def _row_neighborhood(grid: Grid3D, points: torch.Tensor):
    """``_neighborhood`` plus the 9 (x, y) z-pencil rows of each point,
    (N, 9) int32, x-major."""
    idx, frac = _neighborhood(grid, points)
    ny = grid.shape[1]
    row_idx = idx[:, 0, :, None] * ny + idx[:, 1, None, :]     # (N, 3, 3)
    return idx, frac, row_idx.reshape(points.shape[0], 9)


def _z_band(idx_z: torch.Tensor, w: torch.Tensor, nz: int) -> torch.Tensor:
    """Dense (N, nz) vector with w[:, o] at positions idx_z[:, o]."""
    lanes = torch.arange(nz, dtype=torch.int32, device=w.device)[None, :]
    band = torch.zeros((idx_z.shape[0], nz), dtype=w.dtype, device=w.device)
    for o in range(3):
        band = band + torch.where(lanes == idx_z[:, o][:, None],
                                  w[:, o][:, None], 0.0)
    return band


def row_setup(grid: Grid3D, points: torch.Tensor):
    """What ``rows_value`` takes for the triquadratic value at points (N,
    3): (ri (N, 9) int32, wxy (N, 9), zi (N, 3) int32, wz (N, 3)),
    contiguous."""
    idx, frac, ri = _row_neighborhood(grid, points)
    wx = _qb_weights(frac[:, 0])
    wy = _qb_weights(frac[:, 1])
    wxy = (wx[:, :, None] * wy[:, None, :]).reshape(-1, 9)
    return (ri.contiguous(), wxy.contiguous(), idx[:, 2].contiguous(),
            _qb_weights(frac[:, 2]).contiguous())


def interp_rows(coef2d: torch.Tensor, grid: Grid3D, points: torch.Tensor
                ) -> torch.Tensor:
    """Row-gather triquadratic interpolation of the (nx*ny, nz) coefficient
    table at points (N, 3): ``rows_value`` over 9 pencils × 3 taps, z first
    (the reference's pencil sums, then the wxy sum; K2 on CUDA)."""
    from .tricubic import rows_value

    return rows_value(coef2d, *row_setup(grid, points), xy_first=False)


def interp_rows_with_grad_ref(coef2d: torch.Tensor, grid: Grid3D,
                              points: torch.Tensor):
    """Plain PyTorch version of K6q: value + physical gradient from the 9
    gathered pencils, z contracted first against the dense weight and
    derivative-weight bands, then y, then x, as the reference does."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    nz = grid.shape[2]
    rows = coef2d[row_idx.long()]                               # (N, 9, nz)
    wz_band = _z_band(idx[:, 2], _qb_weights(frac[:, 2]), nz)
    dwz_band = _z_band(idx[:, 2], _qb_dweights(frac[:, 2]), nz)
    cz = torch.einsum("nkz,nz->nk", rows, wz_band).reshape(-1, 3, 3)
    cz_d = torch.einsum("nkz,nz->nk", rows, dwz_band).reshape(-1, 3, 3)
    wx, wy = _qb_weights(frac[:, 0]), _qb_weights(frac[:, 1])
    dwx, dwy = _qb_dweights(frac[:, 0]), _qb_dweights(frac[:, 1])
    czy = torch.einsum("nxy,ny->nx", cz, wy)
    czy_dy = torch.einsum("nxy,ny->nx", cz, dwy)
    czy_dz = torch.einsum("nxy,ny->nx", cz_d, wy)
    value = torch.einsum("nx,nx->n", czy, wx)
    du = torch.stack([
        torch.einsum("nx,nx->n", czy, dwx),
        torch.einsum("nx,nx->n", czy_dy, wx),
        torch.einsum("nx,nx->n", czy_dz, wx),
    ], dim=-1)
    return value, du / grid.spacing[None, :]


def _contract_taps(taps: torch.Tensor, frac: torch.Tensor, grid: Grid3D):
    """Value (N,) and physical gradient (N, 3) from the 3×3×3 taps (N, x,
    y, z) of each point, in quad_eval.cuh's order: each row's z sums from
    zero, tap by tap, then y, then x, each a running sum, and the gradient
    divided by the spacing last."""
    wx, wy, wz = (_qb_weights(frac[:, d]) for d in range(3))
    dwx, dwy, dwz = (_qb_dweights(frac[:, d]) for d in range(3))
    cz = cz_d = 0.0
    for l in range(3):
        cz = cz + taps[..., l] * wz[:, None, None, l]
        cz_d = cz_d + taps[..., l] * dwz[:, None, None, l]
    czy = czy_dy = czy_dz = 0.0
    for b in range(3):
        czy = czy + cz[:, :, b] * wy[:, None, b]
        czy_dy = czy_dy + cz[:, :, b] * dwy[:, None, b]
        czy_dz = czy_dz + cz_d[:, :, b] * wy[:, None, b]
    v = dx = dy = dz = 0.0
    for a in range(3):
        v = v + czy[:, a] * wx[:, a]
        dx = dx + czy[:, a] * dwx[:, a]
        dy = dy + czy_dy[:, a] * wx[:, a]
        dz = dz + czy_dz[:, a] * wx[:, a]
    return v, torch.stack([dx, dy, dz], dim=-1) / grid.spacing[None, :]


def interp_rows_with_grad_taps_ref(coef2d: torch.Tensor, grid: Grid3D,
                                   points: torch.Tensor):
    """``interp_rows_with_grad_ref`` as K6q and K1q sum it: the 9 rows' 3
    z taps gathered from the table and contracted in quad_eval.cuh's order
    (``_contract_taps``). The unpacked twin of
    ``interp_rows_with_grad_packed_ref``."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    taps = coef2d[row_idx.long()[:, :, None], idx[:, 2].long()[:, None, :]]
    return _contract_taps(taps.reshape(-1, 3, 3, 3), frac, grid)


def interp_rows_with_grad_packed_ref(packed: torch.Tensor, grid: Grid3D,
                                     points: torch.Tensor):
    """``interp_rows_with_grad_taps_ref`` reading K1's packed table
    (``core.boxspline.pack_z_taps_ref``) as K1q does: one entry per row at
    the point's z base. Bitwise equal to it."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    taps = packed[(idx[:, 2, 1] - 1).long()[:, None], row_idx.long()]
    return _contract_taps(taps[..., :3].reshape(-1, 3, 3, 3), frac, grid)


def interp_rows_with_grad(coef2d: torch.Tensor, grid: Grid3D,
                          points: torch.Tensor):
    """Value (N,) + physical gradient (N, 3) at points (N, 3): kernel K6q
    on CUDA, ``interp_rows_with_grad_ref`` on the CPU."""
    if points.is_cuda:
        return kernels.quad_value_grad(coef2d, grid, points)
    return interp_rows_with_grad_ref(coef2d, grid, points)


def interp_with_grad(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor):
    """Value and physical gradient from a coefficient grid."""
    nx, ny, nz = grid.shape
    return interp_rows_with_grad(coef.reshape(nx * ny, nz), grid, points)


def interp_weights(grid: Grid3D, points: torch.Tensor):
    """(flat voxel indices (N, 27) int32, weights (N, 27)) of the stencil,
    which apply to the coefficient grid: ``interp(coef, grid, pts) ==
    (coef.reshape(-1)[idx] * w).sum(-1)``."""
    flat, w = _block_setup(grid, points)
    n = points.shape[0]
    return flat.reshape(n, 27), w.reshape(n, 27)
