"""C¹ Zwart–Powell box-spline interpolation (port of
``ionotomo_tpu.core.boxspline``).

    f(x, y, z) = Σ_{k,l,m} c_{k,l,m} · ZP(x−k, y−l) · β₂(z−m)

ZP in the gathered (x, y) plane — 7 live translates of the canonical
piece plus a zero-weight pad — and a quadratic B-spline along z. The
coefficient grid comes from ``prefilter`` (exact quadratic-B-spline
inverse along z, a truncated Neumann series of the ZP sample mask in
(x, y)); the evaluators take it reshaped to (nx*ny, nz).

On CUDA tensors the evaluators run the hand-written kernels: the value
path's gather-and-contract is K2 (``core.tricubic.rows_value``, with K3
as its transpose), value + gradient is K1e and its transpose with respect
to the table K1eᵀ. On CPU tensors they run the plain versions in this
module, ports of the reference's jnp code.

The transposes the linearised dTEC operator needs are written out:
``prefilter_transpose`` (the reference gets it from AD; autograd's would
scatter with atomics on the card) and
``interp_rows_with_grad_transpose`` (XLA derives it from the gather).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .grids import Grid3D
from .precision import check_full_f32
from .triquadratic import _prefilter_matrix, _qb_weights, _qb_dweights

# Per-piece translate offsets (7 + zero-weight pad) and quadratic
# coefficients over monomials (1, u, v, u², uv, v²), ×16 (exact rationals).
_ZP_DX = np.asarray(
    [[-1, -1, -1, 0, 0, 0, 1, 0], [-1, -1, 0, 0, 0, 1, 1, 0],
     [-1, -1, 0, 0, 0, 1, 1, 0], [-1, 0, 0, 0, 1, 1, 1, 0]], np.int32)
_ZP_DY = np.asarray(
    [[-1, 0, 1, -1, 0, 1, 0, 0], [-1, 0, -1, 0, 1, -1, 0, 0],
     [0, 1, -1, 0, 1, 0, 1, 0], [0, -1, 0, 1, -1, 0, 1, 0]], np.int32)
_ZP_CW = np.asarray([
    [[0, 0, 0, 4, 8, 4], [2, -8, 0, 0, 0, -8], [0, 0, 0, 4, -8, 4],
     [2, 0, -8, -4, -8, 4], [8, 0, 0, -8, 0, -8], [2, 0, 8, -4, 8, 4],
     [2, 8, 0, 8, 0, 0], [0, 0, 0, 0, 0, 0]],
    [[0, 0, 0, 4, 8, 4], [2, -8, 0, 4, -8, -4], [2, 0, -8, -8, 0, 0],
     [8, 0, 0, -8, 0, -8], [2, 0, 8, 0, 0, 8], [0, 0, 0, 4, -8, 4],
     [2, 8, 0, 4, 8, -4], [0, 0, 0, 0, 0, 0]],
    [[2, -8, 0, 4, 8, -4], [0, 0, 0, 4, -8, 4], [2, 0, -8, 0, 0, 8],
     [8, 0, 0, -8, 0, -8], [2, 0, 8, -8, 0, 0], [2, 8, 0, 4, -8, -4],
     [0, 0, 0, 4, 8, 4], [0, 0, 0, 0, 0, 0]],
    [[2, -8, 0, 8, 0, 0], [2, 0, -8, -4, 8, 4], [8, 0, 0, -8, 0, -8],
     [2, 0, 8, -4, -8, 4], [0, 0, 0, 4, -8, 4], [2, 8, 0, 0, 0, -8],
     [0, 0, 0, 4, 8, 4], [0, 0, 0, 0, 0, 0]],
], np.float32) / 16.0


#: zp translates a K3 or K1eᵀ plan holds: the 8th has weight 0 and is
#: skipped.
ZP_LIVE_TRANSLATES = 7


def _apply_a_xy(f: torch.Tensor) -> torch.Tensor:
    """The ZP integer-sample mask A over (x, y): centre 1/2, 4-neighbours
    1/8, edge-clamped (replicate) so constants are preserved at the
    boundary exactly like the interpolator's index clamp. f is
    (..., nx, ny, nz): leading axes ride along."""
    nx, ny, _ = f.shape[-3:]
    ix = torch.arange(nx, device=f.device)
    iy = torch.arange(ny, device=f.device)
    xm = f.index_select(-3, (ix - 1).clamp(min=0))
    xp = f.index_select(-3, (ix + 1).clamp(max=nx - 1))
    ym = f.index_select(-2, (iy - 1).clamp(min=0))
    yp = f.index_select(-2, (iy + 1).clamp(max=ny - 1))
    return 0.5 * f + 0.125 * (xm + xp + ym + yp)


@lru_cache(maxsize=16)
def _z_matrix(nz: int, device: torch.device) -> torch.Tensor:
    """The exact quadratic-B-spline inverse along z on ``device``, kept
    so that a solve's repeated prefilters copy nothing from the host."""
    return torch.as_tensor(_prefilter_matrix(nz), device=device)


def prefilter(field: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Field samples (..., nx, ny, nz) → box-spline coefficient grid
    (leading axes, an ensemble's members, ride along).

    z axis: exact quadratic-B-spline inverse (one dense nz×nz matmul).
    (x, y) plane: quasi-interpolation by the truncated Neumann series
    q = Σ_{j≤order} Dʲ, D = I − A (``order=2`` restores exact quadratic
    reproduction and is the default; see the reference's docstring for
    the forward/inversion trade-off of higher orders)."""
    check_full_f32()
    pz = _z_matrix(field.shape[-1], field.device)
    c = torch.einsum("ck,...k->...c", pz, field)
    acc = c
    d = c
    for _ in range(order):
        d = d - _apply_a_xy(d)
        acc = acc + d
    return acc


def prefilter_transpose(coef: torch.Tensor, order: int = 2) -> torch.Tensor:
    """Pᵀ, the transpose of ``prefilter``: a coefficient-grid cotangent
    (..., nx, ny, nz) → field cotangent. Σ_{j≤order} (I − Aᵀ)ʲ over (x, y),
    then the transposed z matmul. Written out rather than left to
    autograd: the backward of ``_apply_a_xy``'s clamped gathers is an
    ``index_put_`` with accumulation, which uses atomics on CUDA and is
    not bitwise reproducible, and truncated CG amplifies last-ulp
    differences."""
    check_full_f32()
    acc = coef
    d = coef
    for _ in range(order):
        # Aᵀ = A: the transposes of the clamped gathers f[max(i−1, 0)] and
        # f[min(i+1, n−1)] sum to the same replicate-edge pair. A forward
        # call of _apply_a_xy is a plain gather, with no atomics.
        d = d - _apply_a_xy(d)
        acc = acc + d
    pz = _z_matrix(coef.shape[-1], coef.device)
    return torch.einsum("ck,...c->...k", pz, acc)


def zp_order(interp: str) -> int:
    """Parse the ``interp`` grammar ``"zp"`` / ``"zp<order>"`` →
    xy-prefilter Neumann order (``"zp"`` ≡ ``"zp2"``). Raises on anything
    else."""
    if interp == "zp":
        return 2
    if interp.startswith("zp") and interp[2:].isdigit():
        order = int(interp[2:])
        if order >= 2:
            return order
    raise ValueError(
        f"unknown zp interp spec {interp!r} (use 'zp' or 'zp<order>=2>')")


def _neighborhood(grid: Grid3D, points: torch.Tensor):
    """Nearest-lattice setup: (N,) base per axis + signed offsets.

    Returns (bx, by, bz (N,) int32 clamped; u, v, w (N,) signed fractional
    offsets, in [−1/2, 1/2] inside and up to ±1 in the boundary cells).
    """
    t = grid.world_to_index(points)
    shape = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(shape)), shape - 1.0)
    base = torch.minimum(torch.maximum(torch.round(t),
                                       torch.ones_like(shape)), shape - 2.0)
    frac = t - base
    b = base.to(torch.int32)
    return b[:, 0], b[:, 1], b[:, 2], frac[:, 0], frac[:, 1], frac[:, 2]


def _z_band3(bz: torch.Tensor, w: torch.Tensor, nz: int) -> torch.Tensor:
    """Dense (N, nz) band with the 3 z-tap weights at bz−1, bz, bz+1."""
    lanes = torch.arange(nz, dtype=torch.int32, device=w.device)[None, :]
    band = torch.zeros((bz.shape[0], nz), dtype=w.dtype, device=w.device)
    for o in range(3):
        band = band + torch.where(lanes == (bz + (o - 1))[:, None],
                                  w[:, o][:, None], 0.0)
    return band


# Canonical-piece tables: only piece 3 (u+v>0, u−v>0) is stored for
# evaluation; the other three pieces are reached through the ZP element's
# D4 symmetry (below). _CU/_CV are the exact ∂/∂u, ∂/∂v coefficient
# tables over the reduced monomials (1, u, v). kernels/csrc/zp_eval.cuh
# bakes the same tables in as __constant__ data.
_CU = np.stack([_ZP_CW[..., 1], 2 * _ZP_CW[..., 3], _ZP_CW[..., 4]], -1)
_CV = np.stack([_ZP_CW[..., 2], _ZP_CW[..., 4], 2 * _ZP_CW[..., 5]], -1)
_DX3 = np.asarray(_ZP_DX[3], np.float32)
_DY3 = np.asarray(_ZP_DY[3], np.float32)
_CW3 = np.ascontiguousarray(_ZP_CW[3].T)                  # (6, 8)
_CU3 = np.ascontiguousarray(_CU[3].T)                     # (3, 8)
_CV3 = np.ascontiguousarray(_CV[3].T)                     # (3, 8)


def _xy_weights(u, v, with_grad: bool):
    """Translate row offsets + weights via the canonical piece.

    ZP is invariant under (u,v) → (−u,−v) and under ±90° rotation, so
    every point maps onto the canonical piece 3 (u+v>0, u−v>0) by an
    orthogonal map T with entries in {−1, 0, 1}:

        piece 3: T = I          piece 0: T = −I
        piece 1: (u,v)→(−v,u)   piece 2: (u,v)→(v,−u)

    Weights are one constant (6×8) monomial matmul in canonical
    coordinates; gradients pull back through Tᵀ and translates through
    T⁻¹ = Tᵀ.

    Returns (dx (N,8), dy (N,8), w (N,8)[, wu (N,8), wv (N,8)]).
    """
    check_full_f32()
    dev = u.device
    s1 = (u + v > 0).to(u.dtype)
    s2 = (u - v > 0).to(u.dtype)
    ne = torch.abs(s1 - s2)               # 1 where s1 != s2 (pieces 1, 2)
    sg = 2.0 * s1 - 1.0
    a11 = (1.0 - ne) * sg                 # T = [[a11, a12], [a21, a11]]
    a12 = ne * sg
    a21 = -a12
    uc = a11 * u + a12 * v
    vc = a21 * u + a11 * v
    one = torch.ones_like(u)
    mon6 = torch.stack([one, uc, vc, uc * uc, uc * vc, vc * vc], dim=-1)
    w = torch.einsum("nc,ck->nk", mon6, torch.as_tensor(_CW3, device=dev))
    dx3 = torch.as_tensor(_DX3, device=dev)
    dy3 = torch.as_tensor(_DY3, device=dev)
    dx = (a11[:, None] * dx3 + a21[:, None] * dy3).to(torch.int32)
    dy = (a12[:, None] * dx3 + a11[:, None] * dy3).to(torch.int32)
    if not with_grad:
        return dx, dy, w
    mon3 = mon6[:, :3]
    wu_c = torch.einsum("nc,ck->nk", mon3, torch.as_tensor(_CU3, device=dev))
    wv_c = torch.einsum("nc,ck->nk", mon3, torch.as_tensor(_CV3, device=dev))
    wu = a11[:, None] * wu_c + a21[:, None] * wv_c
    wv = a12[:, None] * wu_c + a11[:, None] * wv_c
    return dx, dy, w, wu, wv


def _row_index(bx, by, dx, dy, grid: Grid3D):
    nx, ny, _ = grid.shape
    ix = torch.clamp(bx[:, None] + dx, 0, nx - 1)
    iy = torch.clamp(by[:, None] + dy, 0, ny - 1)
    return ix * ny + iy                                   # (N,8) int32


def row_setup(grid: Grid3D, points: torch.Tensor):
    """What ``rows_value`` takes for the zp value at points (N, 3):
    (ri (N, 8) int32, wxy (N, 8), zi (N, 3) int32, wz (N, 3)),
    contiguous."""
    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy = _xy_weights(u, v, with_grad=False)
    ri = _row_index(bx, by, dx, dy, grid)
    zi = bz[:, None] + torch.arange(-1, 2, dtype=torch.int32,
                                    device=bz.device)[None, :]
    return (ri.contiguous(), wxy.contiguous(), zi.contiguous(),
            _qb_weights(w).contiguous())


def row_plan(ri: torch.Tensor, zi: torch.Tensor, n_rows: int):
    """The K3 plan of ``row_setup``'s pairs: the 7 live translates of each
    point, sorted within a row by the first z tap."""
    from .tricubic import build_row_plan

    return build_row_plan(ri, n_rows, zi[:, 0], live=ZP_LIVE_TRANSLATES)


def interp_rows(coef2d: torch.Tensor, grid: Grid3D, points: torch.Tensor
                ) -> torch.Tensor:
    """Row-gather box-spline interpolation — one 8-row gather group per
    point. ``coef2d`` is ``prefilter(field)`` reshaped to (nx*ny, nz).
    The point setup is torch; the gather-and-contract is
    ``core.tricubic.rows_value`` (kernel K2 on CUDA), xy-first."""
    from .tricubic import rows_value

    return rows_value(coef2d, *row_setup(grid, points), xy_first=True)


def interp_rows_with_grad_ref(coef2d: torch.Tensor, grid: Grid3D,
                              points: torch.Tensor):
    """Plain PyTorch version of K1e: value + physical gradient from the
    same 8-row gather, contracted xy-first as the reference does."""
    check_full_f32()
    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    rows = coef2d[_row_index(bx, by, dx, dy, grid).long()]
    nz = grid.shape[2]
    s = torch.einsum("nkz,nk->nz", rows, wxy)
    su = torch.einsum("nkz,nk->nz", rows, wu)
    sv = torch.einsum("nkz,nk->nz", rows, wv)
    band = _z_band3(bz, _qb_weights(w), nz)
    dband = _z_band3(bz, _qb_dweights(w), nz)
    value = torch.einsum("nz,nz->n", s, band)
    du = torch.stack([
        torch.einsum("nz,nz->n", su, band),
        torch.einsum("nz,nz->n", sv, band),
        torch.einsum("nz,nz->n", s, dband),
    ], dim=-1)
    return value, du / grid.spacing[None, :]


def interp_rows_with_grad(coef2d: torch.Tensor, grid: Grid3D,
                          points: torch.Tensor):
    """Value (N,) + physical gradient (N, 3) at points (N, 3): kernel K1e
    on CUDA, ``interp_rows_with_grad_ref`` on the CPU."""
    if points.is_cuda:
        return kernels.zp_value_grad(coef2d, grid, points)
    return interp_rows_with_grad_ref(coef2d, grid, points)


def interp_rows_with_grad_transpose_ref(grid: Grid3D, points: torch.Tensor,
                                        ct_value: torch.Tensor,
                                        ct_grad: torch.Tensor
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K1eᵀ: the (nx*ny, nz) table cotangent of
    ``interp_rows_with_grad`` for a value cotangent (N,) and a gradient
    cotangent (N, 3). Per point the 8 rows × 3 z taps receive
    wxy⊗(c_v·qb + c_gz/s_z·dqb) + wu⊗(c_gx/s_x·qb) + wv⊗(c_gy/s_y·qb),
    added by ``index_add_`` (atomics on CUDA: not bitwise reproducible
    there)."""
    nx, ny, nz = grid.shape
    flat, contrib = transpose_terms(grid, points, ct_value, ct_grad)
    out = torch.zeros(nx * ny * nz, dtype=ct_value.dtype,
                      device=ct_value.device)
    return out.index_add_(0, flat, contrib).reshape(nx * ny, nz)


def transpose_terms(grid: Grid3D, points: torch.Tensor,
                    ct_value: torch.Tensor, ct_grad: torch.Tensor):
    """The 8·3 scalar contributions per point of K1eᵀ and their flat table
    indices, (N·8·3,) each."""
    nz = grid.shape[2]
    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    ri = _row_index(bx, by, dx, dy, grid).long()
    cg = ct_grad / grid.spacing[None, :]
    qb, dqb = _qb_weights(w), _qb_dweights(w)
    s_ct = ct_value[:, None] * qb + cg[:, 2:3] * dqb        # (N, 3)
    contrib = (wxy[:, :, None] * s_ct[:, None, :]
               + wu[:, :, None] * (cg[:, 0:1] * qb)[:, None, :]
               + wv[:, :, None] * (cg[:, 1:2] * qb)[:, None, :])
    zi = bz.long()[:, None] + torch.arange(-1, 2, device=points.device)
    flat = (ri[:, :, None] * nz + zi[:, None, :]).reshape(-1)
    return flat, contrib.reshape(-1)


def endpoint_plan(grid: Grid3D, points: torch.Tensor):
    """The K1eᵀ plan of fixed points: their live (point, translate) pairs,
    ids n·8 + t, sorted by table row and first z tap and cut into
    segments (``core.tricubic.build_row_plan``)."""
    ri, _, zi, _ = row_setup(grid, points)
    return row_plan(ri, zi, grid.shape[0] * grid.shape[1])


def interp_rows_with_grad_transpose(grid: Grid3D, points: torch.Tensor,
                                    ct_value: torch.Tensor,
                                    ct_grad: torch.Tensor, plan=None
                                    ) -> torch.Tensor:
    """Transpose of ``interp_rows_with_grad`` with respect to the table:
    kernel K1eᵀ on CUDA (over ``plan`` from ``endpoint_plan``, built here
    if not given), ``interp_rows_with_grad_transpose_ref`` on the CPU."""
    if not points.is_cuda:
        return interp_rows_with_grad_transpose_ref(grid, points, ct_value,
                                                   ct_grad)
    if plan is None:
        plan = endpoint_plan(grid, points)
    return kernels.zp_value_grad_bwd(grid, points.contiguous(),
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
