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
as its transpose; ``point_order`` the order K2 runs a fixed point set
in), value + gradient is K1e (``interp_rows_with_grad_batched``: over
the tables of an ensemble's members, one launch) and its transpose with
respect to the table K1eᵀ. On CPU tensors they run the plain versions in
this module, ports of the reference's jnp code. ``interp_rows_with_grad_taps_ref`` is K1e's and
K1's evaluator summed in the kernels' order, and ``pack_z_taps_ref`` and
``interp_rows_with_grad_packed_ref`` the plain versions of K1's
z-tap-packed table and its evaluator, bitwise equal to that twin.

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
from .tricubic import check_pack, scatter_add_
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


def base_cell(grid: Grid3D, points: torch.Tensor):
    """The index-space query t (N, 3), clamped into the grid, and the
    nearest lattice point (N, 3) f32, rounded half to even and clamped to
    [1, n−2]; ``_neighborhood``'s and the point order's key's
    (``kernels.point_order_keys``, rule ``POINT_RULE``)."""
    t = grid.world_to_index(points)
    shape = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(shape)), shape - 1.0)
    return t, torch.minimum(torch.maximum(torch.round(t),
                                          torch.ones_like(shape)),
                            shape - 2.0)


def _neighborhood(grid: Grid3D, points: torch.Tensor):
    """Nearest-lattice setup: (N,) base per axis + signed offsets.

    Returns (bx, by, bz (N,) int32 clamped; u, v, w (N,) signed fractional
    offsets, in [−1/2, 1/2] inside and up to ±1 in the boundary cells).
    """
    t, base = base_cell(grid, points)
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


#: The translate whose row is the base cell's in every piece: (0, 0).
BASE_TRANSLATE = 2
#: ``base_cell``'s rule in the key kernel (``kernels.POINT_RULES``).
POINT_RULE = "zp"


def point_order(grid: Grid3D, points, ri, wxy, zi, wz):
    """K2's order of ``row_setup(grid, points)``, by their base cell
    (``core.tricubic.PointOrder``)."""
    from .tricubic import build_point_order

    return build_point_order(grid, points, POINT_RULE, base_cell, ri, wxy,
                             zi, wz)


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


def _contract_taps(taps: torch.Tensor, w: torch.Tensor, weights,
                   grid: Grid3D):
    """Value (N,) and physical gradient (N, 3) from the 3 z taps (N, 7, 3)
    of each point's 7 live rows, its z offset w (N,) and its (wxy, wu, wv)
    (N, 7) each, in zp_eval.cuh's order: each z tap's sums over the rows
    from zero, row by row, then the z weights, and the gradient divided by
    the spacing last."""
    wxy, wu, wv = weights
    s = su = sv = 0.0
    for k in range(ZP_LIVE_TRANSLATES):
        s = s + wxy[:, k, None] * taps[:, k]
        su = su + wu[:, k, None] * taps[:, k]
        sv = sv + wv[:, k, None] * taps[:, k]
    wz, dwz = _qb_weights(w), _qb_dweights(w)

    def dot3(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    du = torch.stack([dot3(wz, su), dot3(wz, sv), dot3(dwz, s)], dim=-1)
    return dot3(wz, s), du / grid.spacing[None, :]


def _live_setup(grid: Grid3D, points: torch.Tensor):
    """The 7 live rows (N, 7), the z base (N,), its offset w and the
    weights (wxy, wu, wv), each (N, 7), of K1's evaluator."""
    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    live = slice(0, ZP_LIVE_TRANSLATES)
    ri = _row_index(bx, by, dx, dy, grid)[:, live]
    return ri, bz, w, (wxy[:, live], wu[:, live], wv[:, live])


def interp_rows_with_grad_taps_ref(coef2d: torch.Tensor, grid: Grid3D,
                                   points: torch.Tensor):
    """``interp_rows_with_grad_ref`` as K1e and K1 sum it: the 7 live
    rows' 3 z taps gathered from the table and contracted in zp_eval.cuh's
    order (``_contract_taps``). The unpacked twin of
    ``interp_rows_with_grad_packed_ref``."""
    check_full_f32()
    ri, bz, w, weights = _live_setup(grid, points)
    z = bz[:, None] + torch.arange(-1, 2, dtype=torch.int32, device=bz.device)
    taps = coef2d[ri.long()[:, :, None], z.long()[:, None, :]]
    return _contract_taps(taps, w, weights, grid)


def pack_z_taps_ref(coef2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1's pack (``kernels.pack_zp_taps``): the
    (nz−2, nx*ny, 4) table of the three z taps (b−1, b, b+1) and a zero of
    every row at every z base b in [1, nz−2], base-major."""
    nz = coef2d.shape[-1]
    b = torch.arange(1, nz - 1, device=coef2d.device)
    taps = coef2d[:, torch.stack([b - 1, b, b + 1], -1)]    # (R, nz-2, 3)
    pad = torch.zeros(taps.shape[:2] + (1,), dtype=taps.dtype,
                      device=taps.device)
    return torch.cat([taps, pad], -1).permute(1, 0, 2).contiguous()


def interp_rows_with_grad_packed_ref(packed: torch.Tensor, grid: Grid3D,
                                     points: torch.Tensor):
    """``interp_rows_with_grad_taps_ref`` reading the packed table
    (``pack_z_taps_ref``) as K1 does: one 4-float entry per live row at
    the point's z base. Bitwise equal to it."""
    check_full_f32()
    ri, bz, w, weights = _live_setup(grid, points)
    taps = packed[(bz - 1).long()[:, None], ri.long()][..., :3]
    return _contract_taps(taps, w, weights, grid)


def interp_rows_with_grad(coef2d: torch.Tensor, grid: Grid3D,
                          points: torch.Tensor):
    """Value (N,) + physical gradient (N, 3) at points (N, 3): kernel K1e
    on CUDA, ``interp_rows_with_grad_ref`` on the CPU."""
    if points.is_cuda:
        return kernels.zp_value_grad(coef2d, grid, points)
    return interp_rows_with_grad_ref(coef2d, grid, points)


def interp_rows_with_grad_batched_ref(table: torch.Tensor, grid: Grid3D,
                                      points: torch.Tensor):
    """Plain PyTorch version of the batched K1e: ``interp_rows_with_grad_ref``
    on each member's table of ``table`` (B, nx*ny, nz), stacked → value
    (B, N), gradient (B, N, 3)."""
    vals, grads = zip(*(interp_rows_with_grad_ref(t, grid, points)
                        for t in table))
    return torch.stack(vals), torch.stack(grads)


def interp_rows_with_grad_batched(table: torch.Tensor, grid: Grid3D,
                                  points: torch.Tensor, pack=None):
    """``interp_rows_with_grad`` on each member's table of ``table`` (B,
    nx*ny, nz): the batched K1e on CUDA, one launch for all members, over
    ``pack`` (the table's ``tricubic.member_pack``, shared with K2b's
    gather) or a pack of its own; ``interp_rows_with_grad_batched_ref`` on
    the CPU. Member b is bitwise ``interp_rows_with_grad(table[b], ...)``
    on either."""
    packed = check_pack(pack, table, "interp_rows_with_grad_batched")
    if points.is_cuda:
        return kernels.zp_value_grad_batched(table, grid, points, packed)
    return interp_rows_with_grad_batched_ref(table, grid, points)


def interp_rows_with_grad_transpose_ref(grid: Grid3D, points: torch.Tensor,
                                        ct_value: torch.Tensor,
                                        ct_grad: torch.Tensor
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K1eᵀ: the (nx*ny, nz) table cotangent of
    ``interp_rows_with_grad`` for a value cotangent (N,) and a gradient
    cotangent (N, 3). Per point the 8 rows × 3 z taps receive
    wxy⊗(c_v·qb + c_gz/s_z·dqb) + wu⊗(c_gx/s_x·qb) + wv⊗(c_gy/s_y·qb),
    added by ``tricubic.scatter_add_`` (reproducible on every device)."""
    nx, ny, nz = grid.shape
    flat, contrib = transpose_terms(grid, points, ct_value, ct_grad)
    out = torch.zeros(nx * ny * nz, dtype=ct_value.dtype,
                      device=ct_value.device)
    return scatter_add_(out, flat, contrib).reshape(nx * ny, nz)


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


def interp_rows_with_grad_transpose_add_(table: torch.Tensor, grid: Grid3D,
                                         points: torch.Tensor,
                                         ct_value: torch.Tensor,
                                         ct_grad: torch.Tensor, plan=None
                                         ) -> torch.Tensor:
    """table += ``interp_rows_with_grad_transpose(...)``, in place;
    returns ``table``. K1eᵀ writes a whole table, which is then added."""
    return table.add_(interp_rows_with_grad_transpose(grid, points, ct_value,
                                                      ct_grad, plan))


def interp(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor
           ) -> torch.Tensor:
    """Convenience wrapper over the row path for a 3-D coefficient grid."""
    nx, ny, nz = grid.shape
    return interp_rows(coef.reshape(nx * ny, nz), grid, points)


def interp_with_grad(coef: torch.Tensor, grid: Grid3D, points: torch.Tensor):
    nx, ny, nz = grid.shape
    return interp_rows_with_grad(coef.reshape(nx * ny, nz), grid, points)
