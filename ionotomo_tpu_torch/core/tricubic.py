"""The row-gather value map and its transpose (port of ``rows_value`` from
``ionotomo_tpu.core.tricubic``).

``rows_value`` is the JAX package's custom primitive ``rows_value_p``:
out[n] = Σ_k wxy[n,k] Σ_l wz[n,l] · table[ri[n,k], zi[n,l]], as a
``torch.autograd.Function`` whose backward with respect to the table is
the hand-written transpose ``_rows_value_transpose`` (its unbatched
dense-row branch). On CUDA tensors the forward is kernel K2 and the
backward kernel K3; on CPU tensors they are ``rows_value_ref`` and
``rows_value_transpose_ref``.

K3 reduces each table row over the (point, row) pairs that land on it, in
a fixed order, so the transpose is bitwise reproducible. The order is a
plan (``build_row_plan``): the pairs sorted by row once for a point set,
and reused while the points stay fixed (a whole straight-ray solve).

Not ported yet: the member-axis batching rule and the batched transpose
(ROADMAP.md Queue 2, K3 batched; the EnKF), gradients with respect to the
weights, and the tricubic field model itself (Queue 1 item 6; K5).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from .precision import check_full_f32


def _z_band(idx_z: torch.Tensor, w: torch.Tensor, nz: int) -> torch.Tensor:
    """Dense (N, nz) vector with w[:, o] at positions idx_z[:, o]."""
    lanes = torch.arange(nz, dtype=torch.int32, device=w.device)[None, :]
    band = torch.zeros((idx_z.shape[0], nz), dtype=w.dtype, device=w.device)
    for o in range(w.shape[1]):
        band = band + torch.where(lanes == idx_z[:, o][:, None],
                                  w[:, o][:, None], 0.0)
    return band


def rows_value_ref(table, ri, wxy, zi, wz, xy_first: bool) -> torch.Tensor:
    """Plain PyTorch version of K2: the unbatched branch of the
    reference's ``_rows_value_impl`` (whole rows gathered, contracted
    against a dense z band)."""
    check_full_f32()
    nz = table.shape[-1]
    rows = table[ri.long()]                              # (N,K,nz)
    band = _z_band(zi, wz, nz)                           # (N,nz)
    if xy_first:    # the box spline's order
        s = torch.einsum("nkz,nk->nz", rows, wxy)
        return torch.einsum("nz,nz->n", s, band)
    pencil = torch.einsum("nkz,nz->nk", rows, band)     # tricubic order
    return torch.sum(pencil * wxy, dim=-1)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The (point, translate) pairs of a point set grouped by table row.

    order:   (N·K,) int32 flat pair ids n·K + k, sorted by row (stable, so
             ascending within a row);
    offsets: (n_rows + 1,) int32, row r's pairs are order[offsets[r]:
             offsets[r+1]]. Pairs whose row lies outside [0, n_rows) are
             in no group and so dropped.
    """

    order: torch.Tensor
    offsets: torch.Tensor


def build_row_plan(ri: torch.Tensor, n_rows: int) -> RowPlan:
    """Sort the flat pairs of row indices ri (N, K) by row: one stable
    sort and one search, on ri's device."""
    rows = ri.reshape(-1)
    sorted_rows, order = torch.sort(rows, stable=True)
    bounds = torch.arange(n_rows + 1, dtype=sorted_rows.dtype,
                          device=rows.device)
    offsets = torch.searchsorted(sorted_rows, bounds, out_int32=True)
    return RowPlan(order=order.to(torch.int32), offsets=offsets)


def rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape
                             ) -> torch.Tensor:
    """Plain PyTorch version of K3: table_ct[ri[n,k], zi[n,l]] +=
    ct[n]·wxy[n,k]·wz[n,l] by ``index_add_`` of the K·L scalar
    contributions per point (on CUDA ``index_add_`` uses atomics, so this
    version is not bitwise reproducible there). Contributions at rows or
    z outside the table are dropped, as in the reference."""
    n_rows, nz = table_shape
    contrib = (ct[:, None, None] * wxy[:, :, None]) * wz[:, None, :]
    r = ri.long()[:, :, None]
    z = zi.long()[:, None, :]
    inside = (r >= 0) & (r < n_rows) & (z >= 0) & (z < nz)
    flat = torch.where(inside, r * nz + z, 0).reshape(-1)
    contrib = torch.where(inside, contrib, 0.0).reshape(-1)
    out = torch.zeros(n_rows * nz, dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, flat, contrib).reshape(n_rows, nz)


def rows_value_transpose(ct, ri, wxy, zi, wz, table_shape,
                         plan: RowPlan | None = None) -> torch.Tensor:
    """Transpose of ``rows_value`` with respect to the table: kernel K3
    on CUDA (over ``plan``, built here if not given), the plain version
    on the CPU."""
    if not ct.is_cuda:
        return rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape)
    if plan is None:
        plan = build_row_plan(ri, table_shape[0])
    return kernels.rows_value_bwd(ct.contiguous(), plan.order, plan.offsets,
                                  wxy.contiguous(), zi.contiguous(),
                                  wz.contiguous(), *table_shape)


class _RowsValue(torch.autograd.Function):
    """``rows_value_p`` with its hand-written transpose as the backward
    (with respect to the table only, like the reference's)."""

    @staticmethod
    def forward(ctx, table, ri, wxy, zi, wz, xy_first, plan):
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[4]:
            raise NotImplementedError(
                "rows_value: gradients with respect to the weights are not "
                "ported (the reference falls back to its derived AD there)")
        ctx.save_for_backward(ri, wxy, zi, wz)
        ctx.table_shape = tuple(table.shape)
        ctx.plan = plan
        if table.is_cuda:
            return kernels.rows_value_fwd(table, ri, wxy, zi, wz, xy_first)
        return rows_value_ref(table, ri, wxy, zi, wz, xy_first)

    @staticmethod
    def backward(ctx, ct):
        ri, wxy, zi, wz = ctx.saved_tensors
        table_ct = rows_value_transpose(ct, ri, wxy, zi, wz, ctx.table_shape,
                                        ctx.plan)
        return table_ct, None, None, None, None, None, None


def rows_value(table, ri, wxy, zi, wz, xy_first: bool,
               plan: RowPlan | None = None) -> torch.Tensor:
    """Row-gather value map, differentiable in the table. table (R, nz);
    ri (N, K) int32; wxy (N, K); zi (N, L) int32; wz (N, L) → (N,).
    Kernel K2 forward and K3 backward on CUDA (``plan``: the pairs of
    ``ri`` sorted by row, built at the first backward if not given);
    ``rows_value_ref`` and ``rows_value_transpose_ref`` on the CPU."""
    return _RowsValue.apply(table, ri, wxy, zi, wz, xy_first, plan)
