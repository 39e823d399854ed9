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
plan (``build_row_plan``): the pairs sorted by row and z once for a point
set and cut into segments of at most ``SEGMENT_PAIRS``, reused while the
points stay fixed (a whole straight-ray solve).

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


#: Pairs one K3 / K1eᵀ segment holds at most: one warp reduces one
#: segment, so no warp's work depends on how many pairs share a row.
SEGMENT_PAIRS = 256


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The (point, translate) pairs of a point set grouped by table row,
    cut into segments of at most ``chunk`` pairs.

    order:    (N·live,) int32 flat pair ids n·stride + k, k < live, sorted
              by (row, z0[n]) (stable, so by id within a tie);
    offsets:  (n_rows + 1,) int32, row r's pairs are order[offsets[r]:
              offsets[r+1]]. Pairs whose row lies outside [0, n_rows) are
              in no group and so dropped;
    row_seg:  (n_rows + 1,) int32, row r's segments are row_seg[r] ..
              row_seg[r+1] − 1; segment j of row r holds its pairs
              offsets[r] + j·chunk onwards, and every row (an empty one
              too) has at least one;
    seg_row:  (n_seg_max,) int32, the row of each segment; n_rows past
              the last one. n_seg_max = ⌈N·live / chunk⌉ + n_rows bounds
              the count, so building the plan reads nothing back to the
              host;
    counters: (n_rows,) int32 zeros, the kernels' per-row tickets; each
              call leaves them at zero again (only a kernel that faults
              midway leaves them set, and a fault leaves the CUDA context
              unusable, so no later call reads them);
    stream:   the CUDA stream the plan was built on (its handle; None on
              the CPU). The kernels take the plan only on that stream, so
              no two calls share its counters at once.
    """

    order: torch.Tensor
    offsets: torch.Tensor
    row_seg: torch.Tensor
    seg_row: torch.Tensor
    counters: torch.Tensor
    stride: int
    live: int
    chunk: int
    stream: int | None

    @property
    def n_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n_seg_max(self) -> int:
        return self.seg_row.shape[0]


def build_row_plan(ri: torch.Tensor, n_rows: int, z0: torch.Tensor = None,
                   live: int = None, chunk: int = SEGMENT_PAIRS) -> RowPlan:
    """The plan of the pairs of row indices ri (N, K): the first ``live``
    (default K) translates of each point, sorted by row and, within a
    row, by the point's first z tap ``z0`` (N,) (so the pairs that add
    into one z element are neighbours), then cut into segments of at most
    ``chunk`` pairs. One sort and two searches on ri's device, no host
    read."""
    n, stride = ri.shape
    live = stride if live is None else live
    dev = ri.device
    ids = (torch.arange(n, dtype=torch.int64, device=dev)[:, None] * stride
           + torch.arange(live, dtype=torch.int64, device=dev)[None, :])
    key = ri[:, :live].to(torch.int64) << 32
    if z0 is not None:
        key = key + (z0.to(torch.int64)[:, None] + 2 ** 31)
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    bounds = torch.arange(n_rows + 1, dtype=torch.int64, device=dev) << 32
    offsets = torch.searchsorted(sorted_key, bounds, out_int32=True)
    counts = offsets[1:] - offsets[:-1]
    n_seg = torch.clamp_min((counts + (chunk - 1)) // chunk, 1)
    seg_end = torch.cumsum(n_seg, 0, dtype=torch.int32)
    row_seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         seg_end])
    n_seg_max = -(-n * live // chunk) + n_rows
    seg_row = torch.searchsorted(
        seg_end, torch.arange(n_seg_max, dtype=torch.int32, device=dev),
        right=True, out_int32=True)
    return RowPlan(order=ids.reshape(-1)[perm].to(torch.int32),
                   offsets=offsets, row_seg=row_seg, seg_row=seg_row,
                   counters=torch.zeros(n_rows, dtype=torch.int32,
                                        device=dev),
                   stride=stride, live=live, chunk=chunk,
                   stream=(torch.cuda.current_stream(dev).cuda_stream
                           if dev.type == "cuda" else None))


def rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape
                             ) -> torch.Tensor:
    """Plain PyTorch version of K3: table_ct[ri[n,k], zi[n,l]] +=
    ct[n]·wxy[n,k]·wz[n,l] by ``index_add_`` of the K·L scalar
    contributions per point (on CUDA ``index_add_`` uses atomics, so this
    version is not bitwise reproducible there). Contributions at rows or
    z outside the table are dropped, as in the reference."""
    n_rows, nz = table_shape
    flat, contrib = transpose_terms(ct, ri, wxy, zi, wz, table_shape)
    out = torch.zeros(n_rows * nz, dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, flat, contrib).reshape(n_rows, nz)


def transpose_terms(ct, ri, wxy, zi, wz, table_shape):
    """The K·L scalar contributions per point of the transpose and their
    flat table indices, (N·K·L,) each; those outside the table are 0 at
    index 0."""
    n_rows, nz = table_shape
    contrib = (ct[:, None, None] * wxy[:, :, None]) * wz[:, None, :]
    r = ri.long()[:, :, None]
    z = zi.long()[:, None, :]
    inside = (r >= 0) & (r < n_rows) & (z >= 0) & (z < nz)
    flat = torch.where(inside, r * nz + z, 0).reshape(-1)
    return flat, torch.where(inside, contrib, 0.0).reshape(-1)


def rows_value_transpose(ct, ri, wxy, zi, wz, table_shape,
                         plan: RowPlan | None = None) -> torch.Tensor:
    """Transpose of ``rows_value`` with respect to the table: kernel K3
    on CUDA (over ``plan``, built here if not given), the plain version
    on the CPU."""
    if not ct.is_cuda:
        return rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape)
    if plan is None:
        plan = build_row_plan(ri, table_shape[0], zi[:, 0])
    return kernels.rows_value_bwd(ct.contiguous(), plan, wxy.contiguous(),
                                  zi.contiguous(), wz.contiguous(),
                                  table_shape[1])


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
