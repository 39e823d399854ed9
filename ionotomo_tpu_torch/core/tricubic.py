"""The row-gather value map ``rows_value`` with its transpose, and the
Catmull-Rom tricubic field model built on it (port of
``ionotomo_tpu.core.tricubic``).

``rows_value`` is the JAX package's custom primitive ``rows_value_p``:
out[n] = Σ_k wxy[n,k] Σ_l wz[n,l] · table[ri[n,k], zi[n,l]], as a
``torch.autograd.Function`` whose backward with respect to the table is
the hand-written transpose ``_rows_value_transpose`` (its unbatched
dense-row branch). On CUDA tensors the forward is kernel K2 and the
backward kernel K3; on CPU tensors they are ``rows_value_ref`` and
``rows_value_transpose_ref``. A caller that holds a point set fixed keeps
K2's order of it (``point_order``, a ``PointOrder``: the points sorted by
their stencil's base cell, so that a warp shares rows, with their inputs
permuted into that order), beside K3's plan.

K3 reduces each table row over the (point, row) pairs that land on it, in
a fixed order, so the transpose is bitwise reproducible. The order is a
plan (``build_row_plan``): the pairs sorted by row and z once for a point
set and cut into segments of at most ``SEGMENT_PAIRS``, reused while the
points stay fixed (a whole straight-ray solve).

The tricubic model (separable cubic convolution over a 4×4×4
neighbourhood, edge-clamped, no prefilter: the table is the field
reshaped to (nx*ny, nz)): ``interp_rows`` is ``rows_value`` at K=16, L=4,
z first; ``interp_rows_with_grad`` is kernel K5 on CUDA and
``interp_rows_with_grad_transpose_add_`` kernel K5ᵀ (XLA derives that
transpose from the gather in the reference), which adds into a given
table in place over a plan of occupied rows (``endpoint_plan``), each
beside its plain version; ``interp_rows_with_grad_taps_ref`` is K5's
and K1c's evaluator summed in the kernels' order, and ``pack_z_taps_ref``
and ``interp_rows_with_grad_packed_ref`` the plain versions of K1c's
z-tap-packed table and its evaluator, bitwise equal to that twin;
``interp``/``interp_with_grad``/``interp_weights`` are the 64-neighbour
block forms, plain on every device.

A table with a leading member axis, (B, R, nz) over shared indices and
weights, is what ``jax.vmap`` over the field makes of ``rows_value_p`` in
the reference (the ensemble Kalman filter's member axis): kernel K2b
forward and K3b backward on CUDA, over the one plan of the point set, and
the same plain versions with a member axis on the CPU. Member b of either
is bitwise the unbatched kernel on member b. Both read the member axis
packed innermost (``kernels.pack_members``, plain version
``pack_members_ref``, its inverse ``unpack_members_ref``; K2b's gather
over the pack ``rows_value_packed_ref``; K3b's fold of rows of several
segments ``fold_member_rows_ref``). A caller that also evaluates the zp
endpoint terms on the same table (``forward.tec.PairedDtecLinear``)
packs it once (``member_pack``, a ``MemberPack``) and hands the pack to
K2b and to the batched K1e. Batched indices loop the
unbatched call, as the reference falls back to its vmapped plain
implementation there; batched weights over an unbatched table (the
reference: "rare; not a production path") raise NotImplementedError.

Not ported yet: gradients with respect to the weights. The reference's
sharded-gather plumbing (``_sharded_take``: the output sharding of a
gather over sharded indices, which JAX's sharding-in-types asks for) has
no counterpart to need: a ray-sharded operator gathers shard by shard
over each shard's own points (``parallel.sharding``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from .grids import Grid3D
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
    against a dense z band). A (B, R, nz) table gives (B, N), member by
    member (the plain version of K2b)."""
    check_full_f32()
    if table.dim() == 3:
        return torch.stack([rows_value_ref(t, ri, wxy, zi, wz, xy_first)
                            for t in table])
    nz = table.shape[-1]
    rows = table[ri.long()]                              # (N,K,nz)
    band = _z_band(zi, wz, nz)                           # (N,nz)
    if xy_first:    # the box spline's order
        s = torch.einsum("nkz,nk->nz", rows, wxy)
        return torch.einsum("nz,nz->n", s, band)
    pencil = torch.einsum("nkz,nz->nk", rows, band)     # tricubic order
    return torch.sum(pencil * wxy, dim=-1)


def pack_members_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.pack_members``: x (B, M) → (⌈B/8⌉, M,
    8), packed[g, j, m] = x[8g + m, j], zeros past member B − 1 (the
    member-innermost layout K2b and K3b read)."""
    g = kernels.MEMBER_GROUP
    b, m = x.shape
    pad = torch.zeros((-b % g, m), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).reshape(-1, g, m).transpose(1, 2).contiguous()


def unpack_members_ref(packed: torch.Tensor, n_members: int) -> torch.Tensor:
    """The inverse of ``pack_members_ref``: (G, M, 8) → (n_members, M)."""
    g, m, _ = packed.shape
    return packed.transpose(1, 2).reshape(-1, m)[:n_members].contiguous()


def rows_value_packed_ref(packed, n_members: int, table_shape, ri, wxy,
                          zi, wz, xy_first: bool) -> torch.Tensor:
    """The plain version of K2b's gather, reading the member tables from
    their member-innermost pack (G, R·nz, 8) (``pack_members_ref`` of the
    (B, R, nz) tables flattened; table_shape = (R, nz)): every point's K ×
    L taps gathered for all members at once, indices clamped into the
    table as the kernel clamps them, and contracted in the given order →
    (n_members, N)."""
    check_full_f32()
    n_rows, nz = table_shape
    taps = packed.reshape(packed.shape[0], n_rows, nz, -1)[
        :, ri.long().clamp(0, n_rows - 1)[:, :, None],
        zi.long().clamp(0, nz - 1)[:, None, :]]         # (G, N, K, L, 8)
    if xy_first:
        s = torch.einsum("gnklm,nk->gnlm", taps, wxy)
        out = torch.einsum("gnlm,nl->gnm", s, wz)
    else:
        pencil = torch.einsum("gnklm,nl->gnkm", taps, wz)
        out = torch.einsum("gnkm,nk->gnm", pencil, wxy)
    return out.transpose(1, 2).reshape(-1, ri.shape[0])[:n_members]


@dataclasses.dataclass(frozen=True)
class MemberPack:
    """The member-innermost pack (``kernels.pack_members``) of one (B, R,
    nz) table on the card, which K2b's gather (``rows_value``) and the
    batched K1e (``boxspline.interp_rows_with_grad_batched``) read in
    place of the table: made by a caller that runs both on one table, and
    dropped with that call. ``table`` is the tensor it was packed from, so
    that each takes the pack only with it."""

    table: torch.Tensor
    packed: torch.Tensor = dataclasses.field(repr=False)

    def of(self, table) -> bool:
        """Whether this is the pack of exactly this tensor."""
        return self.table is table


def member_pack(table: torch.Tensor) -> MemberPack:
    """The ``MemberPack`` of a (B, R, nz) table on the card (one launch
    of ``kernels.pack_members``)."""
    return MemberPack(table, kernels.pack_members(
        table.reshape(table.shape[0], -1)))


def check_pack(pack, table, who: str):
    """The packed tensor of ``pack`` (None for none), raising unless it
    is the pack of ``table``."""
    if pack is None:
        return None
    if not pack.of(table):
        raise ValueError(f"{who}: pack is the MemberPack of another tensor "
                         f"than the table")
    return pack.packed


@dataclasses.dataclass(frozen=True)
class PointOrder:
    """K2's order of a fixed point set: ``order`` (N,) int32, the point
    each thread computes (``kernels.point_order``: the points sorted by
    their stencil's base cell), and the set's ri, wxy, zi, wz permuted
    into it, which K2 reads in thread order (coalesced) while its
    stencils' rows are shared within a warp, in place of the set's own.
    ``source`` holds the set's own four tensors, so that ``rows_value``
    takes the order only with them. It changes no output bit."""

    order: torch.Tensor
    ri: torch.Tensor
    wxy: torch.Tensor
    zi: torch.Tensor
    wz: torch.Tensor
    source: tuple = dataclasses.field(repr=False)

    def of(self, ri, wxy, zi, wz) -> bool:
        """Whether this is the order of exactly these tensors."""
        return all(a is b for a, b in zip(self.source, (ri, wxy, zi, wz)))


def build_point_order(ri, wxy, zi, wz, base: int, grid_shape) -> PointOrder:
    """The ``PointOrder`` of a point set whose stencil's base cell is row
    ri[:, base] at z zi[:, 1]: on CUDA the key kernel, a sort and the
    permute kernel (``kernels.permute_points``), no host read."""
    order = kernels.point_order(ri, zi, base, grid_shape)
    src = (ri, wxy, zi, wz)
    if ri.is_cuda:
        return PointOrder(order, *kernels.permute_points(order, *src), src)
    perm = order.long()
    return PointOrder(order, *(t[perm] for t in src), src)


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
              no two calls share its counters at once;
    z0_range: in a plan of occupied rows only (``occupied_rows=True``:
              an empty row has no segment, and n_seg_max = ⌈N·live /
              chunk⌉ + min(n_rows, N·live)), (n_rows, 2) int32, the least
              and greatest z0 of each row's pairs (0, −1 in an empty row),
              from which a kernel knows the z span a row's pairs touch;
              None in a plan where every row has a segment;
    tasks:    in a plan given a task list (``with_tasks``), (n_seg_max, 4)
              int32, one warp's work a row, read with one 16-byte load:
              (row, first pair, end, lo | hi << 16) for one segment of a
              long row (its pairs order[first:end], its row's touched z
              span [lo, hi]), or (−1, first pair, end, 0) for whole short
              rows, consecutive in the plan (at most ``TASK_PAIRS`` pairs,
              their spans' sum at most nz); empty tasks (−1, 0, 0, 0) past
              the last. None otherwise;
    n_tasks:  with ``tasks``, (1,) int32: the tasks used;
    task_counters: with ``tasks``, (2,) int32 zeros, the kernel's counters
              that share out the tasks past its grid (left at zero by each
              call).
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
    z0_range: torch.Tensor | None = None
    tasks: torch.Tensor | None = None
    n_tasks: torch.Tensor | None = None
    task_counters: torch.Tensor | None = None

    @property
    def n_rows(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n_seg_max(self) -> int:
        return self.seg_row.shape[0]


#: Row plans built since the process started (a solve's set-up cost: each
#: is a radix sort of its pairs); callers read the difference around a run.
plans_built = [0]


def build_row_plan(ri: torch.Tensor, n_rows: int, z0: torch.Tensor = None,
                   live: int = None, chunk: int = SEGMENT_PAIRS,
                   occupied_rows: bool = False) -> RowPlan:
    """The plan of the pairs of row indices ri (N, K): the first ``live``
    (default K) translates of each point, sorted by row and, within a
    row, by the point's first z tap ``z0`` (N,) (so the pairs that add
    into one z element are neighbours), then cut into segments of at most
    ``chunk`` pairs. ``occupied_rows``: no segment for an empty row, and
    each row's z0 range (needs ``z0``), for a kernel that adds into a
    table only where its pairs land. One sort and a few searches on ri's
    device, no host read."""
    n, stride = ri.shape
    live = stride if live is None else live
    if occupied_rows and z0 is None:
        raise ValueError("build_row_plan: occupied_rows needs z0")
    dev = ri.device
    plans_built[0] += 1
    ids = (torch.arange(n, dtype=torch.int64, device=dev)[:, None] * stride
           + torch.arange(live, dtype=torch.int64, device=dev)[None, :])
    key = ri[:, :live].to(torch.int64) << 32
    if z0 is not None:
        key = key + (z0.to(torch.int64)[:, None] + 2 ** 31)
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    bounds = torch.arange(n_rows + 1, dtype=torch.int64, device=dev) << 32
    offsets = torch.searchsorted(sorted_key, bounds, out_int32=True)
    counts = offsets[1:] - offsets[:-1]
    n_seg = (counts + (chunk - 1)) // chunk
    n_seg_max = -(-n * live // chunk)
    z0_range = None
    if occupied_rows:
        n_seg_max += min(n_rows, n * live)
        # each row's first and last z0 in sort order (a pad: no pairs)
        z0s = torch.cat([(sorted_key & 0xFFFFFFFF) - 2 ** 31,
                         torch.zeros(1, dtype=torch.int64, device=dev)])
        has = counts > 0
        lo = torch.where(has, z0s[offsets[:-1].long()], 0)
        hi = torch.where(has, z0s[(offsets[1:].long() - 1).clamp_min(0)], -1)
        z0_range = torch.stack([lo, hi], -1).to(torch.int32)
    else:
        n_seg = torch.clamp_min(n_seg, 1)
        n_seg_max += n_rows
    seg_end = torch.cumsum(n_seg, 0, dtype=torch.int32)
    row_seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         seg_end])
    seg_row = torch.searchsorted(
        seg_end, torch.arange(n_seg_max, dtype=torch.int32, device=dev),
        right=True, out_int32=True)
    return RowPlan(order=ids.reshape(-1)[perm].to(torch.int32),
                   offsets=offsets, row_seg=row_seg, seg_row=seg_row,
                   counters=torch.zeros(n_rows, dtype=torch.int32,
                                        device=dev),
                   stride=stride, live=live, chunk=chunk,
                   stream=(torch.cuda.current_stream(dev).cuda_stream
                           if dev.type == "cuda" else None),
                   z0_range=z0_range)


#: Pairs a task of whole short rows holds at most (``with_tasks``): one
#: batch of 32 lanes, one pair a lane.
TASK_PAIRS = 32


def with_tasks(plan: RowPlan, nz: int, task_pairs: int = TASK_PAIRS
               ) -> RowPlan:
    """``plan`` (of occupied rows, pairs whose z taps are the Catmull–Rom
    stencil base−1 .. base+2 of the cell base z0, clamped into [0, nz))
    with its task list (``RowPlan.tasks``): a row of one segment of at most
    ``task_pairs`` pairs is short, and consecutive short rows are taken
    greedily into tasks of at most ``task_pairs`` pairs whose touched z
    spans sum to at most nz; every segment of any other row is a task of
    its own (``task_pairs=0``: every segment). The long rows' segments
    come first, the rows of most segments first, then the short rows'
    tasks, each kind in the plan's order. Built on the plan's
    device with no host read: the greedy chain of group starts is the
    orbit of the first short row under "the first short row past this
    one's group", found by doubling."""
    if plan.z0_range is None:
        raise ValueError("with_tasks: needs a plan of occupied rows")
    dev = plan.offsets.device
    n_rows = plan.n_rows
    off = plan.offsets.long()
    counts = off[1:] - off[:-1]
    lo = (plan.z0_range[:, 0].long() - 1).clamp_min(0)
    hi = (plan.z0_range[:, 1].long() + 2).clamp_max(nz - 1)
    short = (counts > 0) & (counts <= min(task_pairs, plan.chunk))
    rows = torch.arange(n_rows, device=dev)

    def first_at_or_past(mask):      # (n_rows + 1,); n_rows: none
        f = torch.flip(torch.cummin(torch.flip(
            torch.where(mask, rows, n_rows), [0]), 0).values, [0])
        return torch.cat([f, f.new_full((1,), n_rows)])

    # the group a short row r starts: rows r .. nxt[r] − 1, up to the
    # pair and span limits and short of the next row that is not short
    cum_p = torch.cumsum(counts, 0)
    span = torch.where(short, hi - lo + 1, 0)
    cum_s = torch.cumsum(span, 0)
    nxt = torch.minimum(torch.minimum(
        torch.searchsorted(cum_p, cum_p - counts + task_pairs, right=True),
        torch.searchsorted(cum_s, cum_s - span + nz, right=True)),
        first_at_or_past((counts > 0) & ~short)[:n_rows])
    first = first_at_or_past(short)
    jump = first[torch.cat([nxt, nxt.new_full((1,), n_rows)])]
    starts = first[:1]
    for _ in range((n_rows + 1).bit_length()):
        starts = torch.cat([starts, jump[starts]])
        jump = jump[jump]
    is_start = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)
    is_start[starts] = True
    n_seg = (plan.row_seg[1:] - plan.row_seg[:-1]).long()
    per_row = torch.where(short, is_start[:n_rows].long(), n_seg)
    task_end = torch.cumsum(per_row, 0)
    q = torch.arange(plan.n_seg_max, device=dev)
    r = torch.searchsorted(task_end, q, right=True).clamp_max(n_rows - 1)
    j = q - (task_end[r] - per_row[r])
    used = q < task_end[-1]
    seg_beg = off[r] + j * plan.chunk
    long_task = torch.stack([r, seg_beg,
                             torch.minimum(seg_beg + plan.chunk, off[r + 1]),
                             lo[r] | (hi[r] << 16)], -1)
    group = torch.stack([torch.full_like(r, -1), off[r], off[nxt[r]],
                         torch.zeros_like(r)], -1)
    empty = torch.tensor([-1, 0, 0, 0], device=dev)
    tasks = torch.where(used[:, None],
                        torch.where(short[r][:, None], group, long_task),
                        empty)
    # long rows' segments first, the rows of most segments first (their
    # chains are the longest and their folds wait for every segment),
    # then the short rows' tasks, then the empty ones; stable
    rank = torch.where(used, torch.where(short[r], 0, -n_seg[r]), 1)
    tasks = tasks[torch.sort(rank, stable=True).indices]
    return dataclasses.replace(
        plan, tasks=tasks.to(torch.int32).contiguous(),
        n_tasks=task_end[-1:].to(torch.int32),
        task_counters=torch.zeros(2, dtype=torch.int32, device=dev))


def scatter_add_(out: torch.Tensor, flat: torch.Tensor,
                 contrib: torch.Tensor) -> torch.Tensor:
    """out[..., flat[i]] += contrib[..., i] along the last axis, in place,
    the same sum on every run: ``index_add_`` on the CPU (in order); on
    CUDA, whose ``index_add_`` adds by float atomics in no fixed order,
    ``index_put_`` with accumulation, which sorts the targets and sums
    each one's terms in a fixed order. Returns ``out``."""
    if not out.is_cuda:
        return out.index_add_(-1, flat, contrib)
    size = out.shape[-1]
    lead = torch.arange(out[..., 0].numel(), device=out.device) * size
    idx = (lead.reshape(out.shape[:-1] + (1,)) + flat).reshape(-1)
    out.view(-1).index_put_((idx,), contrib.reshape(-1), accumulate=True)
    return out


def rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape
                             ) -> torch.Tensor:
    """Plain PyTorch version of K3: table_ct[ri[n,k], zi[n,l]] +=
    ct[n]·wxy[n,k]·wz[n,l] by ``scatter_add_`` of the K·L scalar
    contributions per point (reproducible on every device). Contributions
    at rows or z outside the table are dropped, as in the reference. ct
    (B, N) gives (B, n_rows, nz) by one ``scatter_add_`` along the flat
    table axis (the plain version of K3b)."""
    n_rows, nz = table_shape
    flat, contrib = transpose_terms(ct, ri, wxy, zi, wz, table_shape)
    out = torch.zeros(ct.shape[:-1] + (n_rows * nz,), dtype=ct.dtype,
                      device=ct.device)
    return scatter_add_(out, flat, contrib).reshape(
        ct.shape[:-1] + (n_rows, nz))


def transpose_terms(ct, ri, wxy, zi, wz, table_shape):
    """The K·L scalar contributions per point of the transpose, (N·K·L,)
    (or (B, N·K·L) for ct (B, N)), and their flat table indices
    (N·K·L,); those outside the table are 0 at index 0."""
    n_rows, nz = table_shape
    contrib = (ct[..., None, None] * wxy[:, :, None]) * wz[:, None, :]
    r = ri.long()[:, :, None]
    z = zi.long()[:, None, :]
    inside = (r >= 0) & (r < n_rows) & (z >= 0) & (z < nz)
    flat = torch.where(inside, r * nz + z, 0).reshape(-1)
    return flat, torch.where(inside, contrib, 0.0).reshape(
        ct.shape[:-1] + (-1,))


def fold_member_rows_ref(partials: torch.Tensor, plan: RowPlan,
                         out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.fold_member_rows``, in place: for every
    row of several segments and every member, out[b, r] = Σ partials[b,
    s] over r's segments s, summed in segment order from 0.0; rows of one
    segment are left as they are. Reads the busiest row's segment count
    on the host."""
    first = plan.row_seg[:-1].long()
    nseg = plan.row_seg[1:].long() - first
    acc = torch.zeros_like(out)
    for k in range(int(nseg.max())):
        term = partials[:, (first + k).clamp(max=plan.n_seg_max - 1)]
        acc = torch.where((k < nseg)[None, :, None], acc + term, acc)
    return out.copy_(torch.where((nseg > 1)[None, :, None], acc, out))


def rows_value_transpose(ct, ri, wxy, zi, wz, table_shape,
                         plan: RowPlan | None = None) -> torch.Tensor:
    """Transpose of ``rows_value`` with respect to the table: kernel K3
    on CUDA (over ``plan``, built here if not given), the plain version
    on the CPU. ct (B, N) → (B, n_rows, nz): kernel K3b over the same one
    plan."""
    if not ct.is_cuda:
        return rows_value_transpose_ref(ct, ri, wxy, zi, wz, table_shape)
    if plan is None:
        plan = build_row_plan(ri, table_shape[0], zi[:, 0])
    bwd = (kernels.rows_value_bwd_batched if ct.dim() == 2
           else kernels.rows_value_bwd)
    return bwd(ct.contiguous(), plan, wxy.contiguous(), zi.contiguous(),
               wz.contiguous(), table_shape[1])


class _RowsValue(torch.autograd.Function):
    """``rows_value_p`` with its hand-written transpose as the backward
    (with respect to the table only, like the reference's)."""

    @staticmethod
    def forward(ctx, table, ri, wxy, zi, wz, xy_first, plan, order, packed):
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[4]:
            raise NotImplementedError(
                "rows_value: gradients with respect to the weights are not "
                "ported (the reference falls back to its derived AD there)")
        ctx.save_for_backward(ri, wxy, zi, wz)
        ctx.table_shape = tuple(table.shape[-2:])
        ctx.plan = plan
        if not table.is_cuda:
            return rows_value_ref(table, ri, wxy, zi, wz, xy_first)
        if table.dim() == 3:
            return kernels.rows_value_fwd_batched(table, ri, wxy, zi, wz,
                                                  xy_first, packed)
        if order is None:
            return kernels.rows_value_fwd(table, ri, wxy, zi, wz, xy_first)
        return kernels.rows_value_fwd(table, order.ri, order.wxy, order.zi,
                                      order.wz, xy_first, order.order)

    @staticmethod
    def backward(ctx, ct):
        ri, wxy, zi, wz = ctx.saved_tensors
        table_ct = rows_value_transpose(ct, ri, wxy, zi, wz, ctx.table_shape,
                                        ctx.plan)
        return table_ct, None, None, None, None, None, None, None, None


def rows_value(table, ri, wxy, zi, wz, xy_first: bool,
               plan: RowPlan | None = None,
               order: PointOrder | None = None,
               pack: MemberPack | None = None) -> torch.Tensor:
    """Row-gather value map, differentiable in the table. table (R, nz);
    ri (N, K) int32; wxy (N, K); zi (N, L) int32; wz (N, L) → (N,).
    Kernel K2 forward and K3 backward on CUDA (``plan``: the pairs of
    ``ri`` sorted by row, built at the first backward if not given;
    ``order``: the model's ``point_order`` of exactly these tensors,
    which K2 runs them in, reading its permuted copies, and which changes
    no output bit; None: ray order; a batched table runs K2b and leaves
    the order aside, over ``pack``, the table's ``member_pack``, where
    the caller made one);
    ``rows_value_ref`` and ``rows_value_transpose_ref`` on the CPU.

    A member axis: table (B, R, nz) over shared indices and weights →
    (B, N), kernels K2b and K3b. Indices and weights with a leading axis
    too (each (B, N, ·)) loop the unbatched call over it, with table[b] or
    the one shared table. Batched weights over shared indices raise."""
    if ri.dim() == 3 and zi.dim() == 3:
        return torch.stack([
            rows_value(table[b] if table.dim() == 3 else table, ri[b],
                       wxy[b], zi[b], wz[b], xy_first)
            for b in range(ri.shape[0])])
    if not (ri.dim() == zi.dim() == wxy.dim() == wz.dim() == 2):
        raise NotImplementedError(
            "rows_value: a member axis on the weights alone, or on only some "
            "of ri, wxy, zi, wz, is not ported (ROADMAP.md Queue 2, the "
            "batching rule's rare cases); batch the table, or all four")
    if order is not None and not order.of(ri, wxy, zi, wz):
        raise ValueError("rows_value: order is the PointOrder of other "
                         "tensors than ri, wxy, zi, wz")
    return _RowsValue.apply(table, ri, wxy, zi, wz, xy_first, plan, order,
                            check_pack(pack, table, "rows_value"))


# --- the Catmull-Rom tricubic field model ---------------------------------


def _catmull_rom_weights(u: torch.Tensor) -> torch.Tensor:
    """Cubic-convolution weights (a = -0.5) for offsets (-1, 0, 1, 2);
    (...,) → (..., 4)."""
    u2 = u * u
    u3 = u2 * u
    w0 = 0.5 * (-u3 + 2.0 * u2 - u)
    w1 = 0.5 * (3.0 * u3 - 5.0 * u2 + 2.0)
    w2 = 0.5 * (-3.0 * u3 + 4.0 * u2 + u)
    w3 = 0.5 * (u3 - u2)
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _catmull_rom_dweights(u: torch.Tensor) -> torch.Tensor:
    """d/du of the cubic-convolution weights; (..., 4)."""
    u2 = u * u
    w0 = 0.5 * (-3.0 * u2 + 4.0 * u - 1.0)
    w1 = 0.5 * (9.0 * u2 - 10.0 * u)
    w2 = 0.5 * (-9.0 * u2 + 8.0 * u + 1.0)
    w3 = 0.5 * (3.0 * u2 - 2.0 * u)
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _neighborhood(grid: Grid3D, points: torch.Tensor):
    """Per-axis neighbour indices and fractional offsets of points (N, 3):
    idx (N, 3, 4) int32 clamped voxel indices, frac (N, 3) in [0, 1]. The
    query is clamped into the grid (constant extrapolation outside) and
    the base to [0, n−2], so edge points repeat rows and taps."""
    t = grid.world_to_index(points)
    shape = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(shape)), shape - 1.0)
    base = torch.minimum(torch.maximum(torch.floor(t),
                                       torch.zeros_like(shape)), shape - 2.0)
    frac = t - base
    offsets = torch.arange(-1, 3, dtype=torch.int32, device=t.device)
    idx = base.to(torch.int32)[..., None] + offsets            # (N, 3, 4)
    ns = torch.tensor(grid.shape, dtype=torch.int32, device=t.device)
    idx = torch.minimum(torch.clamp_min(idx, 0), ns[None, :, None] - 1)
    return idx, frac


def _row_neighborhood(grid: Grid3D, points: torch.Tensor):
    """``_neighborhood`` plus the 16 (x, y) pencil rows of each point,
    (N, 16) int32, x-major."""
    idx, frac = _neighborhood(grid, points)
    ny = grid.shape[1]
    row_idx = idx[:, 0, :, None] * ny + idx[:, 1, None, :]     # (N, 4, 4)
    return idx, frac, row_idx.reshape(points.shape[0], 16)


def row_setup(grid: Grid3D, points: torch.Tensor):
    """What ``rows_value`` takes for the tricubic value at points (N, 3):
    (ri (N, 16) int32, wxy (N, 16), zi (N, 4) int32, wz (N, 4)),
    contiguous."""
    idx, frac, ri = _row_neighborhood(grid, points)
    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    wxy = (wx[:, :, None] * wy[:, None, :]).reshape(-1, 16)
    return (ri.contiguous(), wxy.contiguous(), idx[:, 2].contiguous(),
            _catmull_rom_weights(frac[:, 2]).contiguous())


#: The pencil whose row is the base cell's: (ix, iy).
BASE_TRANSLATE = 5


def point_order(ri, wxy, zi, wz, grid_shape) -> PointOrder:
    """K2's order of ``row_setup``'s points, by their base cell."""
    return build_point_order(ri, wxy, zi, wz, BASE_TRANSLATE, grid_shape)


def row_plan(ri: torch.Tensor, zi: torch.Tensor, n_rows: int) -> RowPlan:
    """The K3 plan of ``row_setup``'s pairs: all 16 rows are live, and
    within a row the pairs are sorted by the second z tap, which is the
    unclamped cell base (the first tap is clamped at the bottom edge, so
    two bases share it)."""
    return build_row_plan(ri, n_rows, zi[:, 1])


def interp_rows(field2d: torch.Tensor, grid: Grid3D, points: torch.Tensor
                ) -> torch.Tensor:
    """Row-gather tricubic interpolation of the (nx*ny, nz) table at
    points (N, 3): ``rows_value`` over 16 pencils × 4 taps, z first
    (kernel K2 on CUDA, K3 as its transpose)."""
    return rows_value(field2d, *row_setup(grid, points), xy_first=False)


def _contract_yx(cz: torch.Tensor, cz_d: torch.Tensor, frac: torch.Tensor,
                 grid: Grid3D):
    """The z-contracted pencils cz, cz_d (N, 4, 4) (against the z weights
    and their derivatives) contracted over y, then x: value (N,) and
    physical gradient (N, 3)."""
    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    dwx = _catmull_rom_dweights(frac[:, 0])
    dwy = _catmull_rom_dweights(frac[:, 1])
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
    """Value (N,) and physical gradient (N, 3) from the 4×4×4 taps (N, x,
    y, z) of each point, in cubic_eval.cuh's order: each pencil's z sums
    from zero, tap by tap, then y, then x, each a running sum, and the
    gradient divided by the spacing last."""
    wx, wy, wz = (_catmull_rom_weights(frac[:, d]) for d in range(3))
    dwx, dwy, dwz = (_catmull_rom_dweights(frac[:, d]) for d in range(3))
    cz = cz_d = 0.0
    for l in range(4):
        cz = cz + taps[..., l] * wz[:, None, None, l]
        cz_d = cz_d + taps[..., l] * dwz[:, None, None, l]
    czy = czy_dy = czy_dz = 0.0
    for b in range(4):
        czy = czy + cz[:, :, b] * wy[:, None, b]
        czy_dy = czy_dy + cz[:, :, b] * dwy[:, None, b]
        czy_dz = czy_dz + cz_d[:, :, b] * wy[:, None, b]
    v = dx = dy = dz = 0.0
    for a in range(4):
        v = v + czy[:, a] * wx[:, a]
        dx = dx + czy[:, a] * dwx[:, a]
        dy = dy + czy_dy[:, a] * wx[:, a]
        dz = dz + czy_dz[:, a] * wx[:, a]
    return v, torch.stack([dx, dy, dz], dim=-1) / grid.spacing[None, :]


def interp_rows_with_grad_ref(field2d: torch.Tensor, grid: Grid3D,
                              points: torch.Tensor):
    """Plain PyTorch version of K5: value + physical gradient from the 16
    gathered pencils, z contracted first against the dense weight and
    derivative-weight bands, then y, then x, as the reference does."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    nz = grid.shape[2]
    rows = field2d[row_idx.long()]                           # (N, 16, nz)
    wz_band = _z_band(idx[:, 2], _catmull_rom_weights(frac[:, 2]), nz)
    dwz_band = _z_band(idx[:, 2], _catmull_rom_dweights(frac[:, 2]), nz)
    cz = torch.einsum("nkz,nz->nk", rows, wz_band).reshape(-1, 4, 4)
    cz_d = torch.einsum("nkz,nz->nk", rows, dwz_band).reshape(-1, 4, 4)
    return _contract_yx(cz, cz_d, frac, grid)


def interp_rows_with_grad_taps_ref(field2d: torch.Tensor, grid: Grid3D,
                                   points: torch.Tensor):
    """``interp_rows_with_grad_ref`` as K5 and K1c sum it: the 16 pencils'
    4 z taps gathered from the table and contracted in cubic_eval.cuh's
    order (``_contract_taps``). The unpacked twin of
    ``interp_rows_with_grad_packed_ref``."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    taps = field2d[row_idx.long()[:, :, None], idx[:, 2].long()[:, None, :]]
    return _contract_taps(taps.reshape(-1, 4, 4, 4), frac, grid)


def pack_z_taps_ref(field2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1c's pack: the (nz−1, nx*ny, 4) table of
    the four z taps (clamp(b−1), b, b+1, clamp(b+2)) of every row at
    every cell base b in [0, nz−2], base-major."""
    nz = field2d.shape[-1]
    b = torch.arange(nz - 1, device=field2d.device)
    z = torch.stack([(b - 1).clamp_min(0), b, b + 1,
                     (b + 2).clamp_max(nz - 1)], -1)          # (nz-1, 4)
    return field2d[:, z].permute(1, 0, 2).contiguous()


def interp_rows_with_grad_packed_ref(packed: torch.Tensor, grid: Grid3D,
                                     points: torch.Tensor):
    """``interp_rows_with_grad_taps_ref`` reading the packed table
    (``pack_z_taps_ref``) as K1c does: one 4-tap entry per pencil at the
    point's cell base. Bitwise equal to it."""
    check_full_f32()
    idx, frac, row_idx = _row_neighborhood(grid, points)
    taps = packed[idx[:, 2, 1].long()[:, None], row_idx.long()]
    return _contract_taps(taps.reshape(-1, 4, 4, 4), frac, grid)


def interp_rows_with_grad(field2d: torch.Tensor, grid: Grid3D,
                          points: torch.Tensor):
    """Value (N,) + physical gradient (N, 3) at points (N, 3): kernel K5
    on CUDA, ``interp_rows_with_grad_ref`` on the CPU."""
    if points.is_cuda:
        return kernels.cubic_value_grad(field2d, grid, points)
    return interp_rows_with_grad_ref(field2d, grid, points)


def value_grad_transpose_terms(grid: Grid3D, points: torch.Tensor,
                               ct_value: torch.Tensor,
                               ct_grad: torch.Tensor):
    """The 16·4 scalar contributions per point of K5ᵀ and their flat
    table indices, (N·64,) each: row (a, b), tap l receives
    c_v·wx·wy·wz + c_gx/h_x·dwx·wy·wz + c_gy/h_y·wx·dwy·wz
    + c_gz/h_z·wx·wy·dwz."""
    nz = grid.shape[2]
    idx, frac, ri = _row_neighborhood(grid, points)
    wx, wy, wz = (_catmull_rom_weights(frac[:, d]) for d in range(3))
    dwx, dwy, dwz = (_catmull_rom_dweights(frac[:, d]) for d in range(3))
    cg = ct_grad / grid.spacing[None, :]

    def outer(a, b, c):
        return a[:, :, None, None] * b[:, None, :, None] * c[:, None, None, :]

    contrib = (ct_value[:, None, None, None] * outer(wx, wy, wz)
               + cg[:, 0, None, None, None] * outer(dwx, wy, wz)
               + cg[:, 1, None, None, None] * outer(wx, dwy, wz)
               + cg[:, 2, None, None, None] * outer(wx, wy, dwz))
    flat = ri.long()[:, :, None] * nz + idx[:, 2].long()[:, None, :]
    return flat.reshape(-1), contrib.reshape(-1)


def interp_rows_with_grad_transpose_ref(grid: Grid3D, points: torch.Tensor,
                                        ct_value: torch.Tensor,
                                        ct_grad: torch.Tensor
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K5ᵀ: the (nx*ny, nz) table cotangent of
    ``interp_rows_with_grad`` for a value cotangent (N,) and a gradient
    cotangent (N, 3), added by ``scatter_add_`` (reproducible on every
    device)."""
    nx, ny, nz = grid.shape
    flat, contrib = value_grad_transpose_terms(grid, points, ct_value,
                                               ct_grad)
    out = torch.zeros(nx * ny * nz, dtype=ct_value.dtype,
                      device=ct_value.device)
    return scatter_add_(out, flat, contrib).reshape(nx * ny, nz)


def endpoint_plan(grid: Grid3D, points: torch.Tensor) -> RowPlan:
    """The K5ᵀ plan of fixed points: their 16 (point, pencil) pairs, ids
    n·16 + k, sorted by table row and cell base and cut into segments,
    occupied rows only, with each row's range of cell bases."""
    idx, _, ri = _row_neighborhood(grid, points)
    return build_row_plan(ri, grid.shape[0] * grid.shape[1], idx[:, 2, 1],
                          occupied_rows=True)


def interp_rows_with_grad_transpose_add_(table: torch.Tensor, grid: Grid3D,
                                         points: torch.Tensor,
                                         ct_value: torch.Tensor,
                                         ct_grad: torch.Tensor, plan=None
                                         ) -> torch.Tensor:
    """table += the transpose of ``interp_rows_with_grad`` with respect to
    the table, for a value cotangent (N,) and a gradient cotangent (N, 3):
    ``table`` (nx*ny, nz) is updated in place and returned. Kernel K5ᵀ on
    CUDA (over ``plan`` from ``endpoint_plan``, built here if not given),
    which reads and writes only the cells the stencils touch; on the CPU
    ``table.add_`` of ``interp_rows_with_grad_transpose_ref``. Either way
    each cell is rounded as table + (the transpose alone)."""
    if not points.is_cuda:
        return table.add_(interp_rows_with_grad_transpose_ref(
            grid, points, ct_value, ct_grad))
    if plan is None:
        plan = endpoint_plan(grid, points)
    return kernels.cubic_value_grad_bwd(table, grid, points.contiguous(),
                                        ct_value.contiguous(),
                                        ct_grad.contiguous(), plan)


def interp_rows_with_grad_transpose(grid: Grid3D, points: torch.Tensor,
                                    ct_value: torch.Tensor,
                                    ct_grad: torch.Tensor, plan=None
                                    ) -> torch.Tensor:
    """Transpose of ``interp_rows_with_grad`` with respect to the table, a
    fresh (nx*ny, nz) table: ``interp_rows_with_grad_transpose_add_`` into
    zeros (kernel K5ᵀ on CUDA, ``interp_rows_with_grad_transpose_ref`` on
    the CPU)."""
    if not points.is_cuda:
        return interp_rows_with_grad_transpose_ref(grid, points, ct_value,
                                                   ct_grad)
    nx, ny, nz = grid.shape
    table = torch.zeros((nx * ny, nz), dtype=torch.float32,
                        device=points.device)
    return interp_rows_with_grad_transpose_add_(table, grid, points, ct_value,
                                                ct_grad, plan)


def _block_setup(grid: Grid3D, points: torch.Tensor):
    """Flat voxel indices (N, 4, 4, 4) int32 of each point's stencil, and
    frac (N, 3)."""
    idx, frac = _neighborhood(grid, points)
    _, ny, nz = grid.shape
    flat = ((idx[:, 0, :, None, None] * ny + idx[:, 1, None, :, None]) * nz
            + idx[:, 2, None, None, :])
    return flat, frac


def _block_weights(frac: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = (_catmull_rom_weights(frac[:, d]) for d in range(3))
    return wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]


def interp_weights(grid: Grid3D, points: torch.Tensor):
    """(flat voxel indices (N, 64) int32, weights (N, 64)) of the
    interpolation stencil: ``interp(field, grid, points) ==
    (field.reshape(-1)[flat] * w).sum(-1)``."""
    flat, frac = _block_setup(grid, points)
    n = points.shape[0]
    return flat.reshape(n, 64), _block_weights(frac).reshape(n, 64)


def interp(field: torch.Tensor, grid: Grid3D, points: torch.Tensor
           ) -> torch.Tensor:
    """Tricubic interpolation of a 3-D ``field`` at points (N, 3) by the
    64-neighbour block gather (plain PyTorch on every device; the hot
    paths use ``interp_rows``)."""
    flat, frac = _block_setup(grid, points)
    blocks = field.reshape(-1)[flat.long()]                  # (N, 4, 4, 4)
    return torch.sum(blocks * _block_weights(frac), dim=(1, 2, 3))


def interp_with_grad(field: torch.Tensor, grid: Grid3D,
                     points: torch.Tensor):
    """Value and physical gradient by the block gather (plain PyTorch on
    every device; the hot paths use ``interp_rows_with_grad``)."""
    check_full_f32()
    flat, frac = _block_setup(grid, points)
    blocks = field.reshape(-1)[flat.long()]
    cz = torch.einsum("nxyz,nz->nxy", blocks,
                      _catmull_rom_weights(frac[:, 2]))
    cz_d = torch.einsum("nxyz,nz->nxy", blocks,
                        _catmull_rom_dweights(frac[:, 2]))
    return _contract_yx(cz, cz_d, frac, grid)
