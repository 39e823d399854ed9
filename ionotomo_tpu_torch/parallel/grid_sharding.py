"""Spatially-sharded tricubic interpolation with halo exchange (port of
``ionotomo_tpu.parallel.grid_sharding``).

The engine's default layout keeps the voxel grid whole on a device and
shards rays. This module is the growth path for grids that exceed a
card's memory: the field is sharded along its leading (x) axis over a
mesh's ``GRID_AXIS``, each shard holds its x-planes in a buffer with room
for **2-plane halos** on either side, which ``_exchange_halos`` fills
from its neighbours (4 planes a shard, not the slab), interpolates the
query points whose 4-point x-stencil it owns, and the per-point partial
results are added by ``psum`` in shard order into the whole answer.

Why 2 planes: the Catmull-Rom stencil spans x ∈ [base−1, base+2] with
base ∈ [x0, x0 + loc). A shard needs 1 plane to the left and 2 to the
right; symmetric 2-plane halos keep the exchange one ring permutation
each way. Edge shards never read their wrapped halos, since the stencil
is clamped in the global index space before ownership is decided.

The per-shard evaluation is kernel K7 on CUDA (``kernels.
cubic_sharded_value``, ``cubic_sharded_value_grad``), ``sharded_value_ref``
and ``sharded_value_grad_ref`` on the CPU; exactly one shard owns each
point, so the shards' sum is bitwise K5's on the whole field. Its
transpose with respect to the slab is K7ᵀ over a ``ShardPlan`` (the
owned points' (point, tap) entries sorted by slab cell, built once per
point set and shard; each entry's weights recomputed from its point),
``sharded_transpose_ref`` on the CPU, bitwise equal to it; the halo
exchange's adjoint adds each halo's cotangent back into the neighbour
that sent it, in a fixed order. A ``ShardedPoints`` holds a point set
over the shards with its plans, for any field sharded on the mesh.

``interp_sharded`` and ``interp_sharded_with_grad`` are
``torch.autograd.Function``s whose backward is K7ᵀ plus the halo adjoint.
``ShardedGridDtecLinear`` is the paired-dTEC operator (Hermite or
Simpson) linearised over an x-sharded field, J and Jᵀ written out over
K7 and K7ᵀ over a ``ShardedGridGeometry`` that keeps the plans, for
Krylov solves on sharded grids (model-space vectors are whole fields on
the mesh's first device, sharded on entry to J and gathered on exit from
Jᵀ: the port's single controller). ``tec_sharded`` and its Hermite and
paired forms are that operator's forward, differentiable through its Jᵀ
with respect to the field's slabs (or a whole field they were cut from).
``trace_rays_sharded`` runs the Fermat integrator with K7 as its field
evaluator, over a 1-D grid mesh or a 2-D grid × ray mesh.

Field-model contract: **cubic only, enforced loudly** (``_check_interp``):
a grid large enough to shard is in the regime where cubic is the
production model. Overlap of the halo exchange with interior work is
deferred, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import constants, kernels
from ..core import tricubic
from ..core.grids import Grid3D
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from .sharding import (RAY_AXIS, Mesh, _devices, _make_mesh, on_device,
                       ppermute, psum)

GRID_AXIS = "gridx"
HALO = 2


def _check_interp(interp: str):
    """The sharded-grid path is cubic only, loudly: a grid that needs
    x-axis sharding is far past 256³, where cubic is the production
    model; a zp run growing onto sharded grids must switch models
    explicitly, never silently."""
    if interp != "cubic":
        raise NotImplementedError(
            f"sharded-grid operators support interp='cubic' only (got "
            f"{interp!r}): grids large enough to shard are in the "
            "resolution regime where cubic is the measured production "
            "model (DESIGN.md section 14); re-run with interp='cubic' "
            "or keep the field replicated")


def grid_mesh(devices=None) -> Mesh:
    """1-D mesh over the grid's leading (x) axis."""
    devices = _devices(devices)
    return _make_mesh((len(devices),), (GRID_AXIS,), devices)


def grid_ray_mesh(n_grid: int, n_rays: int, devices=None) -> Mesh:
    """2-D mesh: ``n_grid`` field shards × ``n_rays`` ray shards, device
    (g, r) at g·n_rays + r. Field ops add over GRID_AXIS; the ray axis
    stays embarrassingly parallel."""
    devices = _devices(devices)
    assert len(devices) >= n_grid * n_rays
    return _make_mesh((n_grid, n_rays), (GRID_AXIS, RAY_AXIS),
                      devices[: n_grid * n_rays])


def _grid_devices(mesh: Mesh, r: int = 0):
    """The devices of the grid shards at ray index r: (g, r) for each g."""
    n_rays = mesh.shape.get(RAY_AXIS, 1)
    return [mesh.devices[g * n_rays + r]
            for g in range(mesh.shape[GRID_AXIS])]


@dataclasses.dataclass(frozen=True)
class ShardedField:
    """An (nx, ny, nz) field cut into S x-slabs of ``loc`` planes. ``ext``
    holds each slab in a (loc + 2·HALO, ny, nz) buffer on its grid
    shard's device, its own planes at [HALO, HALO + loc) and the halo
    room on either side; ``src`` the tensors the own planes were copied
    from (a whole field's slices, with their autograd history), which
    the differentiable functions take as their inputs."""

    mesh: Mesh
    shape: Tuple[int, int, int]
    ext: Tuple[torch.Tensor, ...]
    src: Tuple[torch.Tensor, ...]

    @property
    def n_shards(self) -> int:
        return len(self.ext)

    @property
    def loc(self) -> int:
        return self.shape[0] // self.n_shards

    def x0(self, s: int) -> int:
        return s * self.loc

    def slab2d(self, s: int) -> torch.Tensor:
        """Shard s's buffer as the (rows, nz) table K7 reads."""
        return self.ext[s].view(-1, self.shape[2])

    def gather(self, device=None) -> torch.Tensor:
        """The whole field on ``device`` (the mesh's first by default)."""
        device = self.mesh.first if device is None else device
        return torch.cat([on_device(e[HALO:HALO + self.loc], device)
                          for e in self.ext])


def shard_field(mesh: Mesh, field: torch.Tensor) -> ShardedField:
    """Place a (nx, ny, nz) field x-sharded on the mesh: each shard's
    planes copied into its halo buffer, then the halos exchanged."""
    n = mesh.shape[GRID_AXIS]
    assert field.shape[0] % n == 0, (
        f"nx={field.shape[0]} must divide the mesh ({n} devices)")
    assert field.shape[0] // n >= HALO, (
        f"each shard must own ≥ {HALO} x-planes (the halo width): "
        f"nx={field.shape[0]} over {n} shards gives {field.shape[0] // n}"
        " — a single ring exchange can only reach immediate neighbours")
    loc = field.shape[0] // n
    devs = _grid_devices(mesh)
    src, ext = [], []
    for s, dev in enumerate(devs):
        own = on_device(field[s * loc:(s + 1) * loc], dev)
        buf = torch.empty((loc + 2 * HALO,) + tuple(field.shape[1:]),
                          dtype=torch.float32, device=dev)
        with torch.no_grad():
            buf[HALO:HALO + loc].copy_(own)
        src.append(own)
        ext.append(buf)
    sf = ShardedField(mesh, tuple(int(v) for v in field.shape), tuple(ext),
                      tuple(src))
    _exchange_halos(sf)
    return sf


def _exchange_halos(sf: ShardedField) -> ShardedField:
    """Fill each buffer's halo room from its ring neighbours, in place:
    the left halo is the previous shard's last HALO planes, the right
    halo the next shard's first HALO planes (4 planes a shard). The
    wrapped halos of the edge shards carry the far edge's planes, which
    an owned stencil never reads."""
    s_n, loc = sf.n_shards, sf.loc
    fwd = [(i, (i + 1) % s_n) for i in range(s_n)]
    bwd = [(i, (i - 1) % s_n) for i in range(s_n)]
    with torch.no_grad():
        left = ppermute([e[loc:loc + HALO] for e in sf.ext], fwd)
        right = ppermute([e[HALO:2 * HALO] for e in sf.ext], bwd)
        for buf, lo, hi in zip(sf.ext, left, right):
            buf[:HALO].copy_(lo, non_blocking=True)
            buf[HALO + loc:].copy_(hi, non_blocking=True)
    return sf


def _halo_adjoint(ext_ct, loc: int):
    """The adjoint of the exchange: each shard's own-plane cotangent is
    its buffer's own planes plus the right halo of the previous shard and
    the left halo of the next, added in that order (the wrapped halos'
    cotangents are zero: no owned stencil reads them)."""
    s_n = len(ext_ct)
    out = []
    for s, e in enumerate(ext_ct):
        o = e[HALO:HALO + loc].clone()
        if s > 0:
            o[:HALO] += on_device(ext_ct[s - 1][HALO + loc:], o.device)
        if s < s_n - 1:
            o[loc - HALO:] += on_device(ext_ct[s + 1][:HALO], o.device)
        out.append(o)
    return out


# --- K7: the per-shard evaluation -----------------------------------------


def _owned_taps(slab2d, grid: Grid3D, x0: int, loc: int, points):
    """The 64 taps (N, 4, 4, 4) of each point's global stencil read from
    the slab, frac (N, 3), and the ownership mask (N,)."""
    _, ny, _ = grid.shape
    idx, frac = tricubic._neighborhood(grid, points)
    base_x = idx[:, 0, 1]
    own = (base_x >= x0) & (base_x < x0 + loc)
    # foreign points stay addressable (clamped); their results are masked
    lx = torch.clamp(idx[:, 0, :] - x0 + HALO, 0, loc + 2 * HALO - 1)
    rows = lx[:, :, None] * ny + idx[:, 1, None, :]              # (N, 4, 4)
    taps = slab2d[rows.long()[..., None], idx[:, 2].long()[:, None, None, :]]
    return taps, frac, own


def sharded_value_grad_ref(slab2d, grid: Grid3D, x0: int, loc: int, points):
    """Plain PyTorch version of K7 with the gradient: the 64-tap block
    gather on the slab contracted in cubic_eval.cuh's order
    (``tricubic._contract_taps``), zero where the shard does not own the
    point."""
    taps, frac, own = _owned_taps(slab2d, grid, x0, loc, points)
    v, g = tricubic._contract_taps(taps, frac, grid)
    return (torch.where(own, v, torch.zeros_like(v)),
            torch.where(own[:, None], g, torch.zeros_like(g)))


def sharded_value_ref(slab2d, grid: Grid3D, x0: int, loc: int, points):
    """Plain PyTorch version of K7's value."""
    return sharded_value_grad_ref(slab2d, grid, x0, loc, points)[0]


def _shard_eval(slab2d, grid, x0, loc, points, grad: bool):
    """K7 on CUDA, its plain version on the CPU."""
    if points.is_cuda:
        fn = (kernels.cubic_sharded_value_grad if grad
              else kernels.cubic_sharded_value)
        return fn(slab2d, grid, x0, loc, points.contiguous())
    fn = sharded_value_grad_ref if grad else sharded_value_ref
    return fn(slab2d, grid, x0, loc, points)


def _on_grid(grid: Grid3D, device) -> Grid3D:
    return grid if grid.device == device else grid.to(device)


# --- K7ᵀ: the plan and the transposes --------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The transpose plan of a point set over one shard: ``points`` (N, 3)
    the point set itself (K7ᵀ recomputes each entry's weights from its
    point's position, as K5ᵀ forms them in its body); ``own`` (N_own,)
    int32 the owned point ids; ``order`` (M,) int32 the (owned point, tap)
    entries j·64 + 16a + 4b + l sorted by slab cell, stable; ``cells``
    (U,) int32 the occupied cells, ``starts`` (U + 1,) int32 where each
    one's entries begin; ``blocks`` (NB + 1,) int32 where each block of
    at most ``SHARD_BLOCK`` entries of one cell begins (a cell's from its
    first entry; M last), ``cell_blocks`` (U + 1,) int32 each cell's first
    block; ``levels`` the pairwise tree's depth (⌈log2⌉ of the most
    entries a cell); ``slab_cells`` the slab's (loc + 4)·ny·nz."""

    points: torch.Tensor
    own: torch.Tensor
    order: torch.Tensor
    cells: torch.Tensor
    starts: torch.Tensor
    blocks: torch.Tensor
    cell_blocks: torch.Tensor
    levels: int
    slab_cells: int

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0] - 1


#: The entries of one cell a K7ᵀ thread sums in its first pass (a power
#: of two: a block is one of the pairwise tree's aligned subtrees).
SHARD_BLOCK = 64


def sharded_plan(grid: Grid3D, points: torch.Tensor, x0: int, loc: int
                 ) -> ShardPlan:
    """Build the K7ᵀ plan of points (N, 3) over the shard of planes [x0,
    x0 + loc): one stable sort of the owned (point, tap) entries by slab
    cell on the points' device, and one read of the counts on the host."""
    _, ny, nz = grid.shape
    dev = points.device
    idx, _ = tricubic._neighborhood(grid, points)
    base_x = idx[:, 0, 1]
    own = torch.nonzero((base_x >= x0) & (base_x < x0 + loc)).reshape(-1)
    idx = idx[own].long()
    lx = idx[:, 0, :] - x0 + HALO
    cell = ((lx[:, :, None, None] * ny + idx[:, 1, None, :, None]) * nz
            + idx[:, 2, None, None, :]).reshape(-1)              # (N_own·64,)
    srt = torch.sort(cell, stable=True)
    cells, counts = torch.unique_consecutive(srt.values, return_counts=True)
    starts = torch.zeros(cells.shape[0] + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(counts, 0)
    n_blk = (counts + SHARD_BLOCK - 1) // SHARD_BLOCK
    cell_blocks = torch.zeros_like(starts)
    cell_blocks[1:] = torch.cumsum(n_blk, 0)
    cell_of = torch.repeat_interleave(
        torch.arange(cells.shape[0], device=dev), n_blk)
    k = torch.arange(cell_of.shape[0], device=dev) - cell_blocks[cell_of]
    blocks = torch.cat([starts[cell_of] + k * SHARD_BLOCK, starts[-1:]])
    most = int(counts.max()) if counts.numel() else 1
    return ShardPlan(points=points, own=own.to(torch.int32),
                     order=srt.indices.to(torch.int32),
                     cells=cells.to(torch.int32),
                     starts=starts.to(torch.int32),
                     blocks=blocks.to(torch.int32),
                     cell_blocks=cell_blocks.to(torch.int32),
                     levels=max(most - 1, 0).bit_length(),
                     slab_cells=(loc + 2 * HALO) * ny * nz)


def _entry_terms(plan: ShardPlan, grid: Grid3D, ct_value, ct_grad):
    """The contribution of every entry, in plan order, as K7ᵀ forms it
    (the same operations, one tensor op at a time): the owned points'
    Catmull-Rom weights and d/du weights from their positions, then each
    entry's product."""
    _, frac = tricubic._neighborhood(grid, plan.points[plan.own.long()])
    w = torch.cat([tricubic._catmull_rom_weights(frac[:, d])
                   for d in range(3)]
                  + [tricubic._catmull_rom_dweights(frac[:, d])
                     for d in range(3)], dim=1)                  # (N_own, 24)
    e = plan.order.long()
    j, t = e >> 6, e & 63
    a, b, l = t >> 4, (t >> 2) & 3, t & 3
    wx, wy, wz = w[j, a], w[j, 4 + b], w[j, 8 + l]
    n = plan.own.long()[j]
    wxy = wx * wy
    if ct_grad is None:
        return (ct_value[n] * wxy) * wz
    cg = ct_grad[n] / grid.spacing
    dxy = w[j, 12 + a] * wy
    xdy = wx * w[j, 16 + b]
    s = ct_value[n] * wxy + cg[:, 0] * dxy + cg[:, 1] * xdy
    return s * wz + (cg[:, 2] * wxy) * w[j, 20 + l]


def sharded_transpose_ref(slab: torch.Tensor, plan: ShardPlan, grid: Grid3D,
                          ct_value, ct_grad=None) -> torch.Tensor:
    """Plain PyTorch version of K7ᵀ, accumulating: slab ((loc + 4)·ny·nz,)
    += the transpose of K7 (its value, or with ``ct_grad`` its value and
    gradient) over the plan, in place. Each cell's entries are summed by
    the kernel's pairwise tree, formed in ``plan.levels`` passes over all
    entries at once (at level k an entry of rank r ≡ 0 mod 2^(k+1) in its
    cell absorbs the entry 2^k after it, when there is one), so the result
    is bitwise K7ᵀ's on every device."""
    if plan.order.shape[0] == 0:
        return slab
    v = _entry_terms(plan, grid, ct_value, ct_grad)
    m = v.shape[0]
    pos = torch.arange(m, device=v.device)
    seg = torch.repeat_interleave(
        torch.arange(plan.n_cells, device=v.device),
        (plan.starts[1:] - plan.starts[:-1]).long())
    first = plan.starts.long()[seg]
    rank = pos - first
    size = plan.starts.long()[seg + 1] - first
    for k in range(plan.levels):
        step = 1 << k
        take = ((rank & (2 * step - 1)) == 0) & (rank + step < size)
        partner = torch.clamp(pos + step, max=m - 1)
        v = torch.where(take, v + v[partner], v)
    cells = plan.cells.long()
    slab[cells] = slab[cells] + v[plan.starts.long()[:-1]]
    return slab


def _shard_transpose_add_(slab, plan, grid, ct_value, ct_grad=None):
    """K7ᵀ on CUDA, its plain version on the CPU."""
    if slab.is_cuda:
        if ct_grad is None:
            return kernels.cubic_sharded_value_bwd(slab, plan, grid,
                                                   ct_value.contiguous())
        return kernels.cubic_sharded_value_grad_bwd(
            slab, plan, grid, ct_value.contiguous(), ct_grad.contiguous())
    return sharded_transpose_ref(slab, plan, grid, ct_value, ct_grad)


class ShardedPoints:
    """A fixed point set (N, 3) over the grid shards of a mesh (at ray
    index r of a 2-D mesh): the points on each shard's device and each
    shard's K7ᵀ plan, built at the first transpose and kept. It depends on
    the grid and the mesh, not on a field: passed in place of the points,
    it serves every field sharded on that mesh, so a solve that
    evaluates and transposes at the same points many times sorts them
    once."""

    def __init__(self, mesh: Mesh, grid: Grid3D, points: torch.Tensor,
                 r: int = 0):
        self.grid, self.points = grid, points
        self.devices = _grid_devices(mesh, r)
        self.loc = grid.shape[0] // len(self.devices)
        self.local = [on_device(points, d).contiguous() for d in self.devices]
        self.grids = [_on_grid(grid, d) for d in self.devices]
        self._plans = None

    def plans(self):
        if self._plans is None:
            self._plans = [sharded_plan(g, p, s * self.loc, self.loc)
                           for s, (g, p) in enumerate(zip(self.grids,
                                                          self.local))]
        return self._plans

    def eval(self, sf: ShardedField, grad: bool):
        """Every shard's K7 of ``sf`` at the points, added in shard order
        on the points' device."""
        assert (sf.loc == self.loc
                and sf.shape == tuple(int(v) for v in self.grid.shape)), (
            f"a field of {sf.shape} in shards of {sf.loc} planes against "
            f"points set up for {self.grid.shape} in shards of {self.loc}")
        outs = [_shard_eval(on_device(sf.slab2d(s), dev), self.grids[s],
                            s * self.loc, self.loc, self.local[s], grad)
                for s, dev in enumerate(self.devices)]
        dev = self.points.device
        if not grad:
            return psum(outs, dev)
        return (psum([o[0] for o in outs], dev),
                psum([o[1] for o in outs], dev))

    def transpose_into(self, ext_ct, ct_value, ct_grad=None):
        """ext_ct[s] (flat slab cotangents) += K7ᵀ of each shard."""
        for s, plan in enumerate(self.plans()):
            dev = self.devices[s]
            _shard_transpose_add_(
                ext_ct[s], plan, self.grids[s], on_device(ct_value, dev),
                None if ct_grad is None else on_device(ct_grad, dev))
        return ext_ct


def _eval_shards(sf: ShardedField, grid: Grid3D, points, grad: bool,
                 r: int = 0):
    """Every grid shard's K7 at points (the shards of ray index r on a
    2-D mesh), added in shard order on the points' device."""
    return ShardedPoints(sf.mesh, grid, points, r).eval(sf, grad)


def _zero_slabs(sf: ShardedField):
    return [torch.zeros(e.numel(), dtype=torch.float32, device=e.device)
            for e in sf.ext]


def _own_cotangents(sf: ShardedField, ext_ct):
    shape = (sf.loc + 2 * HALO,) + sf.shape[1:]
    return _halo_adjoint([e.view(shape) for e in ext_ct], sf.loc)


class _InterpSharded(torch.autograd.Function):
    """K7 over every shard, added in shard order; backward: K7ᵀ into each
    shard's slab, then the halo adjoint, a cotangent for each shard's own
    planes (``ShardedField.src``)."""

    @staticmethod
    def forward(ctx, sf: ShardedField, pts: ShardedPoints, grad: bool,
                *src):
        ctx.sf, ctx.pts, ctx.grad = sf, pts, grad
        return pts.eval(sf, grad)

    @staticmethod
    def backward(ctx, *cts):
        ext_ct = ctx.pts.transpose_into(_zero_slabs(ctx.sf), cts[0],
                                        cts[1] if ctx.grad else None)
        return (None, None, None, *_own_cotangents(ctx.sf, ext_ct))


def _points(sf: ShardedField, grid: Grid3D, points) -> ShardedPoints:
    return (points if isinstance(points, ShardedPoints)
            else ShardedPoints(sf.mesh, grid, points))


def interp_sharded(mesh: Mesh, field_sharded: ShardedField, grid: Grid3D,
                   points, points_sharded: bool = False,
                   interp: str = "cubic") -> torch.Tensor:
    """Tricubic interpolation over an x-sharded field: values (N,) on the
    points' device, bitwise ``tricubic.interp_rows_with_grad``'s value on
    CUDA (K5's), within f32 reduction order of ``tricubic.interp``.
    Differentiable with respect to the field's slabs. ``points``: (N, 3),
    or a ``ShardedPoints`` whose plans a backward builds once and keeps.
    ``points_sharded`` (a 2-D grid × ray mesh): the points' leading axis
    is split over the ray axis, each ray shard evaluated by the grid
    shards of its column."""
    _check_interp(interp)
    if points_sharded:
        return _by_ray_shard(field_sharded, grid, points, False)
    return _InterpSharded.apply(field_sharded,
                                _points(field_sharded, grid, points),
                                False, *field_sharded.src)


def interp_sharded_with_grad(mesh: Mesh, field_sharded: ShardedField,
                             grid: Grid3D, points,
                             points_sharded: bool = False,
                             interp: str = "cubic"):
    """Value (N,) + physical gradient (N, 3) over an x-sharded field (the
    pair the Fermat tracer consumes); the same ownership and halo scheme
    as ``interp_sharded``. Bitwise K5's on CUDA."""
    _check_interp(interp)
    if points_sharded:
        return _by_ray_shard(field_sharded, grid, points, True)
    return _InterpSharded.apply(field_sharded,
                                _points(field_sharded, grid, points),
                                True, *field_sharded.src)


def _by_ray_shard(sf: ShardedField, grid: Grid3D, points, grad: bool):
    """Points split over the mesh's ray axis; ray shard r evaluated by the
    grid shards (g, r) and the results put back in point order on the
    first device (forward only)."""
    n_rays = sf.mesh.shape[RAY_AXIS]
    outs = []
    for r, pts in enumerate(torch.chunk(points, n_rays)):
        dev = sf.mesh.devices[r]
        outs.append(_eval_shards(sf, grid, on_device(pts, dev), grad, r))
    first = sf.mesh.first
    if not grad:
        return torch.cat([on_device(o, first) for o in outs])
    return (torch.cat([on_device(o[0], first) for o in outs]),
            torch.cat([on_device(o[1], first) for o in outs]))


# --- the TEC forms: one linearised operator, its J and Jᵀ -----------------


class ShardedGridGeometry:
    """What the sharded-grid TEC forms reuse while the ray samples stay
    fixed, whatever field they are evaluated at (``forward.tec.
    DtecGeometry``'s counterpart): the samples and, for the Hermite
    quadrature, the 2R endpoints as ``ShardedPoints`` (each shard's K7ᵀ
    plan built once), the endpoints' unit tangents, the quadrature
    weights and the pairing. ``num_directions`` None: no pairing, the TEC
    per ray."""

    def __init__(self, mesh: Mesh, grid: Grid3D, rays: RayBundle,
                 num_directions, i0: int = 0, quadrature: str = "hermite"):
        if quadrature not in ("hermite", "simpson"):
            raise ValueError(f"unknown quadrature: {quadrature!r}")
        self.mesh, self.grid, self.rays = mesh, grid, rays
        self.hermite = quadrature == "hermite"
        r, self.n = rays.points.shape[:2]
        if num_directions is None:     # absolute TEC, every ray a row
            self.na, self.nd, self.i0 = r, 1, None
        else:
            self.na, self.nd, self.i0 = (r // num_directions, num_directions,
                                         i0)
        weights = (tec_mod.trapezoid_weights if self.hermite
                   else tec_mod.simpson_weights)
        self.w = weights(self.n, torch.float32, rays.points.device)
        self.pts = ShardedPoints(mesh, grid, rays.points.reshape(-1, 3))
        self.ends = self.t_hat = None
        if self.hermite:
            ends, self.t_hat = tec_mod._endpoint_tangents(rays.points)
            self.ends = ShardedPoints(mesh, grid, ends)


class ShardedGridDtecLinear:
    """The paired-dTEC forward ``dtec_paired_hermite_sharded`` (or its
    Simpson twin) linearised about an x-sharded field m0, with its exact
    transpose, over fixed ray samples: ``forward.tec.PairedDtecLinear``
    with K7 as the value gather R and the endpoint evaluation E, and K7ᵀ
    as their transposes, over a ``ShardedGridGeometry`` (built here unless
    given). It is the one J and Jᵀ over a sharded grid: the TEC forms
    below are its ``g0``, their gradient its ``apply_t``.

    ``apply(δm)``: a whole field tangent (grid.shape) on the mesh's first
    device → (Na·Nd,), sharded on entry (``shard_field``); ``apply_t(y)``
    → a whole field cotangent, the shards' own planes (``apply_t_shards``)
    gathered. ``g0`` is the forward at m0. ``num_directions`` None: no
    pairing, the TEC per ray (``tec_sharded`` linearised)."""

    def __init__(self, mesh: Mesh, field_sharded: ShardedField, grid: Grid3D,
                 rays: RayBundle, num_directions, i0: int = 0,
                 quadrature: str = "hermite",
                 geometry: ShardedGridGeometry = None):
        geo = geometry or ShardedGridGeometry(mesh, grid, rays,
                                              num_directions, i0, quadrature)
        self.geometry, self.sf = geo, field_sharded
        with torch.no_grad():
            self.ne = constants.K_NE * torch.exp(
                geo.pts.eval(field_sharded, False))
            ne3 = self.ne.reshape(geo.na, geo.nd, geo.n)
            if not geo.hermite:
                self.g0 = tec_mod._paired_simpson_ne(
                    ne3, geo.w, geo.rays, geo.i0).reshape(-1)
                return
            m_e, gm_e = geo.ends.eval(field_sharded, True)
            self.ne_e = constants.K_NE * torch.exp(m_e)
            self.slope = torch.einsum("pd,pd->p", gm_e, geo.t_hat)
            dnds = self.ne_e * self.slope
            r = dnds.shape[0] // 2
            self.g0 = tec_mod._paired_hermite_ne(
                ne3, dnds[:r], dnds[r:], geo.w, geo.rays, geo.i0).reshape(-1)

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        geo = self.geometry
        sf = shard_field(geo.mesh, dm)
        dne = self.ne * geo.pts.eval(sf, False)
        dne = dne.reshape(geo.na, geo.nd, geo.n)
        if not geo.hermite:
            return tec_mod._paired_simpson_ne(dne, geo.w, geo.rays,
                                              geo.i0).reshape(-1)
        dm_e, dgm_e = geo.ends.eval(sf, True)
        dd = ((self.ne_e * dm_e) * self.slope
              + self.ne_e * torch.einsum("pd,pd->p", dgm_e, geo.t_hat))
        r = dd.shape[0] // 2
        return tec_mod._paired_hermite_ne(dne, dd[:r], dd[r:], geo.w,
                                          geo.rays, geo.i0).reshape(-1)

    def apply_t_shards(self, y: torch.Tensor):
        """Jᵀ y as each shard's own-plane cotangent (loc, ny, nz) on its
        device: K7ᵀ into each shard's slab, then the halo adjoint."""
        geo = self.geometry
        y = y.reshape(geo.na, geo.nd)
        if not geo.hermite:
            ct_ne = tec_mod._paired_simpson_ne_t(y, geo.w, geo.rays, geo.i0)
        else:
            ct_ne, ct_d0 = tec_mod._paired_hermite_ne_t(y, geo.w, geo.rays,
                                                        geo.i0)
        ext_ct = geo.pts.transpose_into(_zero_slabs(self.sf),
                                        self.ne * ct_ne.reshape(-1))
        if geo.hermite:
            ct_d = torch.cat([ct_d0, -ct_d0]) * self.ne_e
            geo.ends.transpose_into(ext_ct, ct_d * self.slope,
                                    ct_d[:, None] * geo.t_hat)
        return _own_cotangents(self.sf, ext_ct)

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        first = self.geometry.mesh.first
        return torch.cat([on_device(o, first)
                          for o in self.apply_t_shards(y)])


class _ShardedDtec(torch.autograd.Function):
    """A TEC form over an x-sharded field as its operator's ``g0``;
    backward: the operator's Jᵀ, a cotangent for each shard's own planes
    (``ShardedField.src``)."""

    @staticmethod
    def forward(ctx, op: ShardedGridDtecLinear, shape, *src):
        ctx.op = op
        return op.g0.reshape(shape).clone()

    @staticmethod
    def backward(ctx, ct):
        return (None, None, *ctx.op.apply_t_shards(ct))


def _tec_form(mesh, sf, grid, rays, num_directions, i0, quadrature, interp,
              geometry):
    _check_interp(interp)
    op = ShardedGridDtecLinear(mesh, sf, grid, rays, num_directions, i0,
                               quadrature, geometry)
    geo = op.geometry
    shape = (geo.na,) if num_directions is None else (geo.na, geo.nd)
    return _ShardedDtec.apply(op, shape, *sf.src)


def tec_sharded(mesh: Mesh, field_sharded: ShardedField, grid: Grid3D,
                rays: RayBundle, interp: str = "cubic",
                geometry: ShardedGridGeometry = None) -> torch.Tensor:
    """TEC per ray over an x-sharded log-density field (working units):
    ``forward.tec.tec``'s Simpson quadrature with the gather served by the
    halo-exchange interpolator. Differentiable (K7ᵀ backward);
    ``geometry``: a Simpson ``ShardedGridGeometry`` of ``rays`` with no
    pairing, kept across calls."""
    return _tec_form(mesh, field_sharded, grid, rays, None, None, "simpson",
                     interp, geometry)


def dtec_paired_sharded(mesh: Mesh, field_sharded: ShardedField,
                        grid: Grid3D, rays: RayBundle, num_directions: int,
                        i0: int = 0, interp: str = "cubic",
                        geometry: ShardedGridGeometry = None
                        ) -> torch.Tensor:
    """Cancellation-free differential TEC over an x-sharded field:
    ``forward.tec.dtec_paired`` with the sharded gather, (Na, Nd)."""
    return _tec_form(mesh, field_sharded, grid, rays, num_directions, i0,
                     "simpson", interp, geometry)


def tec_hermite_sharded(mesh: Mesh, field_sharded: ShardedField,
                        grid: Grid3D, rays: RayBundle,
                        interp: str = "cubic",
                        geometry: ShardedGridGeometry = None) -> torch.Tensor:
    """Hermite (gradient-augmented) TEC over an x-sharded field: values at
    all samples and value + gradient at the 2R endpoints by K7, weights
    and units those of ``forward.tec.tec_hermite``."""
    return _tec_form(mesh, field_sharded, grid, rays, None, None, "hermite",
                     interp, geometry)


def dtec_paired_hermite_sharded(mesh: Mesh, field_sharded: ShardedField,
                                grid: Grid3D, rays: RayBundle,
                                num_directions: int, i0: int = 0,
                                interp: str = "cubic",
                                geometry: ShardedGridGeometry = None
                                ) -> torch.Tensor:
    """Paired-dTEC twin of ``tec_hermite_sharded``
    (``forward.tec.dtec_paired_hermite``), (Na, Nd)."""
    return _tec_form(mesh, field_sharded, grid, rays, num_directions, i0,
                     "hermite", interp, geometry)


def trace_rays_sharded(mesh: Mesh, field_sharded: ShardedField,
                       grid: Grid3D, origins: torch.Tensor,
                       directions: torch.Tensor, frequency_hz,
                       max_length_km=1000.0, n_steps: int = 64,
                       keep_path: bool = True, method: str = "leapfrog",
                       rays_sharded: bool = False, interp: str = "cubic"):
    """Bent-ray Fermat trace through an x-sharded field: the integrator
    (``geometry.fermat._trace_impl``) with every field evaluation served
    by K7 over the shards. With a 2-D ``grid_ray_mesh`` and
    ``rays_sharded=True`` the ray batch is split over the ray axis too,
    each ray shard traced by the grid shards of its column; the bundles
    and TEC come back in ray order on the mesh's first device."""
    from ..geometry import fermat

    _check_interp(interp)

    def trace(o, d, r):
        def interp_vg(x):
            return _eval_shards(field_sharded, grid, x, True, r)
        return fermat._trace_impl(fermat.log_field_ne_vg(interp_vg), o, d,
                                  frequency_hz, max_length_km, n_steps,
                                  keep_path, method)

    if not rays_sharded:
        return trace(origins, directions, 0)
    n_rays = mesh.shape[RAY_AXIS]
    outs = [trace(on_device(o, mesh.devices[r]), on_device(d, mesh.devices[r]),
                  r)
            for r, (o, d) in enumerate(zip(torch.chunk(origins, n_rays),
                                           torch.chunk(directions, n_rays)))]
    first = mesh.first
    pts = torch.cat([on_device(b.points, first) for b, _ in outs])
    ds = torch.cat([on_device(b.ds, first) for b, _ in outs])
    tau = torch.cat([on_device(t, first) for _, t in outs])
    return RayBundle(points=pts, ds=ds), tau
