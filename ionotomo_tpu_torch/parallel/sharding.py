"""Multi-device execution: the device mesh, its placements, the
collectives and the ray-sharded bundle (port of
``ionotomo_tpu.parallel.sharding``).

The reference is single-program SPMD: a 1-D mesh over the ray axis, the
voxel grid replicated, rays sharded, XLA's partitioner propagating the
annotations through its solvers. The port keeps JAX's single controller
and writes the SPMD out: **one process drives every device** of a
``Mesh``, a tuple of ``torch.device``s with axis names and a shape, in
which a device may repeat. S shards then run in turn on one card (or on
one CPU, as the tests run them), and the same code places them on
``cuda:0 .. n-1`` of a host with more cards.

Shards are per-device tensors in small containers: ``Sharded`` (pieces
of an array split along one axis, in order), ``Replicated`` (one copy a
device) and ``ShardedRayBundle`` (per-shard ``RayBundle``s in ray order);
``parallel.grid_sharding.ShardedField`` holds x-slabs of a field. The
three collectives the reference uses are written out, in a fixed order so
that a solve is bitwise the same from run to run (NCCL's ring order would
not promise that):

- ``psum``: the shards' tensors added in shard order on the mesh's first
  device (then copied to each device where a caller needs it there);
- ``pmean``: ``psum`` / S;
- ``ppermute``: ``Tensor.to(device, non_blocking=True)`` along a
  permutation of the shards.

``ray_mesh``, ``member_mesh`` and ``grid_mesh`` with ``devices=None``
take every visible CUDA device and raise where there is none (no CPU
fallback); a caller that wants the CPU, or S shards on one card, passes
the devices (``[torch.device("cpu")] * 8``, ``[cuda:0] * S``). The
placements ``ray_sharding``, ``replicated`` and ``member_sharding`` are
functions that split and place. ``ShardedDtecGeometry`` and
``ShardedPairedDtecLinear`` are the linearised paired-dTEC operator over a
ray-sharded bundle (the reference gets it from SPMD propagation):
J runs shard by shard with its outputs in ray order, Jᵀ shard by shard
and then ``psum`` of the tables. ``torch.distributed`` (one process a
card) is not used: it waits for a machine with more than one card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..geometry.rays import RayBundle

RAY_AXIS = "rays"
SLICE_AXIS = "slice"
MEMBER_AXIS = "members"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over ``axis_sizes``, one name an axis.
    ``shape`` maps each name to its size, as a JAX mesh's does."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        n = 1
        for s in self.axis_sizes:
            n *= s
        if n != len(self.devices) or len(self.axis_names) != len(
                self.axis_sizes):
            raise ValueError(f"mesh of shape {self.axis_sizes} over axes "
                             f"{self.axis_names} needs {n} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def _devices(devices) -> list:
    """The given devices, or every visible CUDA device; raises without
    one (a mesh never quietly becomes the CPU)."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("a mesh needs at least one device")
        return out
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "a mesh with devices=None takes every visible CUDA device, and "
            "there is none: pass the devices (e.g. [torch.device('cpu')] * "
            "8 for S shards on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def _make_mesh(shape, names, devices) -> Mesh:
    return Mesh(tuple(devices), tuple(names), tuple(int(s) for s in shape))


def ray_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'rays'."""
    devices = _devices(devices)
    return _make_mesh((len(devices),), (RAY_AXIS,), devices)


def multislice_ray_mesh(n_slices: int, chips_per_slice: int = None,
                        devices=None) -> Mesh:
    """2-level ('slice', 'rays') mesh for multi-slice deployments. Rays
    shard over the flattened slice × device product (``ray_sharding``
    handles both mesh kinds), so the device order puts each slice's
    devices contiguously."""
    devices = _devices(devices)
    if chips_per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices do not divide into {n_slices} "
                "slices; pass chips_per_slice (and an explicit device "
                "subset) to use fewer devices deliberately")
        chips_per_slice = len(devices) // n_slices
    n = n_slices * chips_per_slice
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return _make_mesh((n_slices, chips_per_slice), (SLICE_AXIS, RAY_AXIS),
                      devices[:n])


def member_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'members': the
    ensemble filter's per-member parallelism (each device carries
    n_members / n_devices members end to end; members are not padded, a
    phantom member would bias the ensemble mean)."""
    devices = _devices(devices)
    return _make_mesh((len(devices),), (MEMBER_AXIS,), devices)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# --- containers -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharded:
    """An array split along ``axis`` into one piece a device, in order."""

    shards: Tuple[torch.Tensor, ...]
    axis: int = 0

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        shape[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (the first shard's by default)."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device, non_blocking=True)
                          for s in self.shards], dim=self.axis)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """One copy of an array a device (the same tensor where a device
    repeats)."""

    shards: Tuple[torch.Tensor, ...]

    @property
    def shape(self) -> tuple:
        return tuple(self.shards[0].shape)


def split(x: torch.Tensor, devices, axis: int = 0) -> Sharded:
    """``x`` cut into len(devices) equal pieces along ``axis``, piece i on
    devices[i] (a view where it already lies there)."""
    s = len(devices)
    if x.shape[axis] % s:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not "
                         f"divide over {s} devices")
    pieces = torch.chunk(x, s, dim=axis)
    return Sharded(tuple(p.to(d, non_blocking=True)
                         for p, d in zip(pieces, devices)), axis)


def ray_sharding(mesh: Mesh, axis: int = 0):
    """The placement that shards axis ``axis`` (the ray axis) over the
    mesh's devices, over the slice × device product when the mesh is
    2-level: a function of an array that returns a ``Sharded``."""
    return lambda x: split(x, mesh.devices, axis)


def replicated(mesh: Mesh):
    """The placement that copies an array to every device of the mesh."""
    return lambda x: Replicated(tuple(x.to(d) for d in mesh.devices))


def member_sharding(mesh: Mesh):
    """The placement that shards the leading (member) axis of an
    (n_members, *grid) ensemble over the mesh."""
    if MEMBER_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}; build it with "
                         "parallel.member_mesh()")
    return lambda x: split(x, mesh.devices, 0)


def shard_ray_batch(mesh: Mesh, *arrays):
    """Pad the leading axis to a multiple of the mesh size and shard each
    array along it. Returns (the ``Sharded`` arrays, the valid count).
    Padding repeats the last element, so padded rays are valid geometry
    (their results are sliced away or masked by the caller)."""
    nd = mesh.size
    out = []
    n = arrays[0].shape[0]
    n_pad = pad_to_multiple(n, nd)
    place = ray_sharding(mesh)
    for a in arrays:
        if n_pad != n:
            pad = a[-1:].expand((n_pad - n,) + tuple(a.shape[1:]))
            a = torch.cat([a, pad], dim=0)
        out.append(place(a))
    return out, n


def replicate(mesh: Mesh, *arrays):
    """Place arrays fully replicated on the mesh."""
    place = replicated(mesh)
    return [place(a) for a in arrays]


# --- collectives -----------------------------------------------------------


def psum(tensors, device=None) -> torch.Tensor:
    """The tensors added in shard order, ((t0 + t1) + t2) + ..., on
    ``device`` (the first tensor's by default)."""
    device = tensors[0].device if device is None else device
    out = tensors[0].to(device, non_blocking=True)
    for t in tensors[1:]:
        out = out + t.to(device, non_blocking=True)
    return out


def pmean(tensors, device=None) -> torch.Tensor:
    """``psum`` / S."""
    return psum(tensors, device) / len(tensors)


def ppermute(tensors, perm, devices=None):
    """out[dst] = tensors[src] on device dst for each (src, dst) of the
    permutation ``perm``; None where no shard sends."""
    devices = [t.device for t in tensors] if devices is None else devices
    out = [None] * len(tensors)
    for src, dst in perm:
        out[dst] = tensors[src].to(devices[dst], non_blocking=True)
    return out


# --- the ray-sharded bundle -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedRayBundle:
    """A ``RayBundle`` cut along its ray axis into whole per-shard
    bundles, in ray order, each on its shard's device. The ray axis is
    axis ``ray_axis`` of the points (0 for (R, N, 3); 1 for a stacked
    (Nt, R, N, 3) sequence, whose ``step(t)`` is the bundle of step t)."""

    shards: Tuple[RayBundle, ...]
    ray_axis: int = 0

    @property
    def devices(self):
        return tuple(b.points.device for b in self.shards)

    @property
    def num_rays(self) -> int:
        return sum(b.points.shape[self.ray_axis] for b in self.shards)

    @property
    def ds(self) -> torch.Tensor:
        """The whole ds on the first device."""
        return Sharded(tuple(b.ds for b in self.shards),
                       self.ray_axis).gather()

    def gather(self, device=None) -> RayBundle:
        """The whole bundle on ``device`` (the first shard's by default)."""
        return RayBundle(
            points=Sharded(tuple(b.points for b in self.shards),
                           self.ray_axis).gather(device),
            ds=Sharded(tuple(b.ds for b in self.shards),
                       self.ray_axis).gather(device))

    def step(self, t: int) -> "ShardedRayBundle":
        if self.ray_axis != 1:
            raise ValueError("step() needs a stacked (Nt, R, N, 3) bundle")
        return ShardedRayBundle(tuple(b.step(t) for b in self.shards), 0)

    def map(self, fn) -> "ShardedRayBundle":
        """``fn`` applied to each shard's bundle."""
        return ShardedRayBundle(tuple(fn(b) for b in self.shards),
                                self.ray_axis)


def shard_rays(mesh: Mesh, bundle: RayBundle, ray_axis: int = 0
               ) -> ShardedRayBundle:
    """``bundle`` sharded along its ray axis over the mesh (the ray count
    must divide the mesh size: callers pad whole antennas first)."""
    place = ray_sharding(mesh, ray_axis)
    pts, ds = place(bundle.points), place(bundle.ds)
    return ShardedRayBundle(tuple(RayBundle(points=p, ds=s)
                                  for p, s in zip(pts.shards, ds.shards)),
                            ray_axis)


def on_device(x, device):
    """``x`` on ``device``: itself where it already lies there."""
    return x if x.device == device else x.to(device, non_blocking=True)


# --- the linearised paired-dTEC operator over a ray-sharded bundle ---------


class ShardedDtecGeometry:
    """``forward.tec.DtecGeometry`` of a ``ShardedRayBundle``: one
    unpaired geometry a shard (every ray its own row, on the shard's
    device, with its plans there), and what the paired quadrature needs of
    the whole bundle on the first device (ds, the weights). The pairing
    subtracts the reference antenna's samples from every antenna's, so it
    runs on the per-sample values gathered in ray order."""

    def __init__(self, grid, rays: ShardedRayBundle, num_directions, i0=0,
                 quadrature: str = "hermite", interp: str = "cubic",
                 plans: bool = True):
        from ..forward import tec as tec_mod

        self.grid, self.rays = grid, rays
        self.quadrature, self.interp = quadrature, interp
        self.parts = [tec_mod.DtecGeometry(
            grid.to(b.points.device) if grid.device != b.points.device
            else grid, b, None, None, quadrature, interp, plans)
            for b in rays.shards]
        first = self.parts[0]
        self.model, self.hermite, self.n = first.model, first.hermite, first.n
        self.table_shape = first.table_shape
        self.device = rays.devices[0]
        self.w = first.w
        r = rays.num_rays
        if num_directions is None:
            self.na, self.nd, self.i0 = r, 1, None
        else:
            self.na, self.nd, self.i0 = r // num_directions, num_directions, i0
        self.counts = [p.rays.points.shape[0] for p in self.parts]
        # only ds is read by the quadrature
        self.q_rays = RayBundle(points=None, ds=rays.ds)


def _cat_rays(xs, device) -> torch.Tensor:
    """Per-shard values along their last axis, in ray order on
    ``device``."""
    return torch.cat([on_device(x, device) for x in xs], dim=-1)


def _ends_in_ray_order(xs, device):
    """Per-shard endpoint values [first (R_s), last (R_s)] → the whole
    bundle's (first (R,), last (R,)) in ray order."""
    firsts = [x[..., :x.shape[-1] // 2] for x in xs]
    lasts = [x[..., x.shape[-1] // 2:] for x in xs]
    return _cat_rays(firsts, device), _cat_rays(lasts, device)


def sharded_dtec_forward(field_m, geometry: ShardedDtecGeometry
                         ) -> torch.Tensor:
    """``forward.tec.dtec_paired_q`` over a ray-sharded geometry, the
    forward alone (no operator is built, no plan is needed): each shard's
    n_e at its samples over its own geometry and, for the Hermite
    quadrature, the path derivatives at its endpoints, gathered in ray
    order; the paired quadrature on the first device. (..., Na·Nd) for a
    field (..., *grid.shape)."""
    from ..forward import tec as tec_mod

    geo = geometry
    table = geo.model.table(field_m, geo.grid).contiguous()
    lead = table.shape[:-2]
    nes, dnds = [], []
    for pg in geo.parts:
        t = on_device(table, pg.rays.points.device)
        nes.append(tec_mod._ne_over(t, pg))
        if geo.hermite:
            dnds.append(tec_mod._dnds_over(t, pg))
    ne = _cat_rays(nes, geo.device).reshape(lead + (geo.na, geo.nd, geo.n))
    if not geo.hermite:
        return tec_mod._paired_simpson_ne(ne, geo.w, geo.q_rays,
                                          geo.i0).reshape(lead + (-1,))
    d0, d1 = _ends_in_ray_order(dnds, geo.device)
    return tec_mod._paired_hermite_ne(ne, d0, d1, geo.w, geo.q_rays,
                                      geo.i0).reshape(lead + (-1,))


class ShardedPairedDtecLinear:
    """``forward.tec.PairedDtecLinear`` over a ``ShardedDtecGeometry``:
    the same J and Jᵀ, written out shard by shard. The table of m0 (and of
    each tangent) is made once on the first device and copied to each
    shard's; R, E and their transposes run on each shard over its own
    geometry (the kernels of the unsharded operator at the shard's
    shapes); the per-sample densities and endpoint terms are gathered in
    ray order and the paired quadrature runs whole on the first device.
    Jᵀ splits the quadrature's cotangents back by shard, and the shards'
    tables are added by ``psum`` in shard order. ``part_cls``: the
    operator class of a shard (``PairedDtecLinear``, or the plain-version
    one). A leading member axis rides along as in the unsharded
    operator."""

    def __init__(self, field_m0, grid, rays, num_directions, i0=0,
                 quadrature: str = "hermite", interp: str = "cubic",
                 geometry: ShardedDtecGeometry = None, part_cls=None):
        from ..forward import tec as tec_mod

        part_cls = part_cls or tec_mod.PairedDtecLinear
        geo = geometry or ShardedDtecGeometry(
            grid, rays, num_directions, i0, quadrature, interp,
            part_cls._plans)
        self.geometry = geo
        table0 = geo.model.table(field_m0, grid).contiguous()
        self.parts = [part_cls(None, pg.grid, pg.rays, None, None,
                               quadrature, interp, geometry=pg,
                               table0=on_device(table0, pg.rays.points.device))
                      for pg in geo.parts]
        lead = table0.shape[:-2]
        ne = _cat_rays([p.ne for p in self.parts], geo.device)
        ne3 = ne.reshape(lead + (geo.na, geo.nd, geo.n))
        if not geo.hermite:
            self.g0 = tec_mod._paired_simpson_ne(
                ne3, geo.w, geo.q_rays, geo.i0).reshape(lead + (-1,))
            return
        d0, d1 = _ends_in_ray_order([p.ne_e * p.slope for p in self.parts],
                                    geo.device)
        self.g0 = tec_mod._paired_hermite_ne(
            ne3, d0, d1, geo.w, geo.q_rays, geo.i0).reshape(lead + (-1,))

    def apply(self, dm: torch.Tensor) -> torch.Tensor:
        """J δm: field tangent (..., *grid.shape) → (..., Na·Nd)."""
        from ..forward import tec as tec_mod

        geo = self.geometry
        t = geo.model.table(dm, geo.grid).contiguous()
        dnes, dds = [], []
        for p in self.parts:
            pg = p.geometry
            tp = on_device(t, pg.rays.points.device)
            pack = p._pack(tp)
            dnes.append(p.ne * p._rows(tp, pack))
            if geo.hermite:
                dm_e, dgm_e = p._value_grad(tp, pack)
                dds.append((p.ne_e * dm_e) * p.slope + p.ne_e * torch.einsum(
                    "...pd,pd->...p", dgm_e, pg.t_hat))
            del pack
        dne = _cat_rays(dnes, geo.device)
        lead = dne.shape[:-1]
        dne = dne.reshape(lead + (geo.na, geo.nd, geo.n))
        if not geo.hermite:
            return tec_mod._paired_simpson_ne(
                dne, geo.w, geo.q_rays, geo.i0).reshape(lead + (-1,))
        d0, d1 = _ends_in_ray_order(dds, geo.device)
        return tec_mod._paired_hermite_ne(
            dne, d0, d1, geo.w, geo.q_rays, geo.i0).reshape(lead + (-1,))

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """Jᵀ y: (..., Na·Nd) → field cotangent (..., *grid.shape), the
        shards' tables added in shard order on the first device."""
        from ..forward import tec as tec_mod

        geo = self.geometry
        lead = y.shape[:-1]
        y = y.reshape(lead + (geo.na, geo.nd))
        if not geo.hermite:
            ct_ne = tec_mod._paired_simpson_ne_t(y, geo.w, geo.q_rays, geo.i0)
        else:
            ct_ne, ct_d0 = tec_mod._paired_hermite_ne_t(y, geo.w, geo.q_rays,
                                                        geo.i0)
        ct_ne = ct_ne.reshape(lead + (-1,))
        tables, r0 = [], 0
        for p, r in zip(self.parts, geo.counts):
            dev = p.geometry.rays.points.device
            ct_p = on_device(ct_ne[..., r0 * geo.n:(r0 + r) * geo.n], dev)
            table_ct = p._rows_t(p.ne * ct_p)
            if geo.hermite:
                c0 = on_device(ct_d0[..., r0:r0 + r], dev)
                ct_d = torch.cat([c0, -c0], dim=-1) * p.ne_e
                table_ct = p._value_grad_t_add_(
                    table_ct, ct_d * p.slope,
                    ct_d[..., None] * p.geometry.t_hat)
            tables.append(table_ct)
            r0 += r
        return geo.model.table_t(psum(tables, geo.device), geo.grid)
