"""Launch wrappers of the hand-written CUDA kernels.

- K1  ``trace_leapfrog_zp``: the leapfrog zp tracer, all steps in one launch
  (csrc/trace_leapfrog_zp.cu), for a large batch over the rays sorted
  (``ray_order``) and the table's z taps packed first (``pack_zp_taps``,
  same source);
- K1e ``zp_value_grad``: zp value + physical gradient at points, and
  ``zp_value_grad_batched`` the same for the tables of an ensemble's
  members in one launch, over their member-innermost pack, 8 or 4 lanes
  a point by ``zp_batched_lanes``
  (csrc/zp_value_grad.cu);
- K2  ``rows_value_fwd``: the row-gather value map, over a point order
  where the caller keeps one (``point_order``, whose keys
  ``point_order_keys`` makes; csrc/rows_value_fwd.cu, all three; a
  geometry keeps the order with its inputs permuted into it by
  ``permute_points``, ``core.tricubic.PointOrder``);
- K3  ``rows_value_bwd``: its transpose, a deterministic segmented
  reduction over a plan of the pairs sorted by row (csrc/rows_value_bwd.cu,
  csrc/row_reduce.cuh);
- K1eᵀ ``zp_value_grad_bwd``: the transpose of K1e with respect to the
  table, by the same plan-and-reduce scheme (csrc/zp_value_grad_bwd.cu);
- KG  ``vector_gather``: out[i, j] = table[idx[i, j], j], the gather of the
  JAX package's Pallas probe (csrc/vector_gather.cu);
- K5  ``cubic_value_grad``: tricubic value + physical gradient at points
  (csrc/cubic_value_grad.cu, csrc/cubic_eval.cuh);
- K5ᵀ ``cubic_value_grad_bwd``: its transpose with respect to the table,
  added into a table in place, by the plan-and-reduce scheme over a plan
  of occupied rows (csrc/cubic_value_grad_bwd.cu);
- K1c ``trace_leapfrog_cubic``: the leapfrog tracer over the tricubic
  model (csrc/trace_leapfrog_cubic.cu; csrc/trace_leapfrog.cuh is the
  integrator it shares with K1), over the table's z taps packed first
  (``pack_z_taps``) and, for a batch that fills the card, the rays sorted
  first (``ray_order``, whose keys ``ray_order_keys`` makes; same source);
- K2b ``rows_value_fwd_batched``: K2 over a leading member axis of the
  table, the indices and weights shared, over the tables packed
  member-innermost first (``pack_members``; csrc/rows_value_fwd_batched.cu,
  both);
- K3b ``rows_value_bwd_batched``: K3 over a leading member axis of the
  cotangent, over the one plan the members share: the cotangent packed
  member-innermost (``pack_members``), the reduce (a row of several
  segments leaves each segment's z span of its partial rows), and the fold
  of the plan's list of rows of several segments over those spans
  (``fold_member_rows``; csrc/rows_value_bwd_batched.cu).
- K6z ``zpc_value_grad``: zpc value + physical gradient at points
  (csrc/zpc_value_grad.cu, csrc/zpc_eval.cuh), and K6zᵀ
  ``zpc_value_grad_bwd`` its transpose, added into a table in place over
  the task list of a plan of occupied rows (csrc/zpc_value_grad_bwd.cu);
- K6q ``quad_value_grad``: triquadratic value + physical gradient at points
  (csrc/quad_value_grad.cu, csrc/quad_eval.cuh);
- K1z ``trace_leapfrog_zpc`` and K1q ``trace_leapfrog_quad``: the leapfrog
  tracer over the zpc and the triquadratic model (csrc/trace_leapfrog_zpc.cu,
  csrc/trace_leapfrog_quad.cu), on K6z's and K6q's evaluators over K1c's
  z-tap pack (zpc's z stencil is the tricubic one) and K1's (quadratic's is
  the zp one), each with its own register budget over the packed table and
  its own threshold and blocks in K1's call (``SORT_AND_PACK``);
- K1r ``trace_rk4_zp``, ``trace_rk4_cubic``, ``trace_rk4_zpc`` and
  ``trace_rk4_quad``: the rk4 tracer, all steps in one launch, over each
  model's evaluators, packs and call (in the same sources as the model's
  leapfrog tracer; the integrator in csrc/trace_leapfrog.cuh);
- K1s ``trace_split``: the split-field tracer, leapfrog or rk4, over a
  closed-form Chapman background plus the tricubic model of a perturbation
  table, in two forms of the background (one flat layer, or general),
  over K1c's pack: its leapfrog at its own call, its rk4 at K1c's
  (csrc/trace_split.cu).
- K7  ``cubic_sharded_value`` and ``cubic_sharded_value_grad``: the
  tricubic value (and physical gradient) at points over one x-slab of a
  field sharded along x, with its halos, zero where the shard does not
  own the point, one-shot in the points' order or over the shard's order
  (``parallel.grid_sharding.ShardOrder``: the owned points in cell order,
  the zeros written apart; csrc/cubic_sharded.cu, on cubic_eval.cuh);
- K7ᵀ ``cubic_sharded_value_bwd`` and ``cubic_sharded_value_grad_bwd``:
  their transposes added into the slab over a plan
  (``parallel.grid_sharding.sharded_plan``), each entry's weights
  formed from its point's u (kept in the plan): each occupied cell's entries
  summed by a fixed pairwise tree, a warp a task of at most 32 entries
  (whole cells, or an aligned subtree of a larger cell whose last warp
  sums its subtrees), one launch (csrc/cubic_sharded_bwd.cu).

Each wrapper checks dtype, shape, contiguity and device and raises on
anything else (a CPU tensor included: the plain PyTorch versions live in
the modules that dispatch here), allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
failed, and counts its launches in ``launches``. The library is built
from the sources on the first launch (``kernels.build``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {"trace_leapfrog_zp": 0, "zp_value_grad": 0,
            "zp_value_grad_batched": 0, "rows_value_fwd": 0,
            "rows_value_bwd": 0, "zp_value_grad_bwd": 0, "vector_gather": 0,
            "cubic_value_grad": 0, "cubic_value_grad_bwd": 0,
            "trace_leapfrog_cubic": 0, "pack_z_taps": 0,
            "ray_order_keys": 0, "rows_value_fwd_batched": 0,
            "rows_value_bwd_batched": 0, "pack_members": 0,
            "fold_member_rows": 0, "point_order_keys": 0,
            "permute_points": 0, "pack_zp_taps": 0, "zpc_value_grad": 0,
            "quad_value_grad": 0, "zpc_value_grad_bwd": 0,
            "trace_leapfrog_zpc": 0, "trace_leapfrog_quad": 0,
            "trace_rk4_zp": 0, "trace_rk4_cubic": 0, "trace_rk4_zpc": 0,
            "trace_rk4_quad": 0, "trace_split": 0,
            "cubic_sharded_value": 0, "cubic_sharded_value_grad": 0,
            "cubic_sharded_value_bwd": 0, "cubic_sharded_value_grad_bwd": 0}

#: Widest table row the reduce kernels (K3, K1eᵀ) take: one row per warp
#: in shared memory, 8 warps a block, within the 48 KB a block gets
#: without opting in to more.
MAX_NZ_REDUCE = 1024


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name: str, specs) -> torch.device:
    """Validate (arg, tensor, dtype, shape) specs: dtype, shape and
    contiguity of each first, then that all lie on one CUDA device, which
    is returned."""
    for arg, t, dtype, shape in specs:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor, got {type(t)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    device = specs[0][1].device
    for arg, t, _, _ in specs:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on a CUDA device, got "
                             f"{t.device} (CPU tensors take the plain "
                             f"version)")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
    return device


def _grid_specs(name: str, coef2d, grid, min_axis: int = 3,
                members: int = None):
    """Specs of a field model's table (B of them with ``members``) and
    grid; the zp model needs 3 samples an axis, the tricubic model 2."""
    nx, ny, nz = grid.shape
    if min(grid.shape) < min_axis:
        raise ValueError(f"{name}: every grid axis needs >= {min_axis} "
                         f"samples, got {grid.shape}")
    table = (("coef2d", coef2d, torch.float32, (nx * ny, nz))
             if members is None else
             ("table", coef2d, torch.float32, (members, nx * ny, nz)))
    return [table,
            ("grid.origin", grid.origin, torch.float32, (3,)),
            ("grid.spacing", grid.spacing, torch.float32, (3,))]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _launch(name: str, fn, *args):
    """Launch on the current stream of the tensors' device; raise on a
    failed launch; count it."""
    lib = build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.ionotomo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}): {msg}")
    launches[name] += 1


def _value_grad(name: str, min_axis: int, coef2d, grid, points):
    n = points.shape[0]
    dev = _check(name, [("points", points, torch.float32, (n, 3))]
                 + _grid_specs(name, coef2d, grid, min_axis))
    value = torch.empty((n,), dtype=torch.float32, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return value, grad
    nx, ny, nz = grid.shape
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, _ptr(coef2d), _ptr(grid.origin),
                _ptr(grid.spacing), nx, ny, nz, _ptr(points), n, _ptr(value),
                _ptr(grad))
    return value, grad


def zp_value_grad(coef2d: torch.Tensor, grid, points: torch.Tensor):
    """K1e: zp value (N,) and physical gradient (N, 3) [1/km] at points
    (N, 3) of the (nx*ny, nz) coefficient table ``coef2d``."""
    return _value_grad("zp_value_grad", 3, coef2d, grid, points)


def zp_value_grad_batched(table: torch.Tensor, grid, points: torch.Tensor,
                          packed: torch.Tensor = None):
    """K1e over a member axis, one launch: value (B, N) and physical
    gradient (B, N, 3) [1/km] at points (N, 3) of each of the B (nx*ny,
    nz) coefficient tables ``table`` (B, nx*ny, nz). The kernel reads the
    tables packed member-innermost: ``packed``, the caller's
    ``pack_members`` of ``table.view(B, -1)`` (the pack K2b's gather of
    the same table reads), or None to pack here. Member b is bitwise
    ``zp_value_grad(table[b], grid, points)``."""
    name = "zp_value_grad_batched"
    if table.dim() != 3:
        raise ValueError(f"{name}: table must be (B, rows, nz), got "
                         f"{tuple(table.shape)}")
    b, n = table.shape[0], points.shape[0]
    nx, ny, nz = grid.shape
    specs = ([("points", points, torch.float32, (n, 3))]
             + _grid_specs(name, table, grid, 3, members=b))
    if packed is not None:
        specs.append(("packed", packed, torch.float32,
                      (-(-b // MEMBER_GROUP), nx * ny * nz, MEMBER_GROUP)))
    dev = _check(name, specs)
    value = torch.empty((b, n), dtype=torch.float32, device=dev)
    grad = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    if n == 0 or b == 0:
        return value, grad
    if packed is None:
        packed = pack_members(table.view(b, -1))
    elif not _aligned(packed):
        raise ValueError(f"{name}: packed must start on a 16-byte boundary")
    lanes = zp_batched_lanes(n * -(-b // MEMBER_GROUP), sm_count(dev))
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, _ptr(packed), b, _ptr(grid.origin),
                _ptr(grid.spacing), nx, ny, nz, _ptr(points), n, lanes,
                ZP_BATCHED_THREADS, _ptr(value), _ptr(grad))
    return value, grad


#: Threads a block of the batched K1e.
ZP_BATCHED_THREADS = 128
#: The batched K1e takes 8 lanes a point (a member each) up to this many
#: points an SM, else 4 (two members each). More lanes cut each lane's
#: chain of members and fill an idle card, but each repeats the point's
#: set-up, and the lanes' registers (48 at 8 lanes, 64 at 4) decide how
#: many warps the card holds. ``chip_smoke.py --member-study`` (NVIDIA
#: H100 80GB HBM3, 700 W, 128 threads a block), 1 / 2 / 4 / 8 lanes: 8
#: fastest at 1,240 endpoints and 2,500 and 5,000 uniform points (9-38
#: points an SM), 4 from 10,000 (76 an SM) to 640,000 and at the 917,504
#: edge-case points; 2 tie 4 at 20,000 and read 10 % faster at 40,000
#: uniform points; 1 never fastest.
ZP_BATCHED_EIGHT_LANES_PER_SM = 48


def zp_batched_lanes(n_items: int, sms: int) -> int:
    """The lanes a point of the batched K1e over n_items (points times
    groups of 8 members) on a card of ``sms`` SMs."""
    return 8 if n_items <= ZP_BATCHED_EIGHT_LANES_PER_SM * sms else 4


def cubic_value_grad(field2d: torch.Tensor, grid, points: torch.Tensor):
    """K5: tricubic value (N,) and physical gradient (N, 3) [1/km] at
    points (N, 3) of the field reshaped to (nx*ny, nz)."""
    return _value_grad("cubic_value_grad", 2, field2d, grid, points)


def zpc_value_grad(coef2d: torch.Tensor, grid, points: torch.Tensor):
    """K6z: zpc value (N,) and physical gradient (N, 3) [1/km] at points
    (N, 3) of the (nx*ny, nz) table ``coef2d`` (``core.zpcubic.prefilter``
    reshaped)."""
    return _value_grad("zpc_value_grad", 3, coef2d, grid, points)


def quad_value_grad(coef2d: torch.Tensor, grid, points: torch.Tensor):
    """K6q: triquadratic value (N,) and physical gradient (N, 3) [1/km] at
    points (N, 3) of the (nx*ny, nz) coefficient table ``coef2d``
    (``core.triquadratic.prefilter`` reshaped)."""
    return _value_grad("quad_value_grad", 3, coef2d, grid, points)


#: The shapes K2 runs with K and L fixed, the main paths' (zp: K=8, L=3,
#: xy first; zpc: K=8, L=4, xy first; cubic: K=16, L=4, z first), as (K,
#: L, xy_first); only these take a point order.
K2_FIXED_SHAPES = ((8, 3, True), (8, 4, True), (16, 4, False))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rows_value_fwd(table: torch.Tensor, ri: torch.Tensor, wxy: torch.Tensor,
                   zi: torch.Tensor, wz: torch.Tensor, xy_first: bool,
                   order: torch.Tensor = None) -> torch.Tensor:
    """K2: out[n] = Σ_k wxy[n,k] Σ_l wz[n,l] table[ri[n,k], zi[n,l]].

    table (rows, nz) f32; ri (N, K) int32, wxy (N, K) f32 with K ≤ 16;
    zi (N, L) int32, wz (N, L) f32 with L ≤ 4. Unbatched only. order:
    None (ray order), or (N,) int32 with ri, wxy, zi and wz permuted into
    it (row t is point order[t]'s, ``permute_points``): thread t computes
    row t and writes out[order[t]], so that a warp holds neighbouring
    stencils (``point_order``). The order needs a shape of
    ``K2_FIXED_SHAPES`` and the four arrays 16-byte aligned, as the
    permute makes them; other calls run K2's generic kernel. Every
    point's output is bitwise the same in any order and either kernel."""
    name = "rows_value_fwd"
    if table.dim() != 2 or ri.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: table, ri and zi must be 2-D, got "
                         f"{table.dim()}, {ri.dim()}, {zi.dim()}")
    n, k = ri.shape
    l = zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    specs = [("ri", ri, torch.int32, (n, k)),
             ("table", table, torch.float32, tuple(table.shape)),
             ("wxy", wxy, torch.float32, (n, k)),
             ("zi", zi, torch.int32, (n, l)),
             ("wz", wz, torch.float32, (n, l))]
    if order is not None:
        specs.append(("order", order, torch.int32, (n,)))
        if ((k, l, bool(xy_first)) not in K2_FIXED_SHAPES
                or not _aligned(ri, wxy, zi, wz)):
            raise ValueError(
                f"{name}: a point order needs (K, L, xy_first) in "
                f"{K2_FIXED_SHAPES} and 16-byte aligned inputs, got "
                f"({k}, {l}, {bool(xy_first)})")
    dev = _check(name, specs)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_rows_value_fwd", _ptr(table), table.shape[0],
                table.shape[1], _ptr(ri), _ptr(wxy), k, _ptr(zi), _ptr(wz),
                l, n, int(bool(xy_first)), _ptr(order), _ptr(out))
    return out


#: The rules by which a field model's set-up places a point's stencil
#: base cell (``csrc/rows_value_fwd.cu:PointRule``), each the rule of a
#: model's ``base_cell`` and named by its ``POINT_RULE``: "cubic" floors
#: all three axes into [0, n−2] (``core.tricubic``), "zp" rounds half to
#: even all three into [1, n−2] (``core.boxspline``), "zpc" rounds x and y
#: as zp and floors z as cubic (``core.zpcubic``).
POINT_RULES = ("cubic", "zp", "zpc")


def point_order_keys(points: torch.Tensor, grid, rule: str) -> torch.Tensor:
    """The (N,) int32 sort keys of ``point_order``: each point's stencil
    base cell (bx, by, bz) under the model's ``rule`` (``POINT_RULES``),
    recomputed from the points (N, 3) as the model's set-up computes it,
    as (bx·ny + by)·nz + bz; one kernel on the card (plain version:
    ``point_order_keys_plain`` over the model's ``base_cell``; oracle:
    ``point_order_keys_ref`` of the set-up's own rows)."""
    name = "point_order_keys"
    n = points.shape[0]
    nx, ny, nz = grid.shape
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"{name}: the key needs nx*ny*nz < 2^31")
    dev = _check(name, [("points", points, torch.float32, (n, 3)),
                        ("grid.origin", grid.origin, torch.float32, (3,)),
                        ("grid.spacing", grid.spacing, torch.float32, (3,))])
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return keys
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_point_order_keys", _ptr(points), n,
                _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
                POINT_RULES.index(rule), _ptr(keys))
    return keys


def point_order_keys_plain(points: torch.Tensor, grid, base_cell
                           ) -> torch.Tensor:
    """Plain PyTorch version of ``point_order_keys``: the base cell that
    the model's own ``base_cell(grid, points)`` gives, each axis into [0,
    n−1] as the set-up's row and z tap are, as (bx·ny + by)·nz + bz."""
    base = base_cell(grid, points)[1]
    b = [base[:, d].to(torch.int32).long().clamp(0, grid.shape[d] - 1)
         for d in range(3)]
    _, ny, nz = grid.shape
    return ((b[0] * ny + b[1]) * nz + b[2]).to(torch.int32)


def point_order_keys_ref(ri: torch.Tensor, zi: torch.Tensor, base: int,
                         grid_shape) -> torch.Tensor:
    """The keys as the set-up's own rows hold them, the oracle of
    ``point_order_keys`` and ``point_order_keys_plain``: each point's
    stencil base cell, the row ri[:, base] and iz from zi[:, 1] (zi[:, 0]
    at L = 1), both clamped into the table, as row·nz + iz."""
    nx, ny, nz = grid_shape
    r = ri[:, base].long().clamp(0, nx * ny - 1)
    z = zi[:, min(1, zi.shape[1] - 1)].long().clamp(0, nz - 1)
    return (r * nz + z).to(torch.int32)


def permute_points(order: torch.Tensor, ri: torch.Tensor, wxy: torch.Tensor,
                   zi: torch.Tensor, wz: torch.Tensor):
    """(ri, wxy, zi, wz) of a point set permuted into ``order`` (N,) int32,
    row t of each the input's row order[t], the bits as they are, one
    kernel on the card (plain version: ``t[order.long()]``)."""
    name = "permute_points"
    n, k, l, specs = _rows_specs(name, ri, wxy, zi, wz)
    dev = _check(name, [("order", order, torch.int32, (n,))] + specs)
    out = [torch.empty_like(t) for t in (ri, wxy, zi, wz)]
    if n == 0:
        return tuple(out)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_permute_points", _ptr(order), n, _ptr(ri),
                _ptr(wxy), k, _ptr(zi), _ptr(wz), l,
                int(_aligned(ri, wxy, zi, wz, *out)), *map(_ptr, out))
    return tuple(out)


def point_order(points: torch.Tensor, grid, rule: str, base_cell
                ) -> torch.Tensor:
    """(N,) int32: the points (N, 3) sorted by their stencil's base cell
    as the model places it (its ``POINT_RULE`` and ``base_cell``), row
    then z (``point_order_keys`` on the card, ``point_order_keys_plain``
    on the CPU), the order K2 runs a fixed point set in, so that a warp
    holds points that share rows and sectors; ties in point order (a
    stable sort: the same order every run). No host read."""
    keys = (point_order_keys(points, grid, rule) if points.is_cuda
            else point_order_keys_plain(points, grid, base_cell))
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def _rows_specs(name: str, ri, wxy, zi, wz):
    """(N, K, L, specs) of a row-gather point set: ri (N, K) int32, wxy
    (N, K) f32 with K ≤ 16; zi (N, L) int32, wz (N, L) f32 with L ≤ 4."""
    if ri.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: ri and zi must be 2-D, got {ri.dim()}, "
                         f"{zi.dim()}")
    n, k = ri.shape
    l = zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    return n, k, l, [("ri", ri, torch.int32, (n, k)),
                     ("wxy", wxy, torch.float32, (n, k)),
                     ("zi", zi, torch.int32, (n, l)),
                     ("wz", wz, torch.float32, (n, l))]


#: Members one packed value of ``pack_members`` holds: one 32-byte sector.
MEMBER_GROUP = 8


def pack_members(x: torch.Tensor) -> torch.Tensor:
    """The member-innermost layout K2b and K3b read: x (B, M) f32 →
    (⌈B/8⌉, M, 8) with packed[g, j, m] = x[8g + m, j] and zeros past
    member B − 1, so the 8 members of one element are one aligned 32-byte
    sector (plain version: ``core.tricubic.pack_members_ref``)."""
    name = "pack_members"
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: x must be (B, M) with B, M >= 1, got "
                         f"{tuple(x.shape)}")
    b, m = x.shape
    dev = _check(name, [("x", x, torch.float32, (b, m))])
    packed = torch.empty((-(-b // MEMBER_GROUP), m, MEMBER_GROUP),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_pack_members", _ptr(x), b, m, _ptr(packed))
    return packed


def rows_value_fwd_batched(table: torch.Tensor, ri: torch.Tensor,
                           wxy: torch.Tensor, zi: torch.Tensor,
                           wz: torch.Tensor, xy_first: bool,
                           packed: torch.Tensor = None) -> torch.Tensor:
    """K2b: out[b, n] = Σ_k wxy[n,k] Σ_l wz[n,l] table[b, ri[n,k], zi[n,l]].

    table (B, rows, nz) f32, member-major; ri, wxy, zi, wz as for
    ``rows_value_fwd``, shared by the members. The gather reads the tables
    packed member-innermost: ``packed``, the caller's ``pack_members`` of
    ``table.view(B, -1)`` (shared with the batched K1e of the same table),
    or None to pack here. Returns (B, N); member b is bitwise
    ``rows_value_fwd(table[b], ...)``."""
    name = "rows_value_fwd_batched"
    if table.dim() != 3:
        raise ValueError(f"{name}: table must be (B, rows, nz), got "
                         f"{tuple(table.shape)}")
    n, k, l, specs = _rows_specs(name, ri, wxy, zi, wz)
    b, rows, nz = table.shape
    if packed is not None:
        specs.append(("packed", packed, torch.float32,
                      (-(-b // MEMBER_GROUP), rows * nz, MEMBER_GROUP)))
    dev = _check(name, [("table", table, torch.float32, (b, rows, nz))]
                 + specs)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if n == 0 or b == 0 or rows * nz == 0:
        return out
    if packed is None:
        packed = pack_members(table.view(b, rows * nz))
    elif not _aligned(packed):
        raise ValueError(f"{name}: packed must start on a 16-byte boundary")
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_rows_value_fwd_batched", _ptr(packed), b,
                rows, nz, _ptr(ri), _ptr(wxy), k, _ptr(zi), _ptr(wz), l, n,
                int(bool(xy_first)), _ptr(out))
    return out


def _trace_outputs(name: str, min_axis: int, table, grid, origins,
                   directions, n_steps: int, keep_path: bool):
    """Check a tracer's inputs; (device, x_end, tau, path) allocated."""
    r = origins.shape[0]
    dev = _check(name, [("origins", origins, torch.float32, (r, 3)),
                        ("directions", directions, torch.float32, (r, 3))]
                 + _grid_specs(name, table, grid, min_axis))
    if n_steps < 1:
        raise ValueError(f"{name}: n_steps must be >= 1, got {n_steps}")
    x_end = torch.empty((r, 3), dtype=torch.float32, device=dev)
    tau = torch.empty((r,), dtype=torch.float32, device=dev)
    path = (torch.empty((r, n_steps + 1, 3), dtype=torch.float32, device=dev)
            if keep_path else None)
    return dev, x_end, tau, path


def _consts(h: float, hh12: float, w_n: float, w_rhs: float, k_ne: float,
            tec_unit: float):
    return h, hh12, w_n, w_rhs, k_ne, tec_unit


#: Rays an SM from which K1 sorts the rays (``ray_order``) and packs the
#: table's z taps (``pack_zp_taps``) first. From ``chip_smoke.py
#: --k1-study`` (NVIDIA H100 80GB HBM3, 700 W), the call with its pack and
#: sort against the unpacked tracer in ray order at 32 threads a block:
#: 0.1616 against 0.1568 ms at 384 rays an SM, 0.1787 against 0.1922 at
#: 448; serving's 620 rays (5 an SM) take neither.
TRACE_ZP_RAYS_PER_SM = 448

#: K1r's block at a sorted batch (with the register budget each source
#: gives its K1r: 2, 3, 2 and 4 blocks of 256 an SM on zp, cubic, zpc and
#: quadratic). From ``chip_smoke.py --rk4-study`` (NVIDIA H100 80GB HBM3,
#: 700 W, the tracer alone at 262,144 rays × 64 steps): 256 a block was
#: fastest on every model at its budget, 0.1-3 % before 64 and 128.
TRACE_RK4_THREADS = 256

#: The launch of each call that sorts and packs as K1 does
#: (``_sorted_and_packed``): (rays an SM from which it sorts the rays and
#: packs the table's z taps, its block then, its block below). K1 and K1r
#: on zp, zpc and quadratic take K1's threshold (``--k1-study``); K1z and
#: K1q their own, from ``chip_smoke.py --k1zq-study`` (NVIDIA H100 80GB
#: HBM3, 700 W, the whole call at 10,000-262,144 of the bench's rays): the
#: sorted call beat the table as it is from 384 rays an SM on both (K1z
#: 0.1664 against 0.1892 ms, K1q 0.1806 against 0.2087; at 320, 0.1656
#: against 0.1590 and 0.1839 against 0.1735); K1z's at 64 rays a block
#: (within 1 % of 256 at 262,144 rays, 8 % faster at 640 an SM), K1q's at
#: 256 (4.5 % faster than 64 at 262,144). K1s's leapfrog (``trace_split``)
#: sorts from 768 rays an SM at 128 a block and below packs in ray order at
#: 64 (``SPLIT_PACKED_RAYS_PER_SM``), from the same study at leapfrog@32
#: over the one-layer form: sorted beat packed in ray order from 768 rays
#: an SM (0.1797 against 0.1867 ms; at 640, 0.1687 against 0.1631), 128 a
#: block within 2 % of 64 and 256.
SORT_AND_PACK = {
    "trace_leapfrog_zp": (TRACE_ZP_RAYS_PER_SM, 64, 32),
    "trace_leapfrog_zpc": (384, 64, 32),
    "trace_leapfrog_quad": (384, 256, 32),
    **{f"trace_rk4_{m}": (TRACE_ZP_RAYS_PER_SM, TRACE_RK4_THREADS, 32)
       for m in ("zp", "zpc", "quad")},
    "trace_split": (768, 128, 64),
}

#: Rays an SM from which K1s's leapfrog call packs the perturbation's z
#: taps when it does not sort (``trace_split``); below, it reads the table
#: as it is, ``SPLIT_AS_IS_THREADS`` a block. From ``chip_smoke.py
#: --k1zq-study`` (NVIDIA H100 80GB HBM3, 700 W, leapfrog@32): packed in
#: ray order 0.0965 ms against 0.1227 as it is at 192 rays an SM, 0.0933
#: against 0.0898 at 128; at 10,000 rays as it is, 32 a block, 0.0776
#: against 64's 0.0874.
SPLIT_PACKED_RAYS_PER_SM = 192
SPLIT_AS_IS_THREADS = 32


def sort_and_pack(name: str, n_rays: int, n_sms: int):
    """(sorted and packed, block size) of the call ``name`` (a key of
    ``SORT_AND_PACK``) at ``n_rays`` rays on a card of ``n_sms`` SMs: from
    its threshold of rays an SM the rays sorted and the table packed first,
    below the table as it is in ray order."""
    per_sm, threads, small = SORT_AND_PACK[name]
    if n_rays >= per_sm * n_sms:
        return True, threads
    return False, small


def trace_leapfrog_zp(coef2d: torch.Tensor, grid, origins: torch.Tensor,
                      directions: torch.Tensor, n_steps: int, keep_path: bool,
                      **consts):
    """K1: leapfrog-trace R rays through the zp table for ``n_steps``
    steps of ``h`` km. Returns (x_end (R, 3), tau (R,), path (R,
    n_steps+1, 3) with the origins first, or None without keep_path).
    The f32 constants h, hh12, w_n, w_rhs, k_ne and tec_unit are computed
    by the caller (``geometry.fermat._step_constants``). A batch of
    ``TRACE_ZP_RAYS_PER_SM`` rays an SM or more is sorted (``ray_order``)
    and traced over the table's z taps packed first (``pack_zp_taps``),
    64 rays a block; a smaller one reads the table as it is, in its own
    order, 32 rays a block, so that it spreads over more SMs. Each ray's
    outputs are bitwise those of the unpacked evaluator in ray order."""
    return _sorted_and_packed("trace_leapfrog_zp", trace_leapfrog_zp_with,
                              pack_zp_taps, coef2d, grid, origins,
                              directions, n_steps, keep_path, consts)


def trace_leapfrog_zpc(coef2d: torch.Tensor, grid, origins: torch.Tensor,
                       directions: torch.Tensor, n_steps: int,
                       keep_path: bool, **consts):
    """K1z: as ``trace_leapfrog_zp`` through the zpc table
    (``core.zpcubic.prefilter`` reshaped), over K1c's pack
    (``pack_z_taps``: zpc's z stencil is the tricubic one), at its own
    threshold and blocks (``SORT_AND_PACK``). Each ray's outputs are
    bitwise those of the unpacked evaluator in ray order."""
    return _sorted_and_packed("trace_leapfrog_zpc", trace_leapfrog_zpc_with,
                              pack_z_taps, coef2d, grid, origins,
                              directions, n_steps, keep_path, consts)


def trace_leapfrog_quad(coef2d: torch.Tensor, grid, origins: torch.Tensor,
                        directions: torch.Tensor, n_steps: int,
                        keep_path: bool, **consts):
    """K1q: as ``trace_leapfrog_zp`` through the triquadratic coefficient
    table (``core.triquadratic.prefilter`` reshaped), over K1's pack
    (``pack_zp_taps``: quadratic's z stencil is the zp one), at its own
    threshold and blocks (``SORT_AND_PACK``). Each ray's outputs are
    bitwise those of the unpacked evaluator in ray order."""
    return _sorted_and_packed("trace_leapfrog_quad", trace_leapfrog_quad_with,
                              pack_zp_taps, coef2d, grid, origins,
                              directions, n_steps, keep_path, consts)


def _sorted_and_packed(name, with_fn, pack, table, grid, origins,
                       directions, n_steps, keep_path, consts):
    """K1's call, which K1z, K1q and K1r on zp, zpc and quadratic share,
    at the launch ``sort_and_pack`` gives ``name``: the rays sorted
    (``ray_order``) and the table's z taps packed (``pack``) first, or the
    table as it is in ray order."""
    r = origins.shape[0]
    dev = _check(name, [("origins", origins, torch.float32, (r, 3)),
                        ("directions", directions, torch.float32, (r, 3))]
                 + _grid_specs(name, table, grid, 3))
    sort, threads = sort_and_pack(
        name, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    if not sort:
        return with_fn(table, grid, origins, directions, n_steps, keep_path,
                       packed=None, order=None, threads=threads, **consts)
    return with_fn(table, grid, origins, directions, n_steps, keep_path,
                   packed=pack(table, grid),
                   order=ray_order(origins, directions, grid),
                   threads=threads, **consts)


#: The largest block of a tracer launched at a register budget
#: (``csrc/trace_leapfrog.cuh``: ``kBudgetMaxThreads``): K1r, K1s's rk4, and
#: K1z, K1q and K1s's leapfrog over the packed table. The others take up
#: to 1024.
BUDGET_MAX_THREADS = 256


def _check_threads(name, threads, budgeted):
    """A tracer's block size: a multiple of 32 up to 1024, or up to
    ``BUDGET_MAX_THREADS`` where the launch is ``budgeted``."""
    most = BUDGET_MAX_THREADS if budgeted else 1024
    if threads < 32 or threads > most or threads % 32:
        raise ValueError(f"{name}: threads must be a multiple of 32 from 32 "
                         f"to {most}" + (" (its launch's register budget)"
                                         if budgeted else "")
                         + f", got {threads}")


def _trace_with(name, min_axis, pack_bases, table, grid, origins, directions,
                n_steps, keep_path, packed, order, threads, consts):
    """Launch a leapfrog tracer with its layout, ray order and block size
    given: ``packed`` the (nz − pack_bases, nx*ny, 4) z-tap pack of
    ``table`` or None, ``order`` (R,) int32 or None."""
    _check_threads(name, threads, name.startswith("trace_rk4_") or (
        packed is not None
        and name in ("trace_leapfrog_zpc", "trace_leapfrog_quad")))
    dev, x_end, tau, path = _trace_outputs(name, min_axis, table, grid,
                                           origins, directions, n_steps,
                                           keep_path)
    nx, ny, nz = grid.shape
    r = origins.shape[0]
    specs = []
    if packed is not None:
        specs.append(("packed", packed, torch.float32,
                      (nz - pack_bases, nx * ny, 4)))
    if order is not None:
        specs.append(("order", order, torch.int32, (r,)))
    if specs and _check(name, specs) != dev:
        raise ValueError(f"{name}: packed and order must be on {dev}")
    if r == 0:
        return x_end, tau, path
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, _ptr(table), _ptr(packed),
                _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
                _ptr(origins), _ptr(directions), _ptr(order), r,
                int(n_steps), *_consts(**consts), int(threads),
                _ptr(x_end), _ptr(tau), _ptr(path))
    return x_end, tau, path


def trace_leapfrog_zp_with(coef2d, grid, origins, directions, n_steps: int,
                           keep_path: bool, *, packed, order, threads: int,
                           **consts):
    """K1 with its layout, ray order and block size given (as
    ``trace_leapfrog_cubic_with``): packed, the packed table of ``coef2d``
    (``pack_zp_taps``) or None (the unpacked evaluator); order, (R,)
    int32 ray of each thread, or None; threads, a multiple of 32 up to
    1024."""
    return _trace_with("trace_leapfrog_zp", 3, 2, coef2d, grid, origins,
                       directions, n_steps, keep_path, packed, order, threads,
                       consts)


def trace_leapfrog_zpc_with(coef2d, grid, origins, directions, n_steps: int,
                            keep_path: bool, *, packed, order, threads: int,
                            **consts):
    """K1z with its layout, ray order and block size given: packed, K1c's
    packed table of ``coef2d`` (``pack_z_taps``) or None; over it a block
    of at most ``BUDGET_MAX_THREADS`` (its register budget's)."""
    return _trace_with("trace_leapfrog_zpc", 3, 1, coef2d, grid, origins,
                       directions, n_steps, keep_path, packed, order, threads,
                       consts)


def trace_leapfrog_quad_with(coef2d, grid, origins, directions,
                             n_steps: int, keep_path: bool, *, packed, order,
                             threads: int, **consts):
    """K1q with its layout, ray order and block size given: packed, K1's
    packed table of ``coef2d`` (``pack_zp_taps``) or None; over it a block
    of at most ``BUDGET_MAX_THREADS`` (its register budget's)."""
    return _trace_with("trace_leapfrog_quad", 3, 2, coef2d, grid, origins,
                       directions, n_steps, keep_path, packed, order, threads,
                       consts)


def pack_zp_taps(coef2d: torch.Tensor, grid) -> torch.Tensor:
    """K1's pack: the (nz−2, nx*ny, 4) f32 table whose entry [b−1, row] is
    the three z taps of ``row`` at z base b, (b−1, b, b+1), and a zero,
    for b in [1, nz−2], base-major (plain version:
    ``core.boxspline.pack_z_taps_ref``)."""
    name = "pack_zp_taps"
    nx, ny, nz = grid.shape
    dev = _check(name, _grid_specs(name, coef2d, grid, 3))
    packed = torch.empty((nz - 2, nx * ny, 4), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_pack_zp_taps", _ptr(coef2d), nx * ny, nz,
                _ptr(packed))
    return packed


#: Rays K1c holds on one SM at once (two blocks of 256 at its 96
#: registers a thread): a batch of at least this many rays an SM fills
#: the card. From ``chip_smoke.py --k1c-study`` (NVIDIA H100 80GB HBM3):
#: at 262,144 rays the ray order takes the tracer from 1.54 to 1.06 ms
#: for 0.06 ms of sorting, and 256 threads a block beat 64 and 128; at
#: config 2's 6,200 rays the sort costs 0.04 ms and gains 0.01, and 64
#: threads a block (97 blocks) beat 256 (25 blocks, 25 SMs busy).
TRACE_CUBIC_RAYS_PER_SM = 512


def pack_z_taps(field2d: torch.Tensor, grid) -> torch.Tensor:
    """K1c's pack: the (nz−1, nx*ny, 4) f32 table whose entry [b, row] is
    the four z taps of ``row`` at cell base b, (clamp(b−1), b, b+1,
    clamp(b+2)), base-major (plain version:
    ``core.tricubic.pack_z_taps_ref``)."""
    name = "pack_z_taps"
    nx, ny, nz = grid.shape
    dev = _check(name, _grid_specs(name, field2d, grid, 2))
    packed = torch.empty((nz - 1, nx * ny, 4), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_pack_z_taps", _ptr(field2d), nx * ny, nz,
                _ptr(packed))
    return packed


def ray_order_keys(origins: torch.Tensor, directions: torch.Tensor, grid
                   ) -> torch.Tensor:
    """The (R,) int32 sort keys of ``ray_order``, one kernel on the card
    (plain version: ``ray_order_keys_ref``)."""
    name = "ray_order_keys"
    r = origins.shape[0]
    nx, ny, _ = grid.shape
    dev = _check(name, [("origins", origins, torch.float32, (r, 3)),
                        ("directions", directions, torch.float32, (r, 3)),
                        ("grid.origin", grid.origin, torch.float32, (3,)),
                        ("grid.spacing", grid.spacing, torch.float32, (3,))])
    keys = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return keys
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_ray_order_keys", _ptr(origins),
                _ptr(directions), _ptr(grid.origin), _ptr(grid.spacing), nx,
                ny, r, _ptr(keys))
    return keys


def ray_order_keys_ref(origins: torch.Tensor, directions: torch.Tensor,
                       grid) -> torch.Tensor:
    """Plain PyTorch version of the sort keys ``ray_order`` makes on the
    card: (R,) int32, the Z-order code of each direction's (x, y) in 256
    steps over [−1, 1] above that of its origin's (x, y) in 256 steps over
    the grid's extent, offset by −2³¹ so that signed order is the code's
    order."""
    def quantize(v):
        return (v * 256.0).clamp(0.0, 255.0).to(torch.int64)

    def spread(v):          # 8 bits to the even bits of 16
        v = (v | (v << 4)) & 0x0F0F
        v = (v | (v << 2)) & 0x3333
        return (v | (v << 1)) & 0x5555

    def morton(q):
        return spread(q[:, 0]) | (spread(q[:, 1]) << 1)

    qd = quantize(0.5 * (directions[:, :2] + 1.0))
    n = torch.tensor(grid.shape[:2], dtype=torch.float32,
                     device=origins.device) - 1.0
    qo = quantize((origins[:, :2] - grid.origin[:2])
                  / (grid.spacing[:2] * n))
    key = (morton(qd) << 16) | morton(qo)
    return (key - 2 ** 31).to(torch.int32)


def ray_order(origins: torch.Tensor, directions: torch.Tensor, grid
              ) -> torch.Tensor:
    """(R,) int32: the rays sorted by direction, then along the Z-order
    curve of their origins (the keys of ``ray_order_keys_ref``, made on
    the card by ``ray_order_keys``). Consecutive rays, a warp of K1 or
    K1c, are then parallel rays from neighbouring origins: they keep
    their distances at every height and reach each cell base at the same
    step, so they share table rows and cache sectors the whole way. Ties
    sort in no fixed order: a ray's outputs do not depend on its place.
    No host read."""
    keys = (ray_order_keys(origins, directions, grid) if origins.is_cuda
            else ray_order_keys_ref(origins, directions, grid))
    return torch.sort(keys).indices.to(torch.int32)


def trace_leapfrog_cubic(field2d: torch.Tensor, grid, origins: torch.Tensor,
                         directions: torch.Tensor, n_steps: int,
                         keep_path: bool, **consts):
    """K1c: as ``trace_leapfrog_zp`` through the tricubic model of the
    field reshaped to (nx*ny, nz). The call packs the table's z taps
    (``pack_z_taps``) and traces over them; a batch that fills the card
    (``TRACE_CUBIC_RAYS_PER_SM`` rays an SM) is first sorted
    (``ray_order``) and traced 256 rays a block, a smaller one in its own
    order 64 rays a block, so that it spreads over more SMs. Each ray's
    outputs are bitwise those of the unpacked evaluator in ray order."""
    return _cubic_call("trace_leapfrog_cubic", trace_leapfrog_cubic_with,
                       field2d, grid, origins, directions, n_steps,
                       keep_path, consts)


def _cubic_call(name, with_fn, table, grid, origins, directions, n_steps,
                keep_path, consts, threads=256):
    """K1c's call, which K1r on cubic and K1s's rk4 share: the table's z taps
    packed (``pack_z_taps``); a batch that fills the card
    (``TRACE_CUBIC_RAYS_PER_SM`` rays an SM) sorted first (``ray_order``)
    and traced ``threads`` rays a block, a smaller one in its own order 64
    rays a block."""
    dev = _check(name, _grid_specs(name, table, grid, 2))
    fills = origins.shape[0] >= TRACE_CUBIC_RAYS_PER_SM * \
        torch.cuda.get_device_properties(dev).multi_processor_count
    return with_fn(
        table, grid, origins, directions, n_steps, keep_path,
        packed=pack_z_taps(table, grid),
        order=ray_order(origins, directions, grid) if fills else None,
        threads=threads if fills else 64, **consts)


def trace_leapfrog_cubic_with(field2d, grid, origins, directions,
                              n_steps: int, keep_path: bool, *, packed,
                              order, threads: int, **consts):
    """K1c with its layout, ray order and block size given:
    ``trace_leapfrog_cubic`` passes its own; the card tests and
    ``chip_smoke.py`` pass others to hold the kernel to its unpacked
    arithmetic and to measure what binds it. packed: the packed table of
    ``field2d`` (``pack_z_taps``), which the tracer reads in its place, or
    None (the unpacked evaluator); order: (R,) int32 ray of each thread,
    or None; threads: a multiple of 32 up to 1024."""
    return _trace_with("trace_leapfrog_cubic", 2, 1, field2d, grid, origins,
                       directions, n_steps, keep_path, packed, order, threads,
                       consts)


def trace_split(pert2d: torch.Tensor, grid, origins: torch.Tensor,
                directions: torch.Tensor, n_steps: int, keep_path: bool, *,
                rk4: bool, background: dict, **consts):
    """K1s: trace R rays for ``n_steps`` steps (leapfrog, or rk4 with
    ``rk4``) through n_e = the closed-form Chapman background + the
    tricubic model of the perturbation table ``pert2d`` (nx*ny, nz) [m⁻³].
    ``background``: the kernel's parameters
    (``models.chapman.ChapmanBackground.kernel_params``): ``layers`` (L, 4)
    f32 (n_peak, h_peak, scale, sensitivity) on the rays' device and their
    host copy ``rows``, and the floats ``factor``, ``zc0``, ``r_earth``,
    ``ps_n0``, ``ps_scale``, ``h_top`` and the bool ``curved``; the kernel
    takes its form (``split_form``). Leapfrog takes its own call: from
    ``SORT_AND_PACK["trace_split"]``'s rays an SM the rays sorted and the
    table's z taps packed, from ``SPLIT_PACKED_RAYS_PER_SM`` the table
    packed in ray order, below it the table as it is; rk4 takes K1c's call
    (``_cubic_call``). Returns (x_end, tau, path or None); each ray's
    outputs bitwise those of the unpacked evaluator in ray order."""
    consts = dict(consts, rk4=rk4, background=background)
    if rk4:
        return _cubic_call("trace_split", trace_split_with, pert2d, grid,
                           origins, directions, n_steps, keep_path, consts)
    name = "trace_split"
    dev = _check(name, _grid_specs(name, pert2d, grid, 2))
    r, sms = origins.shape[0], \
        torch.cuda.get_device_properties(dev).multi_processor_count
    sort, threads = sort_and_pack(name, r, sms)
    pack = sort or r >= SPLIT_PACKED_RAYS_PER_SM * sms
    return trace_split_with(
        pert2d, grid, origins, directions, n_steps, keep_path,
        packed=pack_z_taps(pert2d, grid) if pack else None,
        order=ray_order(origins, directions, grid) if sort else None,
        threads=threads if pack else SPLIT_AS_IS_THREADS, **consts)


def split_form(background: dict) -> str:
    """The form of K1s's background (``csrc/trace_split.cu``) that
    ``background`` (``ChapmanBackground.kernel_params``) takes: "layer",
    one layer of sensitivity 1 over the flat Earth without a plasmasphere
    (``background_ne_fn()`` and its cos χ variants), its parameters passed
    as numbers; else "general", the layers read from ``layers``. Decided
    from the host's copy of the parameters (``rows``), so no read of the
    card."""
    rows = background["rows"]
    one = (len(rows) == 1 and rows[0][3] == 1.0
           and not background["curved"] and background["ps_n0"] == 0.0)
    return "layer" if one else "general"


def trace_split_with(pert2d, grid, origins, directions, n_steps: int,
                     keep_path: bool, *, packed, order, threads: int,
                     rk4: bool, background: dict, form: str = None,
                     **consts):
    """K1s with its layout, ray order and block size given (as
    ``trace_leapfrog_cubic_with``), over the background's own form
    (``split_form``) or the ``form`` given: "general" takes any
    background, "layer" only one that ``split_form`` calls so."""
    name = "trace_split"
    form = split_form(background) if form is None else form
    if form not in ("layer", "general") or (
            form == "layer" and split_form(background) != "layer"):
        raise ValueError(f"{name}: no form {form!r} for this background")
    # rk4, and leapfrog over the packed table (K1S_BUDGET), at a budget
    _check_threads(name, threads, rk4 or packed is not None)
    dev, x_end, tau, path = _trace_outputs(name, 2, pert2d, grid, origins,
                                           directions, n_steps, keep_path)
    layers = background["layers"]
    if layers.dim() != 2 or layers.shape[0] < 1 or layers.shape[1] != 4:
        raise ValueError(f"{name}: background layers must be (L >= 1, 4), "
                         f"got {tuple(layers.shape)}")
    nx, ny, nz = grid.shape
    r = origins.shape[0]
    specs = [("background.layers", layers, torch.float32,
              tuple(layers.shape))]
    if packed is not None:
        specs.append(("packed", packed, torch.float32, (nz - 1, nx * ny, 4)))
    if order is not None:
        specs.append(("order", order, torch.int32, (r,)))
    if _check(name, specs) != dev:
        raise ValueError(f"{name}: layers, packed and order must be on "
                         f"{dev}")
    if not _aligned(layers):
        raise ValueError(f"{name}: layers must start on a 16-byte boundary")
    if r == 0:
        return x_end, tau, path
    b = background
    head = (_ptr(pert2d), _ptr(packed), _ptr(grid.origin),
            _ptr(grid.spacing), nx, ny, nz, _ptr(origins), _ptr(directions),
            _ptr(order), r, int(n_steps), int(bool(rk4)), consts["h"],
            consts["hh12"], consts["w_n"], consts["w_rhs"],
            consts["tec_unit"])
    if form == "layer":
        n_peak, h_peak, scale, _ = b["rows"][0]
        mid = (n_peak, h_peak, scale, b["factor"])
    else:
        mid = (_ptr(layers), layers.shape[0], b["factor"],
               int(bool(b["curved"])), b["zc0"], b["r_earth"], b["ps_n0"],
               b["ps_scale"], b["h_top"])
    entry = "ionotomo_trace_split" + ("_layer" if form == "layer" else "")
    with torch.cuda.device(dev):
        _launch(name, entry, *head, *mid, int(threads), _ptr(x_end),
                _ptr(tau), _ptr(path))
    return x_end, tau, path


def _rk4_tracer(model, policy, min_axis, pack_bases):
    """K1r on ``model`` (``trace_rk4_<model>``, counted under that name):
    its call and its ``_with``, those of the model's leapfrog tracer with
    the rk4 integrator, four evaluations a step, at a sorted batch
    ``TRACE_RK4_THREADS`` rays a block. ``policy``: the leapfrog
    tracer's call (``_sorted_and_packed`` over its pack, at K1's
    threshold, ``SORT_AND_PACK``; or ``_cubic_call``); ``min_axis``,
    ``pack_bases``: its ``_trace_with`` layout."""
    name = "trace_rk4_" + model

    def with_layout(table, grid, origins, directions, n_steps: int,
                    keep_path: bool, *, packed, order, threads: int,
                    **consts):
        return _trace_with(name, min_axis, pack_bases, table, grid,
                           origins, directions, n_steps, keep_path, packed,
                           order, threads, consts)

    def call(table, grid, origins, directions, n_steps: int,
             keep_path: bool, **consts):
        return policy(name, with_layout, table, grid, origins, directions,
                      n_steps, keep_path, consts)

    call.__name__, with_layout.__name__ = name, name + "_with"
    call.__doc__ = (f"K1r on {model}: ``trace_leapfrog_{model}``'s call "
                    f"with the rk4 integrator. Each ray's outputs are "
                    f"bitwise those of the unpacked evaluator in ray order.")
    with_layout.__doc__ = (f"K1r on {model} with its layout, ray order and "
                           f"block size given (as "
                           f"``trace_leapfrog_{model}_with``; a block of at "
                           f"most 256, K1r's register budget's).")
    return call, with_layout


def _packed_by(pack):
    """``_sorted_and_packed`` over ``pack``, as a tracer's call."""
    return lambda name, with_fn, *args, **kw: _sorted_and_packed(
        name, with_fn, pack, *args, **kw)


trace_rk4_zp, trace_rk4_zp_with = _rk4_tracer(
    "zp", _packed_by(pack_zp_taps), 3, 2)
trace_rk4_cubic, trace_rk4_cubic_with = _rk4_tracer(
    "cubic", lambda *args: _cubic_call(*args, threads=TRACE_RK4_THREADS), 2,
    1)
trace_rk4_zpc, trace_rk4_zpc_with = _rk4_tracer(
    "zpc", _packed_by(pack_z_taps), 3, 1)
trace_rk4_quad, trace_rk4_quad_with = _rk4_tracer(
    "quad", _packed_by(pack_zp_taps), 3, 2)


def _plan_specs(name: str, plan, n_points):
    """Specs of a ``core.tricubic.RowPlan`` over n_points points; raises
    unless the current stream is the one the plan was built on (calls on
    two streams would share its counters)."""
    if plan.counters.is_cuda and (torch.cuda.current_stream(
            plan.counters.device).cuda_stream != plan.stream):
        raise ValueError(f"{name}: the plan was built on another CUDA "
                         f"stream; build one on the stream of this call")
    n_rows = plan.n_rows
    return [("plan.order", plan.order, torch.int32,
             (n_points * plan.live,)),
            ("plan.offsets", plan.offsets, torch.int32, (n_rows + 1,)),
            ("plan.seg_row", plan.seg_row, torch.int32, (plan.n_seg_max,)),
            ("plan.row_seg", plan.row_seg, torch.int32, (n_rows + 1,)),
            ("plan.counters", plan.counters, torch.int32, (n_rows,))]


def _plan_args(plan, nz, dev, members: int = 1):
    """The plan's pointers and sizes as the reduce kernels take them, and
    the call's scratch for partial rows (one set per member)."""
    partials = torch.empty((members * plan.n_seg_max, nz),
                           dtype=torch.float32, device=dev)
    return (_ptr(plan.order), _ptr(plan.offsets), _ptr(plan.seg_row),
            _ptr(plan.row_seg), _ptr(plan.counters)), partials


def rows_value_bwd(ct: torch.Tensor, plan, wxy: torch.Tensor,
                   zi: torch.Tensor, wz: torch.Tensor, nz: int
                   ) -> torch.Tensor:
    """K3: table_ct (plan.n_rows, nz) with table_ct[ri[n,k], zi[n,l]] +=
    ct[n]·wxy[n,k]·wz[n,l], reduced per row in the order of ``plan``
    (``core.tricubic.build_row_plan`` of ri: the flat pair ids n·K + k,
    k < plan.live, sorted by row and z and cut into segments). ct (N,)
    f32; wxy (N, K) f32 with K ≤ 16; zi (N, L) int32, wz (N, L) f32 with
    L ≤ 4. Deterministic: no float atomics. Runs on the stream the plan
    was built on and raises on another (the plan's counters are shared)."""
    name = "rows_value_bwd"
    if wxy.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: wxy and zi must be 2-D, got {wxy.dim()}, "
                         f"{zi.dim()}")
    n, k = wxy.shape
    l = zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    if plan.stride != k:
        raise ValueError(f"{name}: the plan's pair ids step by "
                         f"{plan.stride} per point, wxy has K={k}")
    n_rows = plan.n_rows
    if not (1 <= nz <= MAX_NZ_REDUCE and n_rows >= 1):
        raise ValueError(f"{name}: needs n_rows >= 1 and 1 <= nz <= "
                         f"{MAX_NZ_REDUCE}, got {n_rows}, {nz}")
    dev = _check(name, [("ct", ct, torch.float32, (n,)),
                        ("wxy", wxy, torch.float32, (n, k)),
                        ("zi", zi, torch.int32, (n, l)),
                        ("wz", wz, torch.float32, (n, l))]
                 + _plan_specs(name, plan, n))
    out = torch.empty((n_rows, nz), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ptrs, partials = _plan_args(plan, nz, dev)
        _launch(name, "ionotomo_rows_value_bwd", _ptr(ct), _ptr(wxy), k,
                _ptr(zi), _ptr(wz), l, nz, *ptrs, n_rows, plan.n_seg_max,
                plan.chunk, _ptr(partials), _ptr(out))
    return out


def rows_value_bwd_batched(ct: torch.Tensor, plan, wxy: torch.Tensor,
                           zi: torch.Tensor, wz: torch.Tensor, nz: int
                           ) -> torch.Tensor:
    """K3b: table_ct (B, plan.n_rows, nz) with table_ct[b, ri[n,k],
    zi[n,l]] += ct[b,n]·wxy[n,k]·wz[n,l] over the one ``plan`` the members
    share. ct (B, N) f32; wxy, zi, wz as for ``rows_value_bwd``. Three
    launches: the cotangent packed member-innermost (``pack_members``), the
    reduce (every row of one segment written; a row of several leaves each
    segment's partial rows inside the segment's z span, and the span), and
    ``fold_member_rows`` (the rows of several segments, each member's
    spans summed in segment order; not launched where the plan's pairs are
    too few for any row to have several). Deterministic: no float
    atomics; member b is bitwise ``rows_value_bwd(ct[b], plan, ...)``.
    Leaves the plan's counters alone, but runs on the stream the plan was
    built on and raises on another, as K3 does."""
    name = "rows_value_bwd_batched"
    if ct.dim() != 2 or wxy.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: ct, wxy and zi must be 2-D, got "
                         f"{ct.dim()}, {wxy.dim()}, {zi.dim()}")
    b, n = ct.shape
    k, l = wxy.shape[1], zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    if plan.stride != k:
        raise ValueError(f"{name}: the plan's pair ids step by "
                         f"{plan.stride} per point, wxy has K={k}")
    n_rows = plan.n_rows
    if not (1 <= nz <= MAX_NZ_REDUCE and n_rows >= 1 and b >= 1):
        raise ValueError(f"{name}: needs B >= 1, n_rows >= 1 and 1 <= nz <= "
                         f"{MAX_NZ_REDUCE}, got {b}, {n_rows}, {nz}")
    dev = _check(name, [("ct", ct, torch.float32, (b, n)),
                        ("wxy", wxy, torch.float32, (n, k)),
                        ("zi", zi, torch.int32, (n, l)),
                        ("wz", wz, torch.float32, (n, l))]
                 + _plan_specs(name, plan, n))
    out = torch.empty((b, n_rows, nz), dtype=torch.float32, device=dev)
    ctp = pack_members(ct) if n > 0 else ct     # no pair reads ct then
    spans = torch.empty((plan.n_seg_max, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        ptrs, partials = _plan_args(plan, nz, dev, members=b)
        _launch(name, "ionotomo_rows_value_bwd_batched", _ptr(ctp), b, n,
                _ptr(wxy), k, _ptr(zi), _ptr(wz), l, nz, *ptrs[:4], n_rows,
                plan.n_seg_max, plan.chunk, _ptr(partials), _ptr(spans),
                _ptr(out))
    return fold_member_rows(partials.view(b, plan.n_seg_max, nz), plan, out,
                            spans)


#: Blocks of K3b's fold an SM, up to the plan's bound on its rows of
#: several segments: the grid strides the plan's list of them.
#: ``chip_smoke.py --member-study`` (NVIDIA H100 80GB HBM3, 700 W), at
#: config 5's outer / inner bundle: 8 blocks an SM 0.0193 / 0.0098 ms, 64
#: 0.0188 / 0.0111.
FOLD_BLOCKS_PER_SM = 8


def fold_member_rows(partials: torch.Tensor, plan, out: torch.Tensor,
                     spans: torch.Tensor) -> torch.Tensor:
    """K3b's second pass, in place: for every row r of several segments
    in ``plan`` (``plan.multi_rows``), every member b and every z,
    out[b, r, z] = the partial rows partials[b, s, z] of r's segments s
    whose z span spans[s] = (lo, hi) covers z, summed in segment order from
    0.0, and 0.0 where none does (rows of one segment are left as they
    are; a partial row is read only inside its span). partials (B,
    n_seg_max, nz), out (B, n_rows, nz) f32, spans (n_seg_max, 2) int32;
    returns ``out`` (plain version: ``core.tricubic.fold_member_rows_ref``).
    A plan whose rows all fit in one segment launches nothing."""
    name = "fold_member_rows"
    if partials.dim() != 3 or out.dim() != 3:
        raise ValueError(f"{name}: partials and out must be 3-D, got "
                         f"{partials.dim()}, {out.dim()}")
    b, _, nz = out.shape
    listed = plan.multi_rows.shape[0]
    dev = _check(name, [("partials", partials, torch.float32,
                         (b, plan.n_seg_max, nz)),
                        ("out", out, torch.float32, (b, plan.n_rows, nz)),
                        ("spans", spans, torch.int32, (plan.n_seg_max, 2)),
                        ("plan.row_seg", plan.row_seg, torch.int32,
                         (plan.n_rows + 1,)),
                        ("plan.multi_rows", plan.multi_rows, torch.int32,
                         (listed,)),
                        ("plan.n_multi", plan.n_multi, torch.int32, (1,))])
    if b == 0 or nz == 0 or listed == 0:
        return out
    blocks = min(listed, FOLD_BLOCKS_PER_SM * sm_count(dev))
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_fold_member_rows", _ptr(plan.multi_rows),
                _ptr(plan.n_multi), listed, _ptr(plan.row_seg), plan.n_rows,
                _ptr(spans), _ptr(partials), b, plan.n_seg_max, nz, blocks,
                _ptr(out))
    return out


def _value_grad_bwd(name: str, min_axis: int, grid, points, ct_value,
                    ct_grad, plan, out, before=(), after=(), specs=()):
    """Launch a transpose of K1e or K5 over ``plan`` into ``out`` (nx*ny,
    nz): the kernel's own arguments ``before`` the plan's pointers and
    ``after`` them, its own tensors' ``specs``."""
    nx, ny, nz = grid.shape
    n = points.shape[0]
    if (min(grid.shape) < min_axis or nz > MAX_NZ_REDUCE
            or plan.n_rows != nx * ny):
        raise ValueError(f"{name}: every grid axis needs >= {min_axis} "
                         f"samples, nz <= {MAX_NZ_REDUCE} and a plan over "
                         f"nx*ny rows, got {grid.shape} and {plan.n_rows} "
                         f"rows")
    dev = _check(name, [("points", points, torch.float32, (n, 3)),
                        ("ct_value", ct_value, torch.float32, (n,)),
                        ("ct_grad", ct_grad, torch.float32, (n, 3)),
                        ("grid.origin", grid.origin, torch.float32, (3,)),
                        ("grid.spacing", grid.spacing, torch.float32, (3,)),
                        ("out", out, torch.float32, (nx * ny, nz))]
                 + _plan_specs(name, plan, n) + list(specs))
    if plan.n_seg_max == 0:     # no pairs, and no row to write
        return out
    with torch.cuda.device(dev):
        ptrs, partials = _plan_args(plan, nz, dev)
        _launch(name, "ionotomo_" + name, _ptr(grid.origin),
                _ptr(grid.spacing), nx, ny, nz, _ptr(points), _ptr(ct_value),
                _ptr(ct_grad), *before, *ptrs, *after, plan.n_seg_max,
                plan.chunk, _ptr(partials), _ptr(out))
    return out


def zp_value_grad_bwd(grid, points: torch.Tensor, ct_value: torch.Tensor,
                      ct_grad: torch.Tensor, plan) -> torch.Tensor:
    """K1eᵀ: the (nx*ny, nz) table cotangent of K1e for a value cotangent
    (N,) and a physical-gradient cotangent (N, 3) at points (N, 3). The
    plan lists the flat (point, translate) pair ids n·stride + t, t <
    plan.live ≤ stride ≤ 8, sorted by row and z and cut into segments
    (``core.boxspline.endpoint_plan``). Deterministic: no float atomics.
    Runs on the stream the plan was built on and raises on another."""
    name = "zp_value_grad_bwd"
    if not 1 <= plan.live <= plan.stride <= 8:
        raise ValueError(f"{name}: needs 1 <= live <= stride <= 8, got "
                         f"{plan.live}, {plan.stride}")
    nx, ny, nz = grid.shape
    out = torch.empty((nx * ny, nz), dtype=torch.float32,
                      device=points.device)
    return _value_grad_bwd(name, 3, grid, points, ct_value, ct_grad, plan,
                           out, before=(plan.stride,))


def cubic_value_grad_bwd(table: torch.Tensor, grid, points: torch.Tensor,
                         ct_value: torch.Tensor, ct_grad: torch.Tensor,
                         plan) -> torch.Tensor:
    """K5ᵀ, accumulating: adds into ``table`` (nx*ny, nz), in place, the
    table cotangent of K5 for a value cotangent (N,) and a
    physical-gradient cotangent (N, 3) at points (N, 3), and returns
    ``table``. Only the cells the points' stencils touch are read and
    written; each becomes table + (the sum the reduction forms), rounded
    once. The plan lists the flat (point, pencil) pair ids n·16 + k, all
    16 live, sorted by row and cell base and cut into segments, occupied
    rows only (``core.tricubic.endpoint_plan``). Deterministic: no float
    atomics. Runs on the stream the plan was built on and raises on
    another."""
    return _adding_bwd("cubic_value_grad_bwd", 2, 16, 16, table, grid,
                       points, ct_value, ct_grad, plan)


def zpc_value_grad_bwd(table: torch.Tensor, grid, points: torch.Tensor,
                       ct_value: torch.Tensor, ct_grad: torch.Tensor,
                       plan) -> torch.Tensor:
    """K6zᵀ, accumulating as K5ᵀ: adds into ``table`` (nx*ny, nz), in
    place, the table cotangent of K6z for a value cotangent (N,) and a
    physical-gradient cotangent (N, 3) at points (N, 3), and returns
    ``table``. The plan lists the flat (point, translate) pair ids n·8 +
    t, the 7 live translates, sorted by row and cell base and cut into
    segments, occupied rows only, with its task list
    (``core.zpcubic.endpoint_plan``, ``core.tricubic.with_tasks``): a warp
    a task, whole short rows or one segment of a long row. Deterministic:
    no float atomics (int counters share out the tasks past the grid).
    Runs on the stream the plan was built on and raises on another."""
    name = "zpc_value_grad_bwd"
    if plan.tasks is None:
        raise ValueError(f"{name}: needs a plan with its task list "
                         f"(core.zpcubic.endpoint_plan)")
    return _adding_bwd(
        name, 3, 7, 8, table, grid, points, ct_value, ct_grad, plan,
        after=(_ptr(plan.tasks), _ptr(plan.n_tasks),
               _ptr(plan.task_counters)),
        specs=[("plan.tasks", plan.tasks, torch.int32, (plan.n_seg_max, 4)),
               ("plan.n_tasks", plan.n_tasks, torch.int32, (1,)),
               ("plan.task_counters", plan.task_counters, torch.int32,
                (2,))])


def _adding_bwd(name, min_axis, live, stride, table, grid, points, ct_value,
                ct_grad, plan, after=(), specs=()):
    """Launch an accumulating transpose (K5ᵀ, K6zᵀ) over a plan of
    occupied rows with ``live`` of ``stride`` pairs a point; ``after``
    and ``specs``: the kernel's arguments past the plan's z0 range, and
    their tensors'."""
    if (plan.live != live or plan.stride != stride
            or plan.z0_range is None):
        raise ValueError(f"{name}: needs a plan of occupied rows with {live} "
                         f"live pairs of {stride} a point, got live "
                         f"{plan.live}, stride {plan.stride}, z0_range "
                         f"{plan.z0_range is not None}")
    nx, ny, _ = grid.shape
    return _value_grad_bwd(
        name, min_axis, grid, points, ct_value, ct_grad, plan, table,
        after=(_ptr(plan.z0_range), *after),
        specs=[("plan.z0_range", plan.z0_range, torch.int32, (nx * ny, 2)),
               *specs])


def vector_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """KG: out[i, j] = table[idx[i, j], j]; table (R, W) f32, idx (M, W)
    int32 → (M, W) f32, indices clamped into the table."""
    name = "vector_gather"
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{name}: table and idx must be 2-D, got "
                         f"{table.dim()}, {idx.dim()}")
    r, w = table.shape
    m = idx.shape[0]
    if r < 1 or w < 1:
        raise ValueError(f"{name}: empty table {tuple(table.shape)}")
    dev = _check(name, [("table", table, torch.float32, (r, w)),
                        ("idx", idx, torch.int32, (m, w))])
    out = torch.empty((m, w), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_vector_gather", _ptr(table), r, w, _ptr(idx),
                m, _ptr(out))
    return out


def _sharded_specs(name, slab2d, grid, x0: int, loc: int, points, order):
    nx, ny, nz = grid.shape
    n = points.shape[0]
    if min(grid.shape) < 2 or not (2 <= loc and 0 <= x0 and x0 + loc <= nx):
        raise ValueError(f"{name}: needs every grid axis >= 2 and a shard "
                         f"of >= 2 planes inside the grid, got "
                         f"{grid.shape}, x0={x0}, loc={loc}")
    specs = [("slab2d", slab2d, torch.float32, ((loc + 4) * ny, nz)),
             ("grid.origin", grid.origin, torch.float32, (3,)),
             ("grid.spacing", grid.spacing, torch.float32, (3,))]
    if order is None:
        specs.append(("points", points, torch.float32, (n, 3)))
    else:   # the kernel reads the order's copy of the owned points only
        if order.n != n:
            raise ValueError(f"{name}: an order of {order.n} points for "
                             f"{n} points")
        n_own = order.index.shape[0]
        specs += [("order.index", order.index, torch.int32, (n_own,)),
                  ("order.points", order.points, torch.float32, (n_own, 3)),
                  ("order.mask", order.mask, torch.int32, (-(-n // 32),))]
    return n, _check(name, specs)


#: K7's ordered form takes four lanes a point for the value at up to this
#: many owned points an SM, one above; the value + gradient always takes
#: four (faster at config 4's bundle and endpoints). ``chip_smoke.py
#: --k7-study`` on an NVIDIA H100 80GB HBM3 at 700 W: over uniform points
#: four lanes beat one up to 256 owned points a shard an SM and lose from
#: 512, so the crossover is placed between them; at config 4's shapes
#: this threshold beat 64. ``grid_sharding.shard_order`` applies the rule
#: once per order.
K7_QUAD_POINTS_PER_SM = 384


_SMS = {}


def sm_count(device) -> int:
    """The SMs of a CUDA device, read once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def k7_lanes(n_own: int, sms: int) -> int:
    """The lanes a point of K7's ordered value over n_own owned points on
    a card of ``sms`` SMs."""
    return 4 if n_own <= K7_QUAD_POINTS_PER_SM * sms else 1


def _sharded_args(slab2d, grid, x0, loc, points, order):
    """K7's arguments: the slab and grid, then the points and the order
    (one-shot: the points in their order, no order; else the owned points
    in the order, their indices and the ownership mask)."""
    nx, ny, nz = grid.shape
    head = (_ptr(slab2d), _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
            int(x0), int(loc))
    n = points.shape[0]
    if order is None:
        return head + (_ptr(points), n, None, 0, None)
    return head + (_ptr(order.points), n, _ptr(order.index),
                   order.index.shape[0], _ptr(order.mask))


def cubic_sharded_value(slab2d: torch.Tensor, grid, x0: int, loc: int,
                        points: torch.Tensor, order=None) -> torch.Tensor:
    """K7: the tricubic value (N,) at points (N, 3) of the shard of x-planes
    [x0, x0 + loc) of the global ``grid``, from its slab ((loc + 4)·ny, nz)
    (the shard's planes with 2 halo planes on either side), 0 where the
    shard does not own the point. The owner's value is bitwise K5's on the
    whole table. ``order``: the points' ``grid_sharding.ShardOrder`` over
    this shard (its owned points evaluated in cell order); None: one-shot,
    in the points' order."""
    name = "cubic_sharded_value"
    n, dev = _sharded_specs(name, slab2d, grid, x0, loc, points, order)
    value = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return value
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name,
                *_sharded_args(slab2d, grid, x0, loc, points, order),
                order.lanes if order is not None else 0, _ptr(value))
    return value


def cubic_sharded_value_grad(slab2d: torch.Tensor, grid, x0: int, loc: int,
                             points: torch.Tensor, order=None):
    """K7 with the gradient: value (N,) and physical gradient (N, 3)
    [1/km], as ``cubic_sharded_value``; the owner's are bitwise K5's."""
    name = "cubic_sharded_value_grad"
    n, dev = _sharded_specs(name, slab2d, grid, x0, loc, points, order)
    value = torch.empty((n,), dtype=torch.float32, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return value, grad
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name,
                *_sharded_args(slab2d, grid, x0, loc, points, order),
                _ptr(value), _ptr(grad))
    return value, grad


#: K7ᵀ takes two tasks a warp at this many tasks an SM or more (their
#: loads in flight together, at the registers of one), one below, where
#: the warps are too few to fill the card. ``chip_smoke.py --k7-study`` on
#: an NVIDIA H100 80GB HBM3 at 700 W: over uniform points one task a warp
#: beats two up to 32 tasks a shard an SM and two beat one from 64 (the
#: value gaining up to 23 %, the value + gradient within 3 % between 128
#: and 256), so the crossover is placed between 32 and 64; at config 4's
#: shapes this threshold beat 256. ``grid_sharding.sharded_plan`` applies
#: the rule once per plan.
K7T_PAIR_TASKS_PER_SM = 64


def k7t_tasks(n_tasks: int, sms: int) -> int:
    """The tasks a warp of K7ᵀ over a plan of n_tasks tasks on a card of
    ``sms`` SMs."""
    return 2 if n_tasks >= K7T_PAIR_TASKS_PER_SM * sms else 1


def _sharded_plan_specs(name, plan, slab, grid, n_points):
    """Specs of what K7ᵀ reads of a ``grid_sharding.ShardPlan``; raises
    unless the current stream is the one the plan was built on (calls on
    two streams would share its counters and scratch)."""
    if plan.counters.is_cuda and (torch.cuda.current_stream(
            plan.counters.device).cuda_stream != plan.stream):
        raise ValueError(f"{name}: the plan was built on another CUDA "
                         f"stream; build one on the stream of this call")
    n_big = plan.counters.shape[0]
    return [("slab", slab, torch.float32, (plan.slab_cells,)),
            ("plan.entry", plan.entry, torch.int32, (plan.entry.shape[0],)),
            ("plan.cells", plan.cells, torch.int32, (plan.n_cells,)),
            ("plan.tasks", plan.tasks, torch.int32, (plan.n_tasks, 4)),
            ("plan.big_cell", plan.big_cell, torch.int32, (n_big,)),
            ("plan.big_sub", plan.big_sub, torch.int32, (n_big + 1,)),
            ("plan.counters", plan.counters, torch.int32, (n_big,)),
            ("plan.partial", plan.partial, torch.float32,
             (max(plan.n_sub, 1),)),
            ("plan.u", plan.u, torch.float32, (n_points, 4)),
            ("grid.spacing", grid.spacing, torch.float32, (3,))]


def _sharded_plan_args(plan, grid):
    """The plan's pointers and count and the grid's spacing as K7ᵀ takes
    them."""
    return (_ptr(plan.entry), _ptr(plan.cells), _ptr(plan.tasks),
            plan.n_tasks, _ptr(plan.big_cell), _ptr(plan.big_sub),
            _ptr(plan.counters), _ptr(plan.u), _ptr(grid.spacing))


def cubic_sharded_value_bwd(slab: torch.Tensor, plan, grid,
                            ct_value: torch.Tensor) -> torch.Tensor:
    """K7ᵀ of the value, accumulating: slab ((loc + 4)·ny·nz,) += the
    transpose of K7's value for the cotangent (N,), in place, over the
    shard's ``parallel.grid_sharding.ShardPlan`` of the global ``grid``
    (each entry's weights formed from its point's u, which the plan
    keeps); returns
    ``slab``. Only the plan's cells are read and written; a plan with no
    entry launches nothing. Bitwise its plain version
    (``grid_sharding.sharded_transpose_ref``); no float atomics."""
    name = "cubic_sharded_value_bwd"
    n = ct_value.shape[0]
    dev = _check(name, [("ct_value", ct_value, torch.float32, (n,))]
                 + _sharded_plan_specs(name, plan, slab, grid, n))
    if plan.n_tasks == 0:
        return slab
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, *_sharded_plan_args(plan, grid),
                _ptr(ct_value), plan.tasks_per_warp, _ptr(plan.partial),
                _ptr(slab))
    return slab


def cubic_sharded_value_grad_bwd(slab: torch.Tensor, plan, grid,
                                 ct_value: torch.Tensor,
                                 ct_grad: torch.Tensor) -> torch.Tensor:
    """K7ᵀ of the value and gradient, accumulating, as
    ``cubic_sharded_value_bwd``, for a value cotangent (N,) and a
    physical-gradient cotangent (N, 3)."""
    name = "cubic_sharded_value_grad_bwd"
    n = ct_value.shape[0]
    dev = _check(name, [("ct_value", ct_value, torch.float32, (n,)),
                        ("ct_grad", ct_grad, torch.float32, (n, 3))]
                 + _sharded_plan_specs(name, plan, slab, grid, n))
    if plan.n_tasks == 0:
        return slab
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, *_sharded_plan_args(plan, grid),
                _ptr(ct_value), _ptr(ct_grad), plan.tasks_per_warp,
                _ptr(plan.partial), _ptr(slab))
    return slab
