"""Launch wrappers of the hand-written CUDA kernels.

- K1  ``trace_leapfrog_zp``: the leapfrog zp tracer, all steps in one launch
  (csrc/trace_leapfrog_zp.cu);
- K1e ``zp_value_grad``: zp value + physical gradient at points
  (csrc/zp_value_grad.cu);
- K2  ``rows_value_fwd``: the row-gather value map (csrc/rows_value_fwd.cu);
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
  member-innermost (``pack_members``), the reduce, and the fold of rows of
  several segments (``fold_member_rows``; csrc/rows_value_bwd_batched.cu).

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
launches = {"trace_leapfrog_zp": 0, "zp_value_grad": 0, "rows_value_fwd": 0,
            "rows_value_bwd": 0, "zp_value_grad_bwd": 0, "vector_gather": 0,
            "cubic_value_grad": 0, "cubic_value_grad_bwd": 0,
            "trace_leapfrog_cubic": 0, "pack_z_taps": 0,
            "ray_order_keys": 0, "rows_value_fwd_batched": 0,
            "rows_value_bwd_batched": 0, "pack_members": 0,
            "fold_member_rows": 0}

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


def _grid_specs(name: str, coef2d, grid, min_axis: int = 3):
    """Specs of a field model's table and grid; the zp model needs 3
    samples an axis, the tricubic model 2."""
    nx, ny, nz = grid.shape
    if min(grid.shape) < min_axis:
        raise ValueError(f"{name}: every grid axis needs >= {min_axis} "
                         f"samples, got {grid.shape}")
    return [("coef2d", coef2d, torch.float32, (nx * ny, nz)),
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


def cubic_value_grad(field2d: torch.Tensor, grid, points: torch.Tensor):
    """K5: tricubic value (N,) and physical gradient (N, 3) [1/km] at
    points (N, 3) of the field reshaped to (nx*ny, nz)."""
    return _value_grad("cubic_value_grad", 2, field2d, grid, points)


def rows_value_fwd(table: torch.Tensor, ri: torch.Tensor, wxy: torch.Tensor,
                   zi: torch.Tensor, wz: torch.Tensor,
                   xy_first: bool) -> torch.Tensor:
    """K2: out[n] = Σ_k wxy[n,k] Σ_l wz[n,l] table[ri[n,k], zi[n,l]].

    table (rows, nz) f32; ri (N, K) int32, wxy (N, K) f32 with K ≤ 16;
    zi (N, L) int32, wz (N, L) f32 with L ≤ 4. Unbatched only."""
    name = "rows_value_fwd"
    if table.dim() != 2 or ri.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: table, ri and zi must be 2-D, got "
                         f"{table.dim()}, {ri.dim()}, {zi.dim()}")
    n, k = ri.shape
    l = zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    dev = _check(name, [("ri", ri, torch.int32, (n, k)),
                        ("table", table, torch.float32, tuple(table.shape)),
                        ("wxy", wxy, torch.float32, (n, k)),
                        ("zi", zi, torch.int32, (n, l)),
                        ("wz", wz, torch.float32, (n, l))])
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_rows_value_fwd", _ptr(table), table.shape[0],
                table.shape[1], _ptr(ri), _ptr(wxy), k, _ptr(zi), _ptr(wz),
                l, n, int(bool(xy_first)), _ptr(out))
    return out


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
                           wz: torch.Tensor, xy_first: bool) -> torch.Tensor:
    """K2b: out[b, n] = Σ_k wxy[n,k] Σ_l wz[n,l] table[b, ri[n,k], zi[n,l]].

    table (B, rows, nz) f32, member-major; ri, wxy, zi, wz as for
    ``rows_value_fwd``, shared by the members. The call packs the tables
    member-innermost (``pack_members``) and gathers from the pack.
    Returns (B, N); member b is bitwise ``rows_value_fwd(table[b], ...)``."""
    name = "rows_value_fwd_batched"
    if table.dim() != 3:
        raise ValueError(f"{name}: table must be (B, rows, nz), got "
                         f"{tuple(table.shape)}")
    n, k, l, specs = _rows_specs(name, ri, wxy, zi, wz)
    b, rows, nz = table.shape
    dev = _check(name, [("table", table, torch.float32, (b, rows, nz))]
                 + specs)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if n == 0 or b == 0 or rows * nz == 0:
        return out
    packed = pack_members(table.view(b, rows * nz))
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


def trace_leapfrog_zp(coef2d: torch.Tensor, grid, origins: torch.Tensor,
                      directions: torch.Tensor, n_steps: int, keep_path: bool,
                      **consts):
    """K1: leapfrog-trace R rays through the zp table for ``n_steps``
    steps of ``h`` km. Returns (x_end (R, 3), tau (R,), path (R,
    n_steps+1, 3) with the origins first, or None without keep_path).
    The f32 constants h, hh12, w_n, w_rhs, k_ne and tec_unit are computed
    by the caller (``geometry.fermat._step_constants``)."""
    name = "trace_leapfrog_zp"
    dev, x_end, tau, path = _trace_outputs(name, 3, coef2d, grid, origins,
                                           directions, n_steps, keep_path)
    if origins.shape[0] == 0:
        return x_end, tau, path
    nx, ny, nz = grid.shape
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, _ptr(coef2d), _ptr(grid.origin),
                _ptr(grid.spacing), nx, ny, nz, _ptr(origins),
                _ptr(directions), origins.shape[0], int(n_steps),
                *_consts(**consts), _ptr(x_end), _ptr(tau), _ptr(path))
    return x_end, tau, path


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
    the card by ``ray_order_keys``). Consecutive rays, a warp of K1c, are then
    parallel rays from neighbouring origins: they keep their distances at
    every height and reach each cell base at the same step, so they share
    table rows and cache sectors the whole way. Ties sort in no fixed
    order: a ray's outputs do not depend on its place. No host read."""
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
    dev = _check("trace_leapfrog_cubic",
                 _grid_specs("trace_leapfrog_cubic", field2d, grid, 2))
    fills = origins.shape[0] >= TRACE_CUBIC_RAYS_PER_SM * \
        torch.cuda.get_device_properties(dev).multi_processor_count
    return trace_leapfrog_cubic_with(
        field2d, grid, origins, directions, n_steps, keep_path,
        packed=pack_z_taps(field2d, grid),
        order=ray_order(origins, directions, grid) if fills else None,
        threads=256 if fills else 64, **consts)


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
    name = "trace_leapfrog_cubic"
    dev, x_end, tau, path = _trace_outputs(name, 2, field2d, grid, origins,
                                           directions, n_steps, keep_path)
    nx, ny, nz = grid.shape
    r = origins.shape[0]
    specs = []
    if packed is not None:
        specs.append(("packed", packed, torch.float32, (nz - 1, nx * ny, 4)))
    if order is not None:
        specs.append(("order", order, torch.int32, (r,)))
    if specs and _check(name, specs) != dev:
        raise ValueError(f"{name}: packed and order must be on {dev}")
    if r == 0:
        return x_end, tau, path
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_" + name, _ptr(field2d), _ptr(packed),
                _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
                _ptr(origins), _ptr(directions), _ptr(order), r,
                int(n_steps), *_consts(**consts), int(threads),
                _ptr(x_end), _ptr(tau), _ptr(path))
    return x_end, tau, path


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
    reduce (every row of one segment written), and ``fold_member_rows``
    (the rows of several segments, each member's partial rows summed in
    segment order). Deterministic: no float atomics; member b is bitwise
    ``rows_value_bwd(ct[b], plan, ...)``. Leaves the plan's counters alone,
    but runs on the stream the plan was built on and raises on another, as
    K3 does."""
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
    with torch.cuda.device(dev):
        ptrs, partials = _plan_args(plan, nz, dev, members=b)
        _launch(name, "ionotomo_rows_value_bwd_batched", _ptr(ctp), b, n,
                _ptr(wxy), k, _ptr(zi), _ptr(wz), l, nz, *ptrs[:4], n_rows,
                plan.n_seg_max, plan.chunk, _ptr(partials), _ptr(out))
    return fold_member_rows(partials.view(b, plan.n_seg_max, nz), plan, out)


def fold_member_rows(partials: torch.Tensor, plan, out: torch.Tensor
                     ) -> torch.Tensor:
    """K3b's second pass, in place: for every row r of several segments
    in ``plan`` and every member b, out[b, r] = the partial rows
    partials[b, s] of r's segments s summed in segment order from 0.0
    (rows of one segment are left as they are). partials (B, n_seg_max,
    nz), out (B, n_rows, nz) f32; returns ``out`` (plain version:
    ``core.tricubic.fold_member_rows_ref``)."""
    name = "fold_member_rows"
    if partials.dim() != 3 or out.dim() != 3:
        raise ValueError(f"{name}: partials and out must be 3-D, got "
                         f"{partials.dim()}, {out.dim()}")
    b, _, nz = out.shape
    dev = _check(name, [("partials", partials, torch.float32,
                         (b, plan.n_seg_max, nz)),
                        ("out", out, torch.float32, (b, plan.n_rows, nz)),
                        ("plan.row_seg", plan.row_seg, torch.int32,
                         (plan.n_rows + 1,))])
    if b == 0 or nz == 0:
        return out
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_fold_member_rows", _ptr(plan.row_seg),
                plan.n_rows, _ptr(partials), b, plan.n_seg_max, nz,
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
    name = "cubic_value_grad_bwd"
    if plan.live != 16 or plan.stride != 16 or plan.z0_range is None:
        raise ValueError(f"{name}: needs a plan of occupied rows with 16 "
                         f"live pairs a point, got live {plan.live}, stride "
                         f"{plan.stride}, z0_range {plan.z0_range is not None}")
    nx, ny, _ = grid.shape
    return _value_grad_bwd(
        name, 2, grid, points, ct_value, ct_grad, plan, table,
        after=(_ptr(plan.z0_range),),
        specs=[("plan.z0_range", plan.z0_range, torch.int32, (nx * ny, 2))])


def vector_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """KG: out[i, j] = table[idx[i, j], j]; table (R, W) f32, idx (M, W)
    int32 → (M, W) f32."""
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
