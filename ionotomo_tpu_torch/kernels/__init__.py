"""Launch wrappers of the hand-written CUDA kernels.

- K1  ``trace_leapfrog_zp``: the leapfrog zp tracer, all steps in one launch
  (csrc/trace_leapfrog_zp.cu);
- K1e ``zp_value_grad``: zp value + physical gradient at points
  (csrc/zp_value_grad.cu);
- K2  ``rows_value_fwd``: the row-gather value map (csrc/rows_value_fwd.cu);
- K3  ``rows_value_bwd``: its transpose, a deterministic per-row reduction
  over a plan of the points sorted by row (csrc/rows_value_bwd.cu);
- K1eᵀ ``zp_value_grad_bwd``: the transpose of K1e with respect to the
  table, by the same plan-and-reduce scheme (csrc/zp_value_grad_bwd.cu);
- KG  ``vector_gather``: out[i, j] = table[idx[i, j], j], the gather of the
  JAX package's Pallas probe (csrc/vector_gather.cu).

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
            "rows_value_bwd": 0, "zp_value_grad_bwd": 0, "vector_gather": 0}

#: Widest table row the reduce kernels (K3, K1eᵀ) take: one row per warp
#: in shared memory, 8 warps a block, within the 48 KB static limit.
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


def _grid_specs(name: str, coef2d, grid):
    nx, ny, nz = grid.shape
    if min(grid.shape) < 3:
        raise ValueError(f"{name}: every grid axis needs >= 3 samples, got "
                         f"{grid.shape}")
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


def zp_value_grad(coef2d: torch.Tensor, grid, points: torch.Tensor):
    """K1e: zp value (N,) and physical gradient (N, 3) [1/km] at points
    (N, 3) of the (nx*ny, nz) coefficient table ``coef2d``."""
    name = "zp_value_grad"
    n = points.shape[0]
    dev = _check(name, [("points", points, torch.float32, (n, 3))]
                 + _grid_specs(name, coef2d, grid))
    value = torch.empty((n,), dtype=torch.float32, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return value, grad
    nx, ny, nz = grid.shape
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_zp_value_grad", _ptr(coef2d),
                _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
                _ptr(points), n, _ptr(value), _ptr(grad))
    return value, grad


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


def trace_leapfrog_zp(coef2d: torch.Tensor, grid, origins: torch.Tensor,
                      directions: torch.Tensor, n_steps: int, keep_path: bool,
                      *, h: float, hh12: float, w_n: float, w_rhs: float,
                      k_ne: float, tec_unit: float):
    """K1: leapfrog-trace R rays through the zp table for ``n_steps``
    steps of ``h`` km. Returns (x_end (R, 3), tau (R,), path (R,
    n_steps+1, 3) with the origins first, or None without keep_path).
    The f32 constants are computed by the caller (geometry.fermat)."""
    name = "trace_leapfrog_zp"
    r = origins.shape[0]
    dev = _check(name, [("origins", origins, torch.float32, (r, 3)),
                        ("directions", directions, torch.float32, (r, 3))]
                 + _grid_specs(name, coef2d, grid))
    if n_steps < 1:
        raise ValueError(f"{name}: n_steps must be >= 1, got {n_steps}")
    x_end = torch.empty((r, 3), dtype=torch.float32, device=dev)
    tau = torch.empty((r,), dtype=torch.float32, device=dev)
    path = (torch.empty((r, n_steps + 1, 3), dtype=torch.float32, device=dev)
            if keep_path else None)
    if r == 0:
        return x_end, tau, path
    nx, ny, nz = grid.shape
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_trace_leapfrog_zp", _ptr(coef2d),
                _ptr(grid.origin), _ptr(grid.spacing), nx, ny, nz,
                _ptr(origins), _ptr(directions), r, int(n_steps), h, hh12,
                w_n, w_rhs, k_ne, tec_unit, _ptr(x_end), _ptr(tau),
                _ptr(path))
    return x_end, tau, path


def _plan_specs(order, offsets, n_pairs, n_rows):
    return [("order", order, torch.int32, (n_pairs,)),
            ("offsets", offsets, torch.int32, (n_rows + 1,))]


def rows_value_bwd(ct: torch.Tensor, order: torch.Tensor,
                   offsets: torch.Tensor, wxy: torch.Tensor, zi: torch.Tensor,
                   wz: torch.Tensor, n_rows: int, nz: int) -> torch.Tensor:
    """K3: table_ct (n_rows, nz) with table_ct[ri[n,k], zi[n,l]] +=
    ct[n]·wxy[n,k]·wz[n,l], reduced per row in the order of the plan
    (``order``: the N·K flat pair ids n·K + k sorted by row; ``offsets``:
    each row's start in ``order``; ``core.tricubic.build_row_plan``).
    ct (N,) f32; wxy (N, K) f32 with K ≤ 16; zi (N, L) int32, wz (N, L)
    f32 with L ≤ 4. Deterministic: no float atomics."""
    name = "rows_value_bwd"
    if wxy.dim() != 2 or zi.dim() != 2:
        raise ValueError(f"{name}: wxy and zi must be 2-D, got {wxy.dim()}, "
                         f"{zi.dim()}")
    n, k = wxy.shape
    l = zi.shape[1]
    if not (1 <= k <= 16 and 1 <= l <= 4):
        raise ValueError(f"{name}: needs 1 <= K <= 16 and 1 <= L <= 4, got "
                         f"K={k}, L={l}")
    if not (1 <= nz <= MAX_NZ_REDUCE and n_rows >= 1):
        raise ValueError(f"{name}: needs n_rows >= 1 and 1 <= nz <= "
                         f"{MAX_NZ_REDUCE}, got {n_rows}, {nz}")
    dev = _check(name, [("ct", ct, torch.float32, (n,)),
                        ("wxy", wxy, torch.float32, (n, k)),
                        ("zi", zi, torch.int32, (n, l)),
                        ("wz", wz, torch.float32, (n, l))]
                 + _plan_specs(order, offsets, n * k, n_rows))
    out = torch.empty((n_rows, nz), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_rows_value_bwd", _ptr(ct), _ptr(order),
                _ptr(offsets), _ptr(wxy), k, _ptr(zi), _ptr(wz), l, n_rows,
                nz, _ptr(out))
    return out


def zp_value_grad_bwd(grid, points: torch.Tensor, ct_value: torch.Tensor,
                      ct_grad: torch.Tensor, order: torch.Tensor,
                      offsets: torch.Tensor, k: int) -> torch.Tensor:
    """K1eᵀ: the (nx*ny, nz) table cotangent of K1e for a value cotangent
    (N,) and a physical-gradient cotangent (N, 3) at points (N, 3). The
    plan lists the flat (point, translate) pair ids n·k + t, t < k ≤ 8,
    sorted by row (``core.tricubic.build_row_plan`` over the first k
    zp translates). Deterministic: no float atomics."""
    name = "zp_value_grad_bwd"
    nx, ny, nz = grid.shape
    n = points.shape[0]
    if not 1 <= k <= 8:
        raise ValueError(f"{name}: needs 1 <= k <= 8, got {k}")
    if min(grid.shape) < 3 or nz > MAX_NZ_REDUCE:
        raise ValueError(f"{name}: every grid axis needs >= 3 samples and "
                         f"nz <= {MAX_NZ_REDUCE}, got {grid.shape}")
    dev = _check(name, [("points", points, torch.float32, (n, 3)),
                        ("ct_value", ct_value, torch.float32, (n,)),
                        ("ct_grad", ct_grad, torch.float32, (n, 3)),
                        ("grid.origin", grid.origin, torch.float32, (3,)),
                        ("grid.spacing", grid.spacing, torch.float32, (3,))]
                 + _plan_specs(order, offsets, n * k, nx * ny))
    out = torch.empty((nx * ny, nz), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, "ionotomo_zp_value_grad_bwd", _ptr(grid.origin),
                _ptr(grid.spacing), nx, ny, nz, _ptr(points), _ptr(ct_value),
                _ptr(ct_grad), _ptr(order), _ptr(offsets), k, _ptr(out))
    return out


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
