"""Drive the PyTorch/CUDA port's bent-ray forward path and its MAP
inversion path on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also: device time by kernel of
                                       # one serving epoch and of one
                                       # Gauss-Newton step, and the step's
                                       # host time by op (torch.profiler)
    python3 chip_smoke.py --parent DIR # also: phases 5 and 6 time the K3
                                       # and K1eᵀ of the checkout at DIR
                                       # (the sort-by-row kernels before
                                       # the segmented plan; any other
                                       # sources are refused) on the same
                                       # inputs, in turns

Phases (any failed check raises, and the run exits non-zero):

1. Build the CUDA kernels from ``ionotomo_tpu_torch/kernels/csrc``; print
   the card's name and power limit and the build time.
2. Each kernel against its plain PyTorch version on the card: K1e
   (zp value + gradient) and K2 (row-gather value map) at 2^20 points of
   a random 128³ table, including points outside the grid, on lattice and
   half-lattice points and on u±v = 0; K1 (the leapfrog zp tracer)
   against the plain tracer on 8192 rays of the phase-3 world.
3. Throughput of the tracer in the headline configuration of ``bench.py``:
   128³ Chapman, 262144 rays, leapfrog@64, 150 MHz, 1000 km, zp, no path.
4. The serving slice, as ``predict --bent --interp zp --quadrature
   hermite`` runs it: ``make_ray_batch`` → ``trace_rays(keep_path=True)``
   → ``dtec_paired_q``, 62 antennas × 10 directions, 4 epochs on a 128³
   perturbed Chapman world. The kernel path runs twice and must agree
   bitwise; it must match the plain path (CPU tensors) to 1e-4·max|dTEC|;
   K1, K1e and K2 must have launched.
5. The adjoint kernels against their plain versions on the card: K3 (the
   transpose of K2) at 2^20 zp points of a random 128³ table, edge cases
   included (917,504 points: a corner row gets 131,640 of the 7 live
   translates' pairs), and at
   the cubic shape (K=16, L=4); K1eᵀ (the transpose of K1e) at the same
   points. Each within 1e-4·max|out| and bitwise equal across two calls;
   the plan's segment count and busiest segment and row; kernel, plain,
   ``index_add_`` and bound ms (and the parent's ms with ``--parent``).
6. The config-3b solve (``bench/config3b.py``) at full width: a 128³ grid
   enclosing 100 × 100 rays, truth = Chapman + a von Kármán perturbation
   (σ 0.3, outer scale 120 km), data from K1 at 256 steps and 150 MHz with
   1 % noise, ``map_gauss_newton`` with a von Kármán prior at 80 km over
   65-sample Hermite straight rays on zp, gn=2, cg=20. The linearised
   operator on the kernels against the same operator on the plain
   versions (1e-4·max|·|, adjoint identity 1e-4); K2, K3 and K1eᵀ alone at
   the solve's shapes against their plain versions (1e-4·max|out|, bitwise
   equal across two calls, kernel, plain, ``index_add_`` and bound ms, the
   plans' segments, and the parent's ms with ``--parent``); the solve three
   times, bitwise
   equal, and within 1 % of the plain-version solve in final residual and
   held-out dTEC rms (20 × 50 rays, seed 99), beating the prior there; K2,
   K3, K1e and K1eᵀ must have launched in the solve.
7. The gather probe (``ionotomo_tpu_torch.probes.gather``): KG against
   ``torch.gather`` at (16384, 128) and (8, 128), bitwise; KG must have
   launched.

The last lines are a JSON object of per-kernel results (each kernel's
bound: the larger of the bytes it must move over 3.35 TB/s and its f32
operations over 67 TFLOP/s, from this run's inputs), the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero at once, before any build.
"""
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BOUNDS = ((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0))  # bench.py grid
N_GRID = 128
FREQ_HZ = 150e6
LENGTH_KM = 1000.0
N_STEPS = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: the summed durations of the
    kernels (and copies) it runs on the card, from torch.profiler's CUPTI
    trace over ``reps`` calls after a warm-up. Unlike ``cuda_ms`` it does
    not count the card waiting for the host between launches, which is
    most of a small kernel's wall time here. A trace that recorded no
    device time (seen once in a run of many traces) is taken again, and
    a third empty one raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError("torch.profiler recorded no device time in three "
                       "traces")


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per unit of work, counted from the kernels' sources:
# one leapfrog step of K1 (zp weights and contraction, exp, sqrt, the
# kick-drift-kick update), one K1e point (zp weights and the 7x3
# contraction of value and gradient), one K2 zp point (8x3 gather
# contraction), one K1eᵀ point's zp set-up and one (point, translate)
# pair's weights and contributions.
FLOPS_K1_STEP = 470
FLOPS_K1E_POINT = 150
FLOPS_K2_POINT = 50
FLOPS_K1ET_POINT = 51
FLOPS_K1ET_PAIR = 78


def bound(n_bytes, n_flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of n_bytes over the memory rate and n_flops over the f32
    rate."""
    ms_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    ms_flops = n_flops / F32_FLOPS_PER_S * 1e3
    if ms_bytes >= ms_flops:
        return ms_bytes, "bytes"
    return ms_flops, "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_stats(plan):
    """Live pairs, segments used, busiest segment and busiest row of a
    row plan (host reads, outside any timing)."""
    counts = torch.diff(plan.offsets)
    busiest_row = int(counts.max())
    return {"pairs": int(plan.offsets[-1] - plan.offsets[0]),
            "segments": int(plan.row_seg[-1]), "n_seg_max": plan.n_seg_max,
            "busiest_segment": min(plan.chunk, busiest_row),
            "busiest_row": busiest_row,
            "empty_rows": int((counts == 0).sum())}


def k3_bound(ct, ri, wxy, zi, wz, plan, nz):
    """The scatter's own inputs read once (ct, zi, wz and the live
    translates' columns of ri and wxy) and the table written once; per
    live pair 1 + 2L operations. The plan is this implementation's data,
    not an input of the function, and is not counted."""
    live = plan.live
    n_bytes = (nbytes(ct, zi, wz, ri[:, :live], wxy[:, :live])
               + 4 * plan.n_rows * nz)
    return bound(n_bytes, plan_stats(plan)["pairs"] * (1 + 2 * zi.shape[1]))


def k1et_bound(points, cv, cg, plan, nz):
    """K1eᵀ reads the points and both cotangents once and writes the
    table once (the plan is not counted)."""
    n_bytes = nbytes(points, cv, cg) + 4 * plan.n_rows * nz
    return bound(n_bytes, points.shape[0] * FLOPS_K1ET_POINT
                 + plan_stats(plan)["pairs"] * FLOPS_K1ET_PAIR)


def index_add_call(flat, contrib, size):
    """One PyTorch call computing the same scatter from the precomputed
    contributions: ``index_add_`` into a preallocated table (its zeroing
    not counted; atomics, so not reproducible)."""
    buf = torch.zeros(size, dtype=torch.float32, device=flat.device)
    return lambda: buf.index_add_(0, flat, contrib)


class Parent:
    """K3 and K1eᵀ as they were before the segmented plan, from the
    checkout at ``root``: built from its sources with this checkout's nvcc
    flags, called through their C interface over the plan they took (the
    pairs sorted by row, CSR offsets; K3 over all K translates, K1eᵀ over
    7 with ids n*7 + t).

    ctypes cannot check a C interface, so this one is declared by the
    SHA-256 of the two sources that define it, and any other checkout is
    refused rather than handed arguments it does not take."""

    SOURCES = {
        "rows_value_bwd.cu":
            "5004056392af64a7eab114c9b2d0b7956ef4586c809dc6d994d0da6eae2aeef1",
        "zp_value_grad_bwd.cu":
            "7cc96be0e1d4cba2b45b2c08db56db8b07a9857ea819a282a84773468782ed48",
    }

    def __init__(self, root):
        from ionotomo_tpu_torch.kernels import build

        csrc = Path(root) / "ionotomo_tpu_torch" / "kernels" / "csrc"
        for name, want in self.SOURCES.items():
            got = hashlib.sha256((csrc / name).read_bytes()).hexdigest()
            if got != want:
                raise ValueError(
                    f"--parent {root}: {name} is not the sort-by-row kernel "
                    f"whose C interface this script binds (sha256 "
                    f"{got[:16]}, expected {want[:16]})")
        info = build.build(csrc, build.BUILD_DIR / "parent")
        self.lib = ctypes.CDLL(str(info["path"]))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.ionotomo_rows_value_bwd.argtypes = [p, p, p, p, i, p, p, i,
                                                     i, i, p, p]
        self.lib.ionotomo_zp_value_grad_bwd.argtypes = [p, p, i, i, i, p, p,
                                                        p, p, p, i, p, p]
        self.lib.ionotomo_rows_value_bwd.restype = i
        self.lib.ionotomo_zp_value_grad_bwd.restype = i
        print(f"  parent kernels from {csrc} (built={info['built']} in "
              f"{info['seconds']:.2f} s)")

    @staticmethod
    def plan(ri, n_rows):
        rows = ri.reshape(-1)
        sorted_rows, order = torch.sort(rows, stable=True)
        offsets = torch.searchsorted(
            sorted_rows, torch.arange(n_rows + 1, dtype=sorted_rows.dtype,
                                      device=rows.device), out_int32=True)
        return order.to(torch.int32), offsets

    @staticmethod
    def _p(t):
        return ctypes.c_void_p(t.data_ptr())

    def _stream(self):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def k3(self, ct, plan, wxy, zi, wz, n_rows, nz):
        order, offsets = plan
        out = torch.empty((n_rows, nz), dtype=torch.float32, device=ct.device)
        rc = self.lib.ionotomo_rows_value_bwd(
            self._p(ct), self._p(order), self._p(offsets), self._p(wxy),
            wxy.shape[1], self._p(zi), self._p(wz), zi.shape[1], n_rows, nz,
            self._p(out), self._stream())
        if rc:
            raise RuntimeError(f"parent K3 launch failed ({rc})")
        return out

    def k1et(self, grid, points, cv, cg, plan):
        order, offsets = plan
        nx, ny, nz = grid.shape
        out = torch.empty((nx * ny, nz), dtype=torch.float32,
                          device=points.device)
        rc = self.lib.ionotomo_zp_value_grad_bwd(
            self._p(grid.origin), self._p(grid.spacing), nx, ny, nz,
            self._p(points), self._p(cv), self._p(cg), self._p(order),
            self._p(offsets), 7, self._p(out), self._stream())
        if rc:
            raise RuntimeError(f"parent K1eT launch failed ({rc})")
        return out


def compare_parent(name, parent_fn, new_fn, reps):
    """The parent's and this checkout's kernel on the same inputs, device
    time in turns (parent, new, new, parent); both outputs agree to
    1e-4·max|out|."""
    a, b = parent_fn(), new_fn()
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    check(err <= 1e-4 * float(b.abs().max()),
          f"{name}: parent and new agree ({err:.3e})")
    t = [device_ms(f, reps) for f in (parent_fn, new_fn, new_fn, parent_fn)]
    print(f"  {name}: parent {t[0]:.4f}, {t[3]:.4f} ms; new {t[1]:.4f}, "
          f"{t[2]:.4f} ms")


def bench_rays(n, seed=0):
    """Origins and directions drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.6, n)
    az = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return o, d


def phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results):
    from ionotomo_tpu_torch.testing import edge_case_points

    print("phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(2)
    shape = (N_GRID,) * 3
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)   # dyadic: exact
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    table = torch.from_numpy(rng.normal(size=(N_GRID * N_GRID, N_GRID))
                             .astype(np.float32)).to(dev)
    tmax = float(table.abs().max())
    pts = torch.from_numpy(edge_case_points(shape, origin, spacing, 1 << 20,
                                            rng)).to(dev)

    # K1e: zp value + physical gradient
    v_k, g_k = kernels.zp_value_grad(table, grid, pts)
    v_p, g_p = boxspline.interp_rows_with_grad_ref(table, grid, pts)
    torch.cuda.synchronize()
    err_v = float((v_k - v_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    check(bool(torch.isfinite(v_k).all() and torch.isfinite(g_k).all()),
          "K1e output finite")
    check(err_v <= 1e-5 * tmax,
          f"K1e value max|err| {err_v:.3e} <= 1e-5*max|table| "
          f"{1e-5 * tmax:.3e}")
    gtol = 1e-5 * tmax / min(spacing)
    check(err_g <= gtol,
          f"K1e gradient max|err| {err_g:.3e} <= {gtol:.3e}")
    ms_ev = cuda_ms(lambda: kernels.zp_value_grad(table, grid, pts), 20)
    ms_big = device_ms(lambda: kernels.zp_value_grad(table, grid, pts), 20)
    plain_big = cuda_ms(
        lambda: boxspline.interp_rows_with_grad_ref(table, grid, pts), 3)
    b_ms, b_by = bound(nbytes(table, pts, v_k, g_k),
                       pts.shape[0] * FLOPS_K1E_POINT)
    print(f"  K1e at {pts.shape[0]} points: kernel {ms_big:.4f} ms (events "
          f"{ms_ev:.4f}), plain "
          f"{plain_big:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["zp_value_grad"] = {"err_grad": err_g, "line": dict(
        max_abs_err=err_v, ms=ms_big, plain_ms=plain_big, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)}

    # K2: the zp value gather (K=8, L=3, xy-first), inputs as interp_rows
    # makes them
    bx, by, bz, u, v, w = boxspline._neighborhood(grid, pts)
    dx, dy, wxy = boxspline._xy_weights(u, v, with_grad=False)
    ri = boxspline._row_index(bx, by, dx, dy, grid).contiguous()
    zi = (bz[:, None] + torch.arange(-1, 2, dtype=torch.int32, device=dev)
          [None, :]).contiguous()
    wz = boxspline._qb_weights(w).contiguous()
    wxy = wxy.contiguous()
    o_k = kernels.rows_value_fwd(table, ri, wxy, zi, wz, True)
    o_p = tricubic.rows_value_ref(table, ri, wxy, zi, wz, True)
    torch.cuda.synchronize()
    err_r = float((o_k - o_p).abs().max())
    check(bool(torch.isfinite(o_k).all()), "K2 output finite")
    check(err_r <= 1e-5 * tmax,
          f"K2 zp max|err| {err_r:.3e} <= 1e-5*max|table| {1e-5 * tmax:.3e}")
    check(float((o_k - v_k).abs().max()) <= 1e-5 * tmax,
          "K2 zp value agrees with K1e's value")
    # the cubic shape (K=16, L=4, z-first) on random rows
    n_c = 1 << 16
    ri_c = torch.from_numpy(rng.integers(0, N_GRID * N_GRID, (n_c, 16))
                            .astype(np.int32)).to(dev)
    zi_c = torch.from_numpy((rng.integers(0, N_GRID - 3, (n_c, 1))
                             + np.arange(4)).astype(np.int32)).to(dev)
    wxy_c = torch.from_numpy(rng.uniform(0, 1, (n_c, 16))
                             .astype(np.float32)).to(dev)
    wz_c = torch.from_numpy(rng.uniform(0, 1, (n_c, 4))
                            .astype(np.float32)).to(dev)
    err_c = float((kernels.rows_value_fwd(table, ri_c, wxy_c, zi_c, wz_c,
                                          False)
                   - tricubic.rows_value_ref(table, ri_c, wxy_c, zi_c, wz_c,
                                             False)).abs().max())
    check(err_c <= 1e-5 * tmax * 16,
          f"K2 cubic-shape max|err| {err_c:.3e} <= 1e-5*max|table|*K")
    ms_big = cuda_ms(
        lambda: kernels.rows_value_fwd(table, ri, wxy, zi, wz, True), 20)
    plain_big = cuda_ms(
        lambda: tricubic.rows_value_ref(table, ri, wxy, zi, wz, True), 3)
    b_ms, b_by = bound(nbytes(table, ri, wxy, zi, wz, o_k),
                       ri.shape[0] * FLOPS_K2_POINT)
    print(f"  K2 zp at {ri.shape[0]} points: kernel {ms_big:.4f} ms, plain "
          f"{plain_big:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # K1: the leapfrog zp tracer on 8192 rays of the phase-3 world
    grid3 = Grid3D.from_bounds(*BOUNDS, shape, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid3))
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(8192, seed=1))
    for keep_path in (False, True):
        b_k, t_k = fermat.trace_rays(m, grid3, o, d, FREQ_HZ, LENGTH_KM,
                                     n_steps=N_STEPS, keep_path=keep_path,
                                     method="leapfrog", interp="zp")
        b_p, t_p = fermat.trace_rays_ref(m, grid3, o, d, FREQ_HZ, LENGTH_KM,
                                         n_steps=N_STEPS,
                                         keep_path=keep_path,
                                         method="leapfrog", interp="zp")
        torch.cuda.synchronize()
        check(b_k.points.shape == b_p.points.shape,
              f"K1 keep_path={keep_path} shape {tuple(b_k.points.shape)}")
        err_x = float((b_k.points - b_p.points).abs().max())
        err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
        check(err_x <= 1e-3, f"K1 keep_path={keep_path} path max|dx| "
                             f"{err_x:.3e} km <= 1e-3 km")
        check(err_t <= 1e-5, f"K1 keep_path={keep_path} tau max rel err "
                             f"{err_t:.3e} <= 1e-5")
        check(bool(torch.equal(b_k.ds, b_p.ds)), "K1 ds equal")
    results["trace_leapfrog_zp"] = {"tau_rel": err_t,
                                    "line": dict(max_abs_err=err_x)}


def phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card):
    print("phase 3: tracer throughput, the bench.py configuration")
    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    n_rays = 262144
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(n_rays))
    rates = {}
    for name, fn in (("kernel", fermat.trace_rays),
                     ("plain", fermat.trace_rays_ref)):
        def run():
            return fn(m, grid, o, d, FREQ_HZ, LENGTH_KM, n_steps=N_STEPS,
                      keep_path=False, method="leapfrog", interp="zp")
        out = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out[1]).all()
                   and torch.isfinite(out[0].points).all()),
              f"{name} path: finite endpoints and TEC")
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        rates[name] = n_rays / dt
        print(f"  {name} path: {rates[name]:.1f} rays/s ({dt * 1e3:.3f} ms "
              f"per call, prefilter included) on {card}")
    # the kernel alone against the plain integrator on the same table
    coef2d = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    ms = device_ms(lambda: kernels.trace_leapfrog_zp(
        coef2d, grid, o, d, N_STEPS, False, **kw), 3)
    ne_vg = fermat.log_field_ne_vg(
        lambda x: boxspline.interp_rows_with_grad_ref(coef2d, grid, x))
    plain_ms = cuda_ms(lambda: fermat._trace_impl(
        ne_vg, o, d, FREQ_HZ, LENGTH_KM, N_STEPS, False, "leapfrog"), 1)
    n_bytes = nbytes(coef2d, o, d) + 16 * n_rays      # x_end and tau out
    b_ms, b_by = bound(n_bytes, n_rays * N_STEPS * FLOPS_K1_STEP)
    print(f"  K1 alone at {n_rays} rays: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["trace_leapfrog_zp"]["line"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    results["rays_per_s"] = rates


def perturbed_log_field(grid, rng, chapman):
    """Chapman log-density plus four seeded sinusoidal modes of 2-5 %
    amplitude with horizontal wavelengths of ~140 km and longer
    (travelling-ionospheric-disturbance scale)."""
    m = chapman.log_parametrize(chapman.chapman_field(grid)).cpu().numpy()
    pts = grid.meshgrid()
    for _ in range(4):
        k = rng.uniform(-1, 1, 3) * 2 * np.pi / np.array([200., 200., 600.])
        m = m + rng.uniform(0.02, 0.05) * np.sin(pts @ k
                                                  + rng.uniform(0, 2 * np.pi))
    return m.astype(np.float32)


def serving_epochs(n_epochs=4, n_ants=62, n_dirs=10):
    """Per epoch (log-density m, antennas, directions), all numpy."""
    rng = np.random.default_rng(7)
    ants = np.concatenate([rng.uniform(-150.0, 150.0, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    epochs = []
    for e in range(n_epochs):
        r = np.random.default_rng(100 + e)
        zen = r.uniform(0.05, 0.6, n_dirs)
        az = r.uniform(0, 2 * np.pi, n_dirs)
        dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                         np.cos(zen)], -1).astype(np.float32)
        epochs.append((r, ants, dirs))
    return epochs


def predict_bent(m, grid, ants, dirs, fermat, rays, tec, i0=0):
    """One epoch of ``predict --bent --interp zp --quadrature hermite``."""
    origins, dvecs = rays.make_ray_batch(ants, dirs)
    rb, _ = fermat.trace_rays(m, grid, origins, dvecs, FREQ_HZ, LENGTH_KM,
                              n_steps=N_STEPS, keep_path=True,
                              method="leapfrog", interp="zp")
    return tec.dtec_paired_q(m, grid, rb, dirs.shape[0], i0, "hermite", "zp")


def profile_epoch(m, grid, ants, dirs, boxspline, fermat, rays, tec,
                  kernels):
    """Where one serving epoch's time goes: its stages timed alone (CUDA
    events, 20 calls each: device time including any wait for the host),
    and device time by kernel over one epoch (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nd = dirs.shape[0]
    origins, dvecs = rays.make_ray_batch(ants, dirs)
    coef2d = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    path = kernels.trace_leapfrog_zp(coef2d, grid, origins, dvecs, N_STEPS,
                                     True, **kw)[2]
    rb = rays.RayBundle(path, torch.full((path.shape[0],), kw["h"],
                                         device=path.device))
    pts = path.reshape(-1, 3)
    ends, t_hat = tec._endpoint_tangents(path)
    mv = boxspline.interp_rows(coef2d, grid, pts)
    d0, d1 = tec.endpoint_dne_ds_from(
        *boxspline.interp_rows_with_grad(coef2d, grid, ends), t_hat)
    stages = [
        ("epoch (predict_bent)",
         lambda: predict_bent(m, grid, ants, dirs, fermat, rays, tec)),
        ("make_ray_batch", lambda: rays.make_ray_batch(ants, dirs)),
        ("prefilter (3 per epoch)", lambda: boxspline.prefilter(m)),
        ("K1 trace_leapfrog_zp, keep_path",
         lambda: kernels.trace_leapfrog_zp(coef2d, grid, origins, dvecs,
                                           N_STEPS, True, **kw)),
        ("value gather: setup + K2",
         lambda: boxspline.interp_rows(coef2d, grid, pts)),
        ("endpoints: tangents + K1e + dn/ds",
         lambda: tec.endpoint_dne_ds_from(*boxspline.interp_rows_with_grad(
             coef2d, grid, tec._endpoint_tangents(path)[0]), t_hat)),
        ("Hermite paired quadrature",
         lambda: tec.dtec_paired_hermite_from_values(mv, d0, d1, rb, nd, 0)),
    ]
    print("  stages (CUDA events, mean of 20 calls):")
    for name, fn in stages:
        print(f"    {cuda_ms(fn, 20):9.4f} ms  {name}")
    fn = stages[0][1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  profiled epoch: wall {wall_us:.1f} us (profiler on), kernels "
          f"{busy:.1f} us in {sum(r[2] for r in rows)} launches")
    for key, us, count in rows[:14]:
        print(f"    {us:9.1f} us {count:4d}x  {key[:100]}")


def phase4_serving(dev, boxspline, fermat, rays, tec, kernels, Grid3D,
                   chapman, results, profile=False):
    from ionotomo_tpu_torch.testing import SERVING_KERNELS

    print("phase 4: serving slice (predict --bent, zp, hermite)")
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    grid = grid_cpu.to(dev)
    worlds = []
    for r, ants, dirs in serving_epochs():
        worlds.append((perturbed_log_field(grid_cpu, r, chapman), ants, dirs))
    on_dev = [(torch.from_numpy(m).to(dev), torch.from_numpy(a).to(dev),
               torch.from_numpy(dd).to(dev)) for m, a, dd in worlds]
    torch.cuda.synchronize()

    kernels.reset_launches()
    runs = []
    for _ in range(2):
        out, t0 = [], time.perf_counter()
        for m, a, dd in on_dev:
            out.append(predict_bent(m, grid, a, dd, fermat, rays, tec))
        torch.cuda.synchronize()
        runs.append((out, (time.perf_counter() - t0) / len(on_dev)))
    launches = dict(kernels.launches)
    print(f"  launches on the serving path: {launches}")
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"{name} launched on the serving path ({launches[name]} times)")

    for e, ((m, a, dd), k1, k2) in enumerate(zip(worlds, runs[0][0],
                                                 runs[1][0])):
        check(tuple(k1.shape) == (a.shape[0], dd.shape[0]),
              f"epoch {e}: dTEC shape {tuple(k1.shape)}")
        check(bool(torch.isfinite(k1).all()), f"epoch {e}: dTEC finite")
        check(bool(torch.equal(k1, k2)), f"epoch {e}: two runs bitwise equal")
        check(bool((k1[0] == 0).all()), f"epoch {e}: dtec[i0] == 0")
        plain = predict_bent(torch.from_numpy(m), grid_cpu,
                             torch.from_numpy(a), torch.from_numpy(dd),
                             fermat, rays, tec)
        scale = float(plain.abs().max())
        err = float((k1.cpu() - plain).abs().max())
        check(err <= 1e-4 * scale,
              f"epoch {e}: kernel vs plain max|err| {err:.3e} <= "
              f"1e-4*max|dTEC| {1e-4 * scale:.3e}")
    print(f"  kernel path: {runs[1][1] * 1e3:.3f} ms per epoch "
          f"(62x10 rays, 128^3, prefilter included)")
    if profile:
        profile_epoch(*on_dev[0][:1], grid, *on_dev[0][1:], boxspline,
                      fermat, rays, tec, kernels)
    results["launches"] = launches
    results["ms_per_epoch"] = runs[1][1] * 1e3


def _same_twice(fn):
    """Two calls of fn on the card; (first result, bitwise equal)."""
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    return a, bool(torch.equal(a, b))


def zp_rows(boxspline, grid, pts):
    """The 8 zp table rows of each point (N, 8), as interp_rows makes
    them."""
    bx, by, _, u, v, _ = boxspline._neighborhood(grid, pts)
    dx, dy, _ = boxspline._xy_weights(u, v, with_grad=False)
    return boxspline._row_index(bx, by, dx, dy, grid).contiguous()


def print_plan(name, plan):
    st = plan_stats(plan)
    print(f"  {name} plan: {st['pairs']} live pairs in {st['segments']} "
          f"segments of <= {plan.chunk} (static bound {st['n_seg_max']}); "
          f"busiest segment {st['busiest_segment']} pairs, busiest row "
          f"{st['busiest_row']}, empty rows {st['empty_rows']} of "
          f"{plan.n_rows}")


def phase5_adjoint_kernels(dev, boxspline, tricubic, kernels, Grid3D,
                           results, parent=None, n_grid=N_GRID,
                           n_points=1 << 20):
    from ionotomo_tpu_torch.testing import edge_case_points

    print("phase 5: adjoint kernels against their plain versions")
    rng = np.random.default_rng(5)
    shape = (n_grid,) * 3
    n_rows = n_grid * n_grid
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    pts = torch.from_numpy(edge_case_points(shape, origin, spacing, n_points,
                                            rng)).to(dev)
    n = pts.shape[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # K3 at the zp shape, inputs as interp_rows makes them
    bx, by, bz, u, v, w = boxspline._neighborhood(grid, pts)
    dx, dy, wxy = boxspline._xy_weights(u, v, with_grad=False)
    ri = boxspline._row_index(bx, by, dx, dy, grid).contiguous()
    zi = (bz[:, None] + torch.arange(-1, 2, dtype=torch.int32, device=dev)
          [None, :]).contiguous()
    wz = boxspline._qb_weights(w).contiguous()
    wxy = wxy.contiguous()
    ct = t(rng.normal(size=(n,)).astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = tricubic.build_row_plan(ri, n_rows, zi[:, 0],
                                   boxspline.ZP_LIVE_TRANSLATES)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    print_plan("K3 zp", plan)

    def k3():
        return kernels.rows_value_bwd(ct, plan, wxy, zi, wz, n_grid)

    def k3_plain():
        return tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz,
                                                 (n_rows, n_grid))

    got, same = _same_twice(k3)
    want = k3_plain()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "K3 output finite")
    check(same, "K3 bitwise equal across two calls")
    check(not bool(plan.counters.any()), "K3 plan counters back at zero")
    check(err <= 1e-4 * scale, f"K3 zp max|err| {err:.3e} <= 1e-4*max|out| "
                               f"{1e-4 * scale:.3e}")
    ms = device_ms(k3, 20)
    plain = device_ms(k3_plain, 3)
    lib_ms = device_ms(index_add_call(*tricubic.transpose_terms(
        ct, ri, wxy, zi, wz, (n_rows, n_grid)), n_rows * n_grid), 20)
    b_ms, b_by = k3_bound(ct, ri, wxy, zi, wz, plan, n_grid)
    print(f"  K3 zp at {n} points: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); plan "
          f"{plan_ms:.3f} ms (host clock)")
    if parent is not None:
        pplan = parent.plan(ri, n_rows)
        compare_parent(
            "K3 zp at the edge-case points",
            lambda: parent.k3(ct, pplan, wxy, zi, wz, n_rows, n_grid),
            k3, 5)

    # K3 at the cubic shape (K=16, L=4) on random rows
    ri_c = t(rng.integers(0, n_rows, (n, 16)).astype(np.int32))
    zi_c = t((rng.integers(0, n_grid - 3, (n, 1))
              + np.arange(4)).astype(np.int32))
    wxy_c = t(rng.uniform(0, 1, (n, 16)).astype(np.float32))
    wz_c = t(rng.uniform(0, 1, (n, 4)).astype(np.float32))
    plan_c = tricubic.build_row_plan(ri_c, n_rows, zi_c[:, 0])
    print_plan("K3 cubic", plan_c)

    def k3_cubic():
        return kernels.rows_value_bwd(ct, plan_c, wxy_c, zi_c, wz_c, n_grid)

    def k3_cubic_plain():
        return tricubic.rows_value_transpose_ref(ct, ri_c, wxy_c, zi_c, wz_c,
                                                 (n_rows, n_grid))

    got, same = _same_twice(k3_cubic)
    want = k3_cubic_plain()
    err_c = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(same, "K3 cubic shape bitwise equal across two calls")
    check(err_c <= 1e-4 * scale, f"K3 cubic-shape max|err| {err_c:.3e} <= "
                                 f"1e-4*max|out| {1e-4 * scale:.3e}")
    ms = device_ms(k3_cubic, 20)
    plain = device_ms(k3_cubic_plain, 3)
    lib_ms = device_ms(index_add_call(*tricubic.transpose_terms(
        ct, ri_c, wxy_c, zi_c, wz_c, (n_rows, n_grid)), n_rows * n_grid), 20)
    b_ms, b_by = k3_bound(ct, ri_c, wxy_c, zi_c, wz_c, plan_c,
                           n_grid)
    print(f"  K3 cubic shape (K=16, L=4) at {n} points: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    if parent is not None:
        pplan = parent.plan(ri_c, n_rows)
        compare_parent(
            "K3 cubic shape",
            lambda: parent.k3(ct, pplan, wxy_c, zi_c, wz_c, n_rows, n_grid),
            k3_cubic, 5)

    # K1eᵀ at the same edge-case points
    cv = ct
    cg = t(rng.normal(size=(n, 3)).astype(np.float32))
    eplan = boxspline.endpoint_plan(grid, pts)
    print_plan("K1eT", eplan)

    def k1et():
        return kernels.zp_value_grad_bwd(grid, pts, cv, cg, eplan)

    def k1et_plain():
        return boxspline.interp_rows_with_grad_transpose_ref(grid, pts, cv,
                                                             cg)

    got, same = _same_twice(k1et)
    want = k1et_plain()
    err_e = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()), "K1eT output finite")
    check(same, "K1eT bitwise equal across two calls")
    check(not bool(eplan.counters.any()), "K1eT plan counters back at zero")
    check(err_e <= 1e-4 * scale, f"K1eT max|err| {err_e:.3e} <= "
                                 f"1e-4*max|out| {1e-4 * scale:.3e}")
    ms = device_ms(k1et, 20)
    plain = device_ms(k1et_plain, 3)
    lib_ms = device_ms(index_add_call(*boxspline.transpose_terms(
        grid, pts, cv, cg), n_rows * n_grid), 20)
    b_ms, b_by = k1et_bound(pts, cv, cg, eplan, n_grid)
    print(f"  K1eT at {n} points: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if parent is not None:
        pplan = parent.plan(ri[:, :boxspline.ZP_LIVE_TRANSLATES]
                            .contiguous(), n_rows)
        compare_parent("K1eT at the edge-case points",
                       lambda: parent.k1et(grid, pts, cv, cg, pplan), k1et, 5)


def make_rays(n_ants, n_dirs, seed=0, spread_km=150.0, zen_max=0.6):
    """Antenna ENU positions and near-zenith unit directions, drawn as
    ``bench/common.make_rays`` draws them."""
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-spread_km, spread_km, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, zen_max, n_dirs)
    az = rng.uniform(0, 2 * np.pi, n_dirs)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    return ants, dirs


def bent_dtec(m_true, grid, ants, dirs, fermat, rays, noise_frac, seed=0):
    """Paired dTEC observations as ``bench/common.bent_dtec_data`` makes
    them, traced through the zp model (K1, leapfrog@256, 150 MHz, 1000 km;
    the bench traces the cubic model, which the port does not have yet),
    plus numpy Gaussian noise of noise_frac·std. Returns (d (Na, Nd) on the
    grid's device, noise std)."""
    dev = grid.device
    o, d = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                               torch.from_numpy(dirs).to(dev))
    _, tau = fermat.trace_rays(m_true, grid, o, d, FREQ_HZ, LENGTH_KM,
                               n_steps=256, keep_path=False,
                               method="leapfrog", interp="zp")
    tau = tau.reshape(-1, dirs.shape[0]).cpu().numpy()
    dt = tau - tau[0:1]
    noise = float(noise_frac * np.std(dt))
    dt = dt + noise * np.random.default_rng(seed).standard_normal(
        dt.shape).astype(np.float32)
    return torch.from_numpy(dt.astype(np.float32)).to(dev), noise


def profile_gn_step(solve):
    """Device time by kernel over one Gauss-Newton step (torch.profiler),
    and its share of the same step's wall time run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_us = solve(1)[1] * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(1)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  profiled GN step (cg=20): kernels {busy:.1f} us in "
          f"{sum(r[2] for r in rows)} launches; the step without the "
          f"profiler {wall_us:.1f} us, device busy {100 * busy / wall_us:.1f} "
          f"%")
    for key, us, count in rows[:16]:
        print(f"    {us:10.1f} us {count:5d}x  {key[:100]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    print(f"  host time by op (profiler on, {sum(r[1] for r in host):.1f} us "
          f"in all):")
    for key, us, count in host[:10]:
        print(f"    {us:10.1f} us {count:5d}x  {key[:100]}")


def phase6_solve(dev, boxspline, tricubic, fermat, rays, tec, kernels,
                 chapman, priors, solvers, results, profile=False,
                 parent=None, n_grid=N_GRID, n_ants=100, n_dirs=100):
    from ionotomo_tpu_torch.testing import SOLVE_KERNELS

    print(f"phase 6: the config-3b solve ({n_grid}^3, {n_ants}x{n_dirs} "
          f"rays, hermite@65, zp, gn=2, cg=20)")
    t0 = time.perf_counter()
    ants, dirs = make_rays(n_ants, n_dirs)
    nd = dirs.shape[0]
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(n_grid,) * 3,
                                       h_min_km=0.0, device=dev)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    truth = priors.GPCovariance.create(grid, sigma=0.3, length_scale=120.0,
                                       kind="von_karman")
    white = np.random.default_rng(7).standard_normal(grid.shape)
    m_true = m_prior + truth.sample(torch.from_numpy(
        white.astype(np.float32)).to(dev))
    d_obs, noise = bent_dtec(m_true, grid, ants, dirs, fermat, rays, 0.01)
    ants_h, dirs_h = make_rays(20, 50, seed=99)
    d_h, _ = bent_dtec(m_true, grid, ants_h, dirs_h, fermat, rays, 0.0)
    o, dv = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                                torch.from_numpy(dirs).to(dev))
    rb = rays.sample_straight_rays(o, dv, n_samples=65)
    o_h, dv_h = rays.make_ray_batch(torch.from_numpy(ants_h).to(dev),
                                    torch.from_numpy(dirs_h).to(dev))
    rb_h = rays.sample_straight_rays(o_h, dv_h, n_samples=129)
    cov = priors.GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                                     kind="von_karman")
    torch.cuda.synchronize()
    print(f"  world: grid {grid.shape} spacing "
          f"{[round(float(x), 3) for x in grid.spacing]} km, "
          f"{rb.num_rays} rays x {rb.num_samples} samples, noise "
          f"{noise:.4f}, set-up {time.perf_counter() - t0:.2f} s")

    def heldout(m):
        g = tec.dtec_paired(m, grid, rb_h, dirs_h.shape[0], 0, "zp")
        return float(torch.sqrt(torch.mean((g - d_h) ** 2)))

    # the operator on the kernels against the same operator on the plain
    # versions, both on the card
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32)
                         ).to(dev)
    y = torch.from_numpy(rng.normal(size=(rb.num_rays,)).astype(np.float32)
                         ).to(dev)
    op = tec.dtec_paired_linear(m_prior, grid, rb, nd, 0, "hermite", "zp")
    ref = tec.dtec_paired_linear_ref(m_prior, grid, rb, nd, 0, "hermite",
                                     "zp")
    jx, jty = op.apply(x), op.apply_t(y)
    rx, rty = ref.apply(x), ref.apply_t(y)
    torch.cuda.synchronize()
    for name, a, b in (("J", jx, rx), ("J^T", jty, rty)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(bool(torch.isfinite(a).all()), f"{name} finite")
        check(err <= 1e-4 * scale, f"{name} kernels vs plain max|err| "
                                   f"{err:.3e} <= 1e-4*max {1e-4 * scale:.3e}")
    lhs = float(torch.dot(jx.double(), y.double()))
    rhs = float(torch.sum(x.double() * jty.double()))
    rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    check(rel <= 1e-4, f"adjoint identity <Jx,y> {lhs:.6e} vs <x,J^T y> "
                       f"{rhs:.6e}: rel {rel:.3e} <= 1e-4")
    timings = {
        "J": cuda_ms(lambda: op.apply(x), 10),
        "J^T": cuda_ms(lambda: op.apply_t(y), 10),
        "J plain": cuda_ms(lambda: ref.apply(x), 3),
        "J^T plain": cuda_ms(lambda: ref.apply_t(y), 3),
        "apply_sqrt": cuda_ms(lambda: cov.apply_sqrt(x), 20),
        "prefilter": cuda_ms(lambda: boxspline.prefilter(x), 20),
        "prefilter_transpose": cuda_ms(
            lambda: boxspline.prefilter_transpose(x), 20),
    }
    for name, ms in timings.items():
        print(f"  {name}: {ms:.4f} ms")

    # K2, K3 and K1eᵀ alone at the solve's shapes (the 650,000 quadrature
    # points, the 20,000 endpoints), each against its plain version
    n_pts, n_ends = op.ri.shape[0], op.ends.shape[0]
    ct = torch.from_numpy(rng.normal(size=(n_pts,)).astype(np.float32)
                          ).to(dev)
    cv = ct[:n_ends].contiguous()
    cg = torch.from_numpy(rng.normal(size=(n_ends, 3)).astype(np.float32)
                          ).to(dev)
    table = x.reshape(op.table_shape)
    n_rows, nz = op.table_shape
    plan, eplan = op.row_plan, op.end_plan
    print_plan("K3 at the solve", plan)
    print_plan("K1eT at the solve", eplan)
    fwd_out = tricubic.rows_value(table, op.ri, op.wxy, op.zi, op.wz, True)
    at_solve_shape = {
        "rows_value_fwd": (
            lambda: tricubic.rows_value(table, op.ri, op.wxy, op.zi, op.wz,
                                        True),
            lambda: tricubic.rows_value_ref(table, op.ri, op.wxy, op.zi,
                                            op.wz, True),
            None,
            bound(nbytes(table, op.ri, op.wxy, op.zi, op.wz, fwd_out),
                  n_pts * FLOPS_K2_POINT)),
        "rows_value_bwd": (
            lambda: tricubic.rows_value_transpose(ct, op.ri, op.wxy, op.zi,
                                                  op.wz, op.table_shape,
                                                  plan),
            lambda: tricubic.rows_value_transpose_ref(ct, op.ri, op.wxy,
                                                      op.zi, op.wz,
                                                      op.table_shape),
            index_add_call(*tricubic.transpose_terms(
                ct, op.ri, op.wxy, op.zi, op.wz, op.table_shape),
                n_rows * nz),
            k3_bound(ct, op.ri, op.wxy, op.zi, op.wz, plan, nz)),
        "zp_value_grad_bwd": (
            lambda: boxspline.interp_rows_with_grad_transpose(
                grid, op.ends, cv, cg, eplan),
            lambda: boxspline.interp_rows_with_grad_transpose_ref(
                grid, op.ends, cv, cg),
            index_add_call(*boxspline.transpose_terms(grid, op.ends, cv, cg),
                           n_rows * nz),
            k1et_bound(op.ends, cv, cg, eplan, nz)),
    }
    for name, (kern, plain, library, (b_ms, b_by)) in at_solve_shape.items():
        got, same = _same_twice(kern)
        want = plain()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(same, f"{name} at the solve's shape bitwise equal across two "
                    f"calls")
        check(err <= 1e-4 * scale, f"{name} at the solve's shape max|err| "
                                   f"{err:.3e} <= 1e-4*max {1e-4 * scale:.3e}")
        ms, plain_ms = device_ms(kern, 20), device_ms(plain, 5)
        ms_ev = cuda_ms(kern, 20)
        lib_ms = device_ms(library, 20) if library is not None else None
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"  {name} at the solve's shape: kernel {ms:.4f} ms (events "
              f"{ms_ev:.4f}), plain "
              f"{plain_ms:.4f} ms, one PyTorch call {lib}, bound "
              f"{b_ms:.4f} ms ({b_by})")
        results.setdefault(name, {})["line"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
    check(not bool(plan.counters.any() or eplan.counters.any()),
          "the solve's plan counters back at zero")
    if parent is not None:
        pplan = parent.plan(op.ri, n_rows)
        eplan_p = parent.plan(zp_rows(boxspline, grid, op.ends)
                              [:, :boxspline.ZP_LIVE_TRANSLATES]
                              .contiguous(), n_rows)
        compare_parent(
            "K3 at the solve's shape",
            lambda: parent.k3(ct, pplan, op.wxy, op.zi, op.wz, n_rows, nz),
            at_solve_shape["rows_value_bwd"][0], 20)
        compare_parent(
            "K1eT at the solve's shape",
            lambda: parent.k1et(grid, op.ends, cv, cg, eplan_p),
            at_solve_shape["zp_value_grad_bwd"][0], 20)
    del op, ref

    kw = dict(num_directions=nd, gn_iters=2, cg_iters=20,
              quadrature="hermite", interp="zp")

    def solve(linearize=None, gn_iters=2):
        t0 = time.perf_counter()
        res = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov,
                                       **{**kw, "gn_iters": gn_iters},
                                       linearize=linearize)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    solve()                                  # warm-up: allocator, cuFFT plans
    kernels.reset_launches()
    res1, secs1 = solve()
    launches = dict(kernels.launches)
    print(f"  launches in the solve: {launches}")
    for name in SOLVE_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in the solve ({launches[name]} times)")
    res2, secs2 = solve()
    resp, secs_p = solve(tec.dtec_paired_linear_ref)
    res3, secs3 = solve()
    check(bool(torch.isfinite(res1.m).all()), "solved field finite")
    check(bool(torch.equal(res1.m, res2.m) and torch.equal(res1.m, res3.m)),
          "the solve is bitwise equal across three runs")
    r_k, r_p = float(res1.residual_norm), float(resp.residual_norm)
    h_k, h_p, h_0 = heldout(res1.m), heldout(resp.m), heldout(m_prior)
    check(abs(r_k - r_p) <= 1e-2 * r_p,
          f"final whitened residual {r_k:.4f} within 1% of the plain "
          f"solve's {r_p:.4f}")
    check(abs(h_k - h_p) <= 1e-2 * h_p,
          f"held-out dTEC rms {h_k:.4f} within 1% of the plain solve's "
          f"{h_p:.4f}")
    check(h_k < h_0, f"held-out dTEC rms {h_k:.4f} below the prior's "
                     f"{h_0:.4f}")
    cg_its = [int(i) for i in res1.info[1]]
    print(f"  residual per GN step {[round(float(r), 4) for r in res1.info[0]]}"
          f", CG iterations {cg_its}")
    secs = [secs1, secs2, secs3]
    print(f"  kernel solve: {', '.join(f'{s:.4f}' for s in secs)} s; plain "
          f"solve {secs_p:.4f} s; CG iterations/s (kernel) "
          f"{sum(cg_its) / min(secs):.1f}")
    if profile:
        profile_gn_step(lambda g: solve(gn_iters=g))
    results["solve_launches"] = launches
    results["solve"] = {"seconds": secs, "plain_seconds": secs_p,
                        "residual": r_k, "plain_residual": r_p,
                        "heldout": h_k, "plain_heldout": h_p,
                        "prior_heldout": h_0, "timings_ms": timings}


def phase7_probe(dev, gather, kernels, results):
    print("phase 7: the gather probe")
    kernels.reset_launches()
    rec = gather.run(dev)
    n = kernels.launches["vector_gather"]
    print(f"  probe: {json.dumps(rec)}")
    check(n > 0, f"vector_gather launched in the probe ({n} times)")
    check(rec["vector_gather_supported"],
          "KG bitwise equal to torch.gather at (16384, 128)")
    check(rec["one_vreg_control_ok"],
          "KG bitwise equal to torch.gather at (8, 128)")
    rows, width = 16384, 128
    table, idx = gather.probe_inputs(rows, width, dev)
    ms = device_ms(lambda: gather.vector_gather(table, idx), 50)
    plain_ms = device_ms(lambda: gather.vector_gather_ref(table, idx), 50)
    b_ms, b_by = bound(3 * 4 * rows * width, 0)     # table, idx, out
    print(f"  KG at ({rows}, {width}): kernel {ms:.4f} ms, torch.gather "
          f"{plain_ms:.4f} ms (device time), bound {b_ms:.4f} ms ({b_by})")
    results["vector_gather"] = {"launches": n, "line": dict(
        max_abs_err=rec["max_abs_err"], ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=plain_ms)}


def kernels_line(results) -> dict:
    """The per-kernel JSON object of a run from the phases' results."""
    src = "ionotomo_tpu_torch/kernels/csrc/"
    # launches: K1, K1e and K2 in the serving run (phase 4), K3 and K1eᵀ in
    # the solve (phase 6), KG in the probe (phase 7). Error, ms and bound:
    # K1 at the bench shape (262144 rays); K1e at 2^20 points (phase 2); K2,
    # K3 and K1eᵀ at the solve's shapes (650,000 points, 20,000 endpoints);
    # KG at (16384, 128). library_ms: index_add_ of the precomputed
    # contributions for K3 and K1eᵀ, torch.gather for KG
    launches = {**results["launches"],
                **{k: results["solve_launches"][k]
                   for k in ("rows_value_bwd", "zp_value_grad_bwd")},
                "vector_gather": results["vector_gather"]["launches"]}
    entries = [
        ("trace_leapfrog_zp", "trace_leapfrog_zp.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("zp_value_grad", "zp_value_grad.cu",
         "ionotomo_tpu/core/boxspline.py:253"),
        ("rows_value_fwd", "rows_value_fwd.cu",
         "ionotomo_tpu/core/tricubic.py:284"),
        ("rows_value_bwd", "rows_value_bwd.cu",
         "ionotomo_tpu/core/tricubic.py:377"),
        ("zp_value_grad_bwd", "zp_value_grad_bwd.cu",
         "ionotomo_tpu/core/boxspline.py:253"),
        ("vector_gather", "vector_gather.cu", "bench/probe_gather.py:21"),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": launches[name],
         **{k: results[name]["line"][k] for k in keys}}
        for name, f, rep in entries]}


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    parent_dir = args[args.index("--parent") + 1] if "--parent" in args \
        else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core import boxspline, tricubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.inversion import priors, solvers
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman
    from ionotomo_tpu_torch.probes import gather

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print("phase 1: build")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s -> "
          f"{info['path'].name}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    build.load()

    parent = Parent(parent_dir) if parent_dir else None
    if parent is None:
        print("  no --parent DIR: phases 5 and 6 time this checkout's K3 and "
              "K1eT alone")
    results = {}
    phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results)
    phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card)
    phase4_serving(dev, boxspline, fermat, rays, tec, kernels, Grid3D, chapman,
                   results, profile)
    phase5_adjoint_kernels(dev, boxspline, tricubic, kernels, Grid3D,
                           results, parent)
    phase6_solve(dev, boxspline, tricubic, fermat, rays, tec, kernels,
                 chapman, priors, solvers, results, profile, parent)
    phase7_probe(dev, gather, kernels, results)

    line = kernels_line(results)
    solve = results["solve"]
    print(f"rays/s: kernel {results['rays_per_s']['kernel']:.1f}, plain "
          f"{results['rays_per_s']['plain']:.1f}; serving "
          f"{results['ms_per_epoch']:.3f} ms/epoch; config-3b solve "
          f"{min(solve['seconds']):.4f} s (plain {solve['plain_seconds']:.4f} "
          f"s)")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
