"""Drive the PyTorch/CUDA port's bent-ray forward path on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also: device time by kernel of
                                       # one serving epoch (torch.profiler)

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
   every kernel must have launched.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero at once, before any build.
"""
import json
import subprocess
import sys
import time

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


def edge_case_points(shape, origin, spacing, n, rng):
    """n points in index space mapped to world coordinates: uniform in and
    around the grid, exactly on lattice and half-lattice points, on the
    piece boundaries u+v = 0 and u−v = 0, and in the boundary cells."""
    nn = np.asarray(shape, np.float64)
    k = n // 8
    parts = [rng.uniform(-4.0, nn + 3.0, (n - 7 * k, 3)),
             rng.integers(0, nn, (k, 3)).astype(np.float64),
             rng.integers(0, nn - 1, (k, 3)) + 0.5]
    for sign in (1.0, -1.0):
        a = rng.choice([0.125, 0.25, 0.375, -0.25, 0.5], (k, 1))
        base = rng.integers(1, nn - 1, (k, 3)).astype(np.float64)
        parts.append(base + a * np.array([1.0, sign, 0.5]))
    parts.append(rng.uniform(-0.5, 1.5, (k, 3)))
    parts.append(nn - 1 - rng.uniform(-0.5, 1.5, (k, 3)))
    t = np.concatenate(parts, 0)
    return (np.asarray(origin) + t * np.asarray(spacing)).astype(np.float32)


def phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results):
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
    ms_big = cuda_ms(lambda: kernels.zp_value_grad(table, grid, pts), 20)
    plain_big = cuda_ms(
        lambda: boxspline.interp_rows_with_grad_ref(table, grid, pts), 3)
    print(f"  K1e at 2^20 points: kernel {ms_big:.4f} ms, plain "
          f"{plain_big:.4f} ms")
    results["zp_value_grad"] = {"max_abs_err": err_v, "err_grad": err_g,
                                "ms_2^20": ms_big, "plain_ms_2^20": plain_big}

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
    print(f"  K2 zp at 2^20 points: kernel {ms_big:.4f} ms, plain "
          f"{plain_big:.4f} ms")
    results["rows_value_fwd"] = {"max_abs_err": err_r, "ms_2^20": ms_big,
                                 "plain_ms_2^20": plain_big}

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
    results["trace_leapfrog_zp"] = {"max_abs_err": err_x, "tau_rel": err_t}


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
    ms = cuda_ms(lambda: kernels.trace_leapfrog_zp(
        coef2d, grid, o, d, N_STEPS, False, **kw), 3)
    ne_vg = fermat.log_field_ne_vg(
        lambda x: boxspline.interp_rows_with_grad_ref(coef2d, grid, x))
    plain_ms = cuda_ms(lambda: fermat._trace_impl(
        ne_vg, o, d, FREQ_HZ, LENGTH_KM, N_STEPS, False, "leapfrog"), 1)
    print(f"  K1 alone at 262144 rays: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    results["trace_leapfrog_zp"].update(ms=ms, plain_ms=plain_ms)
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
    print("phase 4: serving slice (predict --bent, zp, hermite)")
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3)
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
    print(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the main path ({n} times)")

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


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core import boxspline, tricubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

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

    results = {}
    phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results)
    phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card)
    phase4_serving(dev, boxspline, fermat, rays, tec, kernels, Grid3D, chapman,
                   results, profile)

    src = "ionotomo_tpu_torch/kernels/csrc/"
    # per-kernel ms: K1 at the bench shape (262144 rays); K1e and K2 at
    # 2^20 points
    entries = [
        ("trace_leapfrog_zp", "trace_leapfrog_zp.cu",
         "ionotomo_tpu/geometry/fermat.py:204", "ms", "plain_ms"),
        ("zp_value_grad", "zp_value_grad.cu",
         "ionotomo_tpu/core/boxspline.py:253", "ms_2^20", "plain_ms_2^20"),
        ("rows_value_fwd", "rows_value_fwd.cu",
         "ionotomo_tpu/core/tricubic.py:284", "ms_2^20", "plain_ms_2^20"),
    ]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": results["launches"][name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name][ms], "plain_ms": results[name][pms]}
        for name, f, rep, ms, pms in entries]}
    print(f"rays/s: kernel {results['rays_per_s']['kernel']:.1f}, plain "
          f"{results['rays_per_s']['plain']:.1f}; serving "
          f"{results['ms_per_epoch']:.3f} ms/epoch")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
