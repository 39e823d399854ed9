"""Drive the PyTorch/CUDA port's bent-ray forward paths, its MAP inversion
paths on the zp and the tricubic field model, and its time-evolving path
(the frozen-flow Kalman filter and the ensemble filter), on one NVIDIA
GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also: device time by kernel of
                                       # one serving epoch, one
                                       # Gauss-Newton step (and its host
                                       # time by op), one config-4 solve
                                       # (cubic, and with the zpc2 inner
                                       # Jacobian), one filter step and one
                                       # ensemble
                                       # step (torch.profiler)
    python3 chip_smoke.py --parent DIR # also: hold the kernels to those of
                                       # the checkout at DIR (the commit
                                       # before the zpc and triquadratic
                                       # kernels were added; any other
                                       # sources are refused):
                                       # every kernel bitwise at the
                                       # phases' shapes and timed in
                                       # turns; config 4's solve, config
                                       # 5's first chunk and the ensemble
                                       # filter bitwise on the parent's
                                       # kernels
    python3 chip_smoke.py --gather-study
                                       # only: what binds KG at the probe's
                                       # shapes (its kernel against the
                                       # table in a cluster's or a CTA's
                                       # shared memory; warm and L2
                                       # cleared) and the point order's
                                       # permute (by design and tile) at
                                       # config 4's and 3b's points
    python3 chip_smoke.py --e-study    # only: what binds E, the endpoint
                                       # kernels K1e and K5, at serving's
                                       # and configs 3b, 4 and 5's
                                       # endpoints (block size, ray or
                                       # endpoint order; 8 x K1e against
                                       # the batched K1e)
    python3 chip_smoke.py --k2-study   # only: what binds K2 at config 4's
                                       # two bundles and config 3b's zp
                                       # points (ray or point order,
                                       # vector or scalar loads of a
                                       # point's inputs, the one-cell
                                       # floor, the distinct values)
    python3 chip_smoke.py --k1-study   # only: what binds K1 at bench.py's
                                       # 262,144 rays and serving's 620
                                       # (table layout, ray order, block
                                       # size)
    python3 chip_smoke.py --k1c-study  # only: what binds K1c at config 2's
                                       # saturated batch (table layout, ray
                                       # order, block size, steps) and its
                                       # 6,200 rays
    python3 chip_smoke.py --k5t-study  # only: K5ᵀ's register budget at
                                       # config 4's endpoints and phase 8's
                                       # shapes (a library built for each)
    python3 chip_smoke.py --member-study
                                       # only: K2b's and K3b's calls by
                                       # kernel at config 5's bundles and
                                       # the zp edge-case points, and both
                                       # built with other scan, fold and
                                       # register settings
    python3 chip_smoke.py --plain-solves N [--root DIR]
                                       # only: config 4's plain-version
                                       # solve N times for the package of
                                       # this checkout or of the one at
                                       # DIR, each residual and held-out
                                       # rms to full precision

    python3 chip_smoke.py --serving-loop [--root DIR]
                                       # only: the serving slice's host
                                       # clock over long loops (7 rounds
                                       # of 25 passes over phase 4's four
                                       # epochs), for the package of this
                                       # checkout or of the one at DIR;
                                       # run the two in turns to compare
                                       # them (phase 4's own figure is one
                                       # pass over four epochs and catches
                                       # the host's jitter)

Phases (any failed check raises, and the run exits non-zero):

1. Build the CUDA kernels from ``ionotomo_tpu_torch/kernels/csrc``; print
   the card's name and power limit and the build time.
2. Each kernel against its plain PyTorch version on the card: K1e
   (zp value + gradient) and K2 (row-gather value map) at 2^20 points of
   a random 128³ table, including points outside the grid, on lattice and
   half-lattice points and on u±v = 0 (K1e's bound: the distinct values
   its points touch), K2 over the point order bitwise K2
   in ray order; K1 (the leapfrog zp tracer) against the plain tracer on
   8192 rays of the phase-3 world, and packed and sorted bitwise the
   unpacked kernel in ray order, path on and off; K1's pack bitwise its
   plain version. Then the zpc and triquadratic kernels: K6z and K6q
   (value + gradient) at the 917,504 edge-case points of a random 128³
   table and 2^20 random points of a random 256³ table, against their
   plain versions and their twins in the kernels' order (1e-5·max|table|),
   K6zᵀ adding into a random table at the same points (as K5ᵀ below), K2
   at zpc's (K=8, L=4) shape over its point order bitwise the generic
   kernel, K1z and K1q against the plain tracer on 8192 rays (1e-3 km,
   1e-5 relative TEC), path on and off, and bitwise the unpacked kernels.
3. Throughput of the tracer in the headline configuration of ``bench.py``:
   128³ Chapman, 262144 rays, leapfrog@64, 150 MHz, 1000 km, zp, no path;
   the trace launches K1, its pack and the sort keys once each; K1's call
   (pack, sort, trace) bitwise the unpacked kernel in ray order and timed
   by kernel. The same for K1z (zpc, over K1c's pack) and K1q (quadratic,
   over K1's pack), rays/s beside K1's; the rk4 trace on quadratic
   against the plain tracer, K6q launched once a stage, and K6q timed at
   the bench trace's points halfway.
4. The serving slice, as ``predict --bent --interp zp --quadrature
   hermite`` runs it: ``make_ray_batch`` → ``trace_rays(keep_path=True)``
   → ``dtec_paired_q``, 62 antennas × 10 directions, 4 epochs on a 128³
   perturbed Chapman world. The kernel path runs twice and must agree
   bitwise; it must match the plain path (CPU tensors) to 1e-4·max|dTEC|;
   K1, K1e and K2 must have launched. K1's call at the serving batch
   (which packs and sorts nothing) bitwise the unpacked kernel, path on
   and off, and timed; K1e at the first epoch's 1,240 endpoints against
   its plain version, timed beside its bound.
5. The adjoint kernels against their plain versions on the card: K3 (the
   transpose of K2) at 2^20 zp points of a random 128³ table, edge cases
   included (917,504 points: a corner row gets 131,640 of the 7 live
   translates' pairs), and at
   the cubic shape (K=16, L=4); K1eᵀ (the transpose of K1e) at the same
   points. Each within 1e-4·max|out| and bitwise equal across two calls;
   the plan's segment count and busiest segment and row; kernel, plain,
   ``index_add_`` and bound ms. K2 over the point order bitwise K2 in
   ray order at the same points, on zp and cubic.
6. The config-3b solve (``bench/config3b.py``) at full width: a 128³ grid
   enclosing 100 × 100 rays, truth = Chapman + a von Kármán perturbation
   (σ 0.3, outer scale 120 km), data from K1 at 256 steps and 150 MHz with
   1 % noise, ``map_gauss_newton`` with a von Kármán prior at 80 km over
   65-sample Hermite straight rays on zp, gn=2, cg=20. The linearised
   operator on the kernels against the same operator on the plain
   versions (1e-4·max|·|, adjoint identity 1e-4); K2 (over the
   geometry's point order, bitwise K2 in ray order), K3 and K1eᵀ alone at
   the solve's shapes against their plain versions (1e-4·max|out|, bitwise
   equal across two calls, kernel, plain, ``index_add_`` and bound ms, the
   plans' segments), the point order's keys, sort and permute at the
   650,000 zp points beside the permute's ``index_select`` and bound, and
   K1e at its 20,000 endpoints; the solve three times, bitwise
   equal, and within 1 % of the plain-version solve in final residual and
   held-out dTEC rms (20 × 50 rays, seed 99), beating the prior there; K2,
   K3, K1e, K1eᵀ, the point order's keys and its permute must have
   launched in the solve.
7. The gather probe (``ionotomo_tpu_torch.probes.gather``): KG against
   ``torch.gather`` at (16384, 128) and (8, 128), bitwise; KG must have
   launched; its row-gather baseline (chained K5 evaluations) must run.
   KG and ``torch.gather`` at both shapes timed warm and with the L2
   cleared before each launch, beside KG's bound (the distinct table
   values its indices touch).

8. The tricubic kernels against their plain versions on the card: K5
   (value + gradient) and K5ᵀ (its transpose, added into a random table:
   against the table + the plain version, bitwise the table + K5ᵀ into
   zeros, timed into one running table beside ``index_add_`` into one) at
   the edge-case points of a random 128³ table and at 2^20 random points
   of a random 256³ table (64 MiB, past the L2); K1c (the leapfrog tracer
   over cubic: ray sort, pack and trace) against
   the plain tracer on 8192 rays of the phase-3 world, path on and off;
   K4 (``tec_linear_adjoint`` on cubic, which is K3 over the cubic row
   plan) against ``index_add_`` of the 64 stencil weights per sample. Each
   within 1e-4·max|out| (K5 1e-5·max|table|, the tracer 1e-3 km and 1e-5
   relative TEC), the scatters bitwise equal across two calls.
9. Config 2 on cubic at full width through ``configs.config2``: 62 × 100
   rays and 262144 rays at leapfrog@128 on a 128³ Chapman cube, then
   262144 rays at leapfrog@64 beside phase 3's zp number; K1c must have
   launched, and at the saturated batch the pack and the sort-key
   kernels it launches first; K1c against the plain tracer on config 2's
   own two ray arrays at 128 steps (endpoints 1e-3 km, TEC 1e-5
   relative), its time alone read by ``device_ms`` and by ``cuda_ms``, by
   kernel, and its bound; the pack and the keys bitwise their plain
   versions, each timed with its bound.
10. Config 4 at full width through ``configs.config4``: a 256³ grid
   enclosing 100 × 100 rays, the analytic world (512 Fourier modes,
   amplitude 0.25, 120 km, seed 11) traced by ``trace_rays_callable`` at
   256 steps + 1 % noise, a von Kármán prior (σ 0.3, 80 km), Hermite@65
   with the @33 bundle, progressive, warm start, cg 20 then 10, cubic. The
   linearised operator on the kernels against the plain-version operator
   (1e-4·max, adjoint identity 1e-4); K2 (over the geometry's point
   order, bitwise K2 in ray order, timed in both orders) and K3 at the
   solve's two shapes (650,000 and 330,000 points, a (65536, 256) table),
   the point order's keys, sort and permute at 650,000, K5 and K5ᵀ at its
   20,000 endpoints (K5ᵀ adding into a K3 table), the kernels one Jᵀ
   launches, K4 at 650,000 points; the solve twice, bitwise
   equal, the plain-version solve (whose scatters sum in a fixed order)
   twice, bitwise equal, and the kernel solve within 1 % of it in final
   residual and held-out dTEC rms (20 × 50 rays, seed 99) and better than
   the prior (the plain solve gathers whole rows, 10.6 GB at 650,000
   points: if the card's free memory does not hold it, it runs one
   Gauss-Newton step on the @33 bundle and the printed line says so); K2,
   K3, K5, K5ᵀ, the point order's keys and its permute must have
   launched; the same solve with ``interp_inner="zpc2"`` (the
   reference's mixed-fidelity 256³ route): K2 at (K=8, L=4) over each
   bundle's point order, K6z and K6zᵀ at the solve's endpoints, the solve
   twice bitwise equal (the card's version of the reference's zpc
   determinism gate), within 1 % of the plain-version solve in residual
   and held-out rms, below the prior; then the same solve with
   ``interp_inner="zp"`` twice: a printed finding (bitwise equal or not,
   held-out rms, seconds), not a check.

Then config 5's world at full width (``configs.config5_world``: a 128³
grid enclosing 100 × 100 rays, 30 epochs of bent-ray dTEC through the
analytic world drifting with the wind, 1 % noise), and on it:

11. The member-axis kernels K2b and K3b with 8 members at config 5's
   outer (650,000 points) and inner (330,000) bundles and at the 917,504
   edge-case points of a 128³ grid on zp and on cubic (one corner row
   holds 131,595 zp and 402,199 cubic pairs): within 1e-4·max|out| of
   the plain versions, every member bitwise equal to K2 or K3 on that
   member, K3b bitwise equal across two calls; kernel (the whole call:
   the pack, and K3b's fold, included), plain, ``index_add_`` (along the
   table axis) and bound ms, beside 8 × the unbatched kernel, and each
   call's time by kernel; at the outer bundle the pack of the 8 tables
   and the fold of random partial rows alone, bitwise their plain
   versions, with their bounds. The batched K1e (E over 8 members, one
   launch) at config 5's 20,000 endpoints and at the zp edge-case
   points: every member bitwise K1e on that member, within 1e-5·max of
   the plain version, beside 8 launches of K1e and its bound.
12. Config 5 through ``configs.config5``: the Kalman filter over 30
   epochs, zp, Hermite@65 with the @33 inner bundle, cg 10, in 5 chunks
   of 6. K2, K3, K1e and K1eᵀ must have launched, no member-axis kernel
   and no plain version; two runs bitwise equal; one call of 30 steps
   bitwise equal to the chained chunks; every update lowers its residual;
   held-out dTEC rms (20 × 50 rays, seed 99, at the last epoch) below the
   prior's; the first chunk within 1 % of the filter on the plain
   versions (residuals and held-out rms). Seconds for 30 steps, steps/s,
   the bench's metrics, row plans built; K1e at the 20,000 endpoints.
13. The ensemble filter on the same world (``configs.config5_enkf``): 8
   members, the first 6 epochs, cg 10, inner @33, noise from a numpy
   seed. K2b, K3b, the pack and the fold of the member axis, the batched
   K1e and K1eᵀ must have launched, the unbatched K2 and K3 not at all,
   the unbatched K1e never and the batched K1e once per application of E
   (counted around ``PairedDtecLinear._value_grad``), K1eᵀ a multiple of
   8 times, no plain version; two runs bitwise equal; 6 steps in one
   call bitwise equal to
   3 + 3 chained through ``ens0``/``step_offset``; the mean's held-out
   rms at epoch 5 below the prior's; spread finite and positive; one step
   within 1 % of the filter on the plain versions. Seconds a step beside
   8 × the point filter's; the SHA-256 of the final ensemble, mean_seq
   and std_seq (with ``--parent``: equal to the same run's on the
   parent's kernels).

With ``--parent``, KG at both of phase 7's shapes and the permute at
phases 6 and 10 are bitwise the parent's and timed in turns with it, as
are K1e at every shape above, K5 at phases 8 and 10 and the batched K1e.

The last lines are a JSON object of per-kernel results (each kernel's
bound: the larger of the bytes it must move over 3.35 TB/s and its f32
operations over 67 TFLOP/s, from this run's inputs), the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero at once, before any build.
"""
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


def agreed_reading(readings, tol=0.1):
    """The larger of the last two readings if they agree within ``tol`` of
    it, else None: a profiler trace that lost records reads low, and two
    traces in a row rarely lose the same share."""
    if len(readings) < 2:
        return None
    a, b = readings[-2:]
    return max(a, b) if abs(a - b) <= tol * max(a, b) else None


def whole_readings(traces, reps):
    """Per-call ms of each profiler trace with its lost records made good.
    A trace is ``{kernel name: (records, summed µs)}`` over ``reps`` equal
    calls. Records get lost whole (seen: 17 of 20 launches of one kernel in
    most traces, two or three of five ``index_add_`` calls) while the
    durations of those that remain are right, so a kernel counts its mean
    duration times its launches a call, the most records any trace holds
    over ``reps``, rounded: a stray record (a first-use copy) rounds to
    none. A trace with no kernel left reads None."""
    names = {name for t in traces for name in t}
    per_call = {name: round(max(t.get(name, (0, 0.0))[0] for t in traces)
                            / reps) for name in names}
    out = []
    for t in traces:
        kept = [(n, us, per_call[name]) for name, (n, us) in t.items()
                if per_call[name] > 0 and n > 0]
        out.append(sum(us / n * k for n, us, k in kept) / 1e3
                   if kept else None)
    return out


def device_ms(fn, reps: int, exclude=()) -> float:
    """Mean device time of ``fn`` in ms: the durations of the kernels (and
    copies) it runs on the card, those named in ``exclude`` left out (an
    L2 flush, ``l2_flush``), from torch.profiler's CUPTI trace over
    ``reps`` calls after a warm-up. Unlike ``cuda_ms`` it does not count
    the card waiting for the host between launches, which is most of a
    small kernel's wall time here. A trace can come back empty or short of
    records, so every trace is read with its lost records made good
    (``whole_readings``), and traces are taken until two in a row agree
    within 10 % (``agreed_reading``). After six traces without such a pair
    the largest reading is taken and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        traces.append({e.key: (e.count, e.self_device_time_total)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and e.key not in exclude})
        readings = [r for r in whole_readings(traces, reps) if r is not None]
        ms = agreed_reading(readings)
        if ms is not None:
            return ms
    if not readings:
        raise RuntimeError("torch.profiler recorded no device time in six "
                           "traces")
    print(f"  note: no two profiler traces in a row agreed, {readings}; "
          f"the largest is taken")
    return max(readings)


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
# One K2 cubic point: 16 rows x 4 taps, a multiply-add each, and 16
# pencils' multiply-adds with their set-up (32).
FLOPS_K2_CUBIC_POINT = 16 * 4 * 2 + 32
FLOPS_K1ET_POINT = 51
FLOPS_K1ET_PAIR = 78
# The tricubic evaluator (cubic_eval.cuh): per axis 44 (index, clamps, four
# weights and four derivative weights), so 132 a point; the contraction of
# 64 taps against wz and dwz 256, over y 96, over x 32, three divisions.
# K5ᵀ needs a point's set-up once (the three axes and the cotangent's three
# divisions, 135) and 24 for the four contributions of each (point, row)
# pair; that the kernel repeats the set-up in every pair is its own cost
# and no part of the bound. One K1c step is a K1 step with K5 in place of
# K1e.
FLOPS_K5_POINT = 519
FLOPS_K5T_POINT = 135
FLOPS_K5T_PAIR = 24
FLOPS_K1C_STEP = FLOPS_K1_STEP - FLOPS_K1E_POINT + FLOPS_K5_POINT
# The zpc evaluator (zpc_eval.cuh): the zp xy set-up (~60) and the
# Catmull-Rom z axis (44), 7 translates' weights (w, wu, wv: 18 each), the
# 7 x 4 taps against them (168), the 4 z sums (32) and three divisions,
# ~430 a point. The triquadratic evaluator (quad_eval.cuh): three axes
# (~15 each), 9 rows x 3 taps against wz and dwz (108), over y (54) and x
# (24) and three divisions, ~230. K6z^T: a point's set-up and its
# cotangent's three divisions (~110) once, and per (point, translate) pair
# the translate's weights (18) and four contributions (~36). A K1z or K1q
# step is a K1 step with K6z or K6q in place of K1e.
FLOPS_K6Z_POINT = 430
FLOPS_K6Q_POINT = 230
FLOPS_K6ZT_POINT = 110
FLOPS_K6ZT_PAIR = 54
# One K2 zpc point: 7 live rows x 4 taps, a multiply-add each, and the 4 z
# multiply-adds.
FLOPS_K2_ZPC_POINT = 7 * 4 * 2 + 4 * 2
FLOPS_K1Z_STEP = FLOPS_K1_STEP - FLOPS_K1E_POINT + FLOPS_K6Z_POINT
FLOPS_K1Q_STEP = FLOPS_K1_STEP - FLOPS_K1E_POINT + FLOPS_K6Q_POINT
#: the zpc and triquadratic kernels by their wrapper: (model module name,
#: live rows a point, flops a point, tracer, its pack, flops a step)
NEW_MODELS = {
    "zpc": ("zpcubic", 7, FLOPS_K6Z_POINT, "zpc_value_grad",
            "trace_leapfrog_zpc", "pack_z_taps", FLOPS_K1Z_STEP),
    "quadratic": ("triquadratic", 9, FLOPS_K6Q_POINT, "quad_value_grad",
                  "trace_leapfrog_quad", "pack_zp_taps", FLOPS_K1Q_STEP),
}
# One ray's sort key (ray_order_keys_kernel): four quantised coordinates
# (5-6 each), four 8-bit spreads (9 each) and the combination (6).
OPS_RAY_KEY = 64
# One point's row-major sort key (point_order_keys_kernel): two clamps and
# the row * nz + z (6).
OPS_POINT_KEY = 6
# What config 2's call of the cubic tracer launches at a batch that fills
# the card: the sort keys, the pack and the tracer.
CONFIG2_KERNELS = ("ray_order_keys", "pack_z_taps", "trace_leapfrog_cubic")


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


def distinct_taps(tricubic, grid, points) -> int:
    """How many distinct table values the 64-tap stencils of ``points``
    touch: points that share a cell, neighbouring cells and taps repeated
    by the edge clamp are counted once (host read, outside any timing)."""
    touched = torch.zeros(grid.num_voxels, dtype=torch.bool,
                          device=points.device)
    for chunk in points.split(1 << 18):
        flat, _ = tricubic.interp_weights(grid, chunk)
        touched[flat.reshape(-1).long()] = True
    return int(touched.sum())


def touched_values(ri, zi, n_rows, nz) -> int:
    """How many distinct table values the K x L taps of a row-gather point
    set touch (host read, outside any timing)."""
    touched = torch.zeros(n_rows * nz, dtype=torch.bool, device=ri.device)
    for r, z in zip(ri.split(1 << 18), zi.split(1 << 18)):
        flat = (r.long().clamp(0, n_rows - 1)[:, :, None] * nz
                + z.long().clamp(0, nz - 1)[:, None, :])
        touched[flat.reshape(-1)] = True
    return int(touched.sum())


def k2_bound(ri, wxy, zi, wz, n_rows, nz, live, flops_per_point):
    """K2 reads each point's inputs once (the live translates' columns of
    ri and wxy: zp's 8th has weight 0) and each distinct table value the
    live taps touch once, and writes a value a point."""
    n = ri.shape[0]
    return bound(nbytes(zi, wz, ri[:, :live], wxy[:, :live]) + 4 * n
                 + 4 * touched_values(ri[:, :live], zi, n_rows, nz),
                 n * flops_per_point)


def k1_bound(boxspline, kernels, coef2d, grid, o, d, n_steps, keep_path,
             consts):
    """K1 reads its rays once and each distinct table value that its
    evaluations touch once (the 7 live rows' 3 z taps at each of a ray's
    n_steps + 1 path points, the path from the kernel itself; host read,
    outside any timing), writes x_end, tau and the path if kept, and does
    ``FLOPS_K1_STEP`` a step."""
    _, nz = coef2d.shape
    path = kernels.trace_leapfrog_zp(coef2d, grid, o, d, n_steps, True,
                                     **consts)[2]
    touched = torch.zeros(coef2d.numel(), dtype=torch.bool, device=o.device)
    taps = torch.arange(-1, 2, device=o.device)
    for pts in path.reshape(-1, 3).split(1 << 20):
        ri, bz, _, _ = boxspline._live_setup(grid, pts)
        z = (bz.long()[:, None] + taps).clamp(0, nz - 1)
        touched[(ri.long()[:, :, None] * nz + z[:, None, :]).reshape(-1)] = \
            True
    r = o.shape[0]
    out = 16 * r + (12 * r * (n_steps + 1) if keep_path else 0)
    return bound(4 * int(touched.sum()) + nbytes(o, d) + out,
                 r * n_steps * FLOPS_K1_STEP)


def k1e_bound(boxspline, grid, points, members=1):
    """K1e (the batched K1e with ``members``) reads each point once and
    each distinct table value the 7 live rows' 3 z taps of its points
    touch once, of every member's table, and writes a value and a
    gradient per point and member; ``FLOPS_K1E_POINT`` an evaluation."""
    ri, _, zi, _ = boxspline.row_setup(grid, points)
    nx, ny, nz = grid.shape
    n = points.shape[0]
    touched = touched_values(ri[:, :boxspline.ZP_LIVE_TRANSLATES], zi,
                             nx * ny, nz)
    return bound(4 * members * touched + nbytes(points) + 16 * members * n,
                 members * n * FLOPS_K1E_POINT)


def k5_bound(tricubic, grid, points):
    """K5 reads each point once and each distinct table value its points
    touch once, and writes a value and a gradient per point."""
    n = points.shape[0]
    return bound(4 * distinct_taps(tricubic, grid, points) + nbytes(points)
                 + 16 * n, n * FLOPS_K5_POINT)


def k5t_bound(tricubic, grid, points, cv, cg, plan):
    """K5ᵀ adds into a table: the points and cotangents read once, and
    each distinct cell the stencils touch read and written once (the plan
    is not counted); a set-up per point and four contributions per
    pair."""
    n_bytes = (nbytes(points, cv, cg)
               + 8 * distinct_taps(tricubic, grid, points))
    return bound(n_bytes, points.shape[0] * FLOPS_K5T_POINT
                 + plan_stats(plan)["pairs"] * FLOPS_K5T_PAIR)


def k6_bound(model, live, flops, grid, points):
    """K6z or K6q reads each point once and each distinct table value the
    live rows' z taps of its points touch once, and writes a value and a
    gradient per point."""
    ri, _, zi, _ = model.row_setup(grid, points)
    nx, ny, nz = grid.shape
    n = points.shape[0]
    touched = touched_values(ri[:, :live], zi, nx * ny, nz)
    return bound(4 * touched + nbytes(points) + 16 * n, n * flops)


def k6zt_bound(zpcubic, grid, points, cv, cg, plan):
    """K6zᵀ adds into a table: the points and cotangents read once, and
    each distinct cell the 7 live rows' 4 z taps touch read and written
    once (the plan is not counted); a set-up per point and a translate's
    contributions per pair."""
    ri, _, zi, _ = zpcubic.row_setup(grid, points)
    nx, ny, nz = grid.shape
    n_bytes = (nbytes(points, cv, cg)
               + 8 * touched_values(ri[:, :7], zi, nx * ny, nz))
    return bound(n_bytes, points.shape[0] * FLOPS_K6ZT_POINT
                 + plan_stats(plan)["pairs"] * FLOPS_K6ZT_PAIR)


def trace_bound(model, live, tracer, flops_step, table, grid, o, d, n_steps,
                keep_path, consts):
    """A leapfrog tracer (K1z, K1q) reads its rays once and each distinct
    table value its evaluations touch once (the live rows' z taps at each
    of a ray's n_steps + 1 path points, the path from the kernel itself;
    host read, outside any timing), writes x_end, tau and the path if
    kept, and does ``flops_step`` a step."""
    nx, ny, nz = grid.shape
    path = tracer(table, grid, o, d, n_steps, True, **consts)[2]
    touched = torch.zeros(nx * ny * nz, dtype=torch.bool, device=o.device)
    for pts in path.reshape(-1, 3).split(1 << 20):
        ri, _, zi, _ = model.row_setup(grid, pts)
        touched[(ri[:, :live].long()[:, :, None] * nz
                 + zi.long()[:, None, :]).reshape(-1)] = True
    r = o.shape[0]
    out = 16 * r + (12 * r * (n_steps + 1) if keep_path else 0)
    return bound(4 * int(touched.sum()) + nbytes(o, d) + out,
                 r * n_steps * flops_step)


def kg_bound(table, idx):
    """KG reads its indices once, writes its output once and reads each
    distinct (row, column) table value its indices touch once (counted on
    the card with ``torch.unique``, the indices clamped as the kernel
    clamps them)."""
    rows, width = table.shape
    flat = (idx.long().clamp(0, rows - 1) * width
            + torch.arange(width, device=idx.device))
    distinct = int(torch.unique(flat).numel())
    return bound(2 * nbytes(idx) + 4 * distinct, 0), distinct


def l2_flush(dev, mib=128):
    """(fn, names): a write of a ``mib`` MiB buffer, which evicts the 50 MB
    L2, and the names of the kernels it runs, for ``device_ms(...,
    exclude=names)`` to time what follows it with the L2 cleared."""
    buf = torch.empty(mib << 18, dtype=torch.float32, device=dev)
    fn = buf.zero_
    return fn, frozenset(kernel_ms_by_name(fn, 1))


def check_k5t(label, tricubic, kernels, grid, pts, cv, cg, plan, table,
              parent=None, reps=20, plain_reps=2):
    """The accumulating K5ᵀ, table += Eᵀ(cv, cg), at one shape
    (``check_adding``)."""
    return check_adding(
        label, lambda t: kernels.cubic_value_grad_bwd(t, grid, pts, cv, cg,
                                                      plan),
        lambda: tricubic.interp_rows_with_grad_transpose_ref(grid, pts, cv,
                                                             cg),
        tricubic.value_grad_transpose_terms(grid, pts, cv, cg),
        k5t_bound(tricubic, grid, pts, cv, cg, plan), table, plan, parent,
        reps, plain_reps)


def check_adding(label, add, plain, terms, bnd, table, plan, parent=None,
                 reps=20, plain_reps=2):
    """An accumulating transpose (K5ᵀ, K6zᵀ), ``add(t)`` adding Eᵀ into
    the table t in place, at one shape: on fresh copies of ``table``
    against table + the plain version (1e-4·max), bitwise twice, bitwise
    table + (the kernel into zeros), counters back at zero; timed into one
    running table beside ``index_add_`` of the contributions ``terms``
    into a running table and its bound. With a parent: bitwise the
    parent's kernel, and both timed in turns into a running table."""
    def fresh():
        return add(table.clone())

    running = table.clone()
    alone = add(torch.zeros_like(table))
    check(bool(torch.equal(fresh(), table + alone)),
          f"{label}: table + the kernel is bitwise table + (the kernel into "
          f"zeros)")
    del alone
    line = check_and_time(
        label, fresh, lambda: table + plain(),
        index_add_call(*terms, table.numel()), bnd, scatter=True,
        reps=reps, plain_reps=plain_reps, timed=lambda: add(running))
    check(not bool(plan.counters.any()), f"{label}: plan counters back at "
                                         f"zero")
    if parent is not None:
        p_ms, n_ms = compare_parent(
            f"{label}: adding", lambda: parent.run(fresh), fresh, reps,
            pairs=3, new_timed=lambda: add(running),
            parent_timed=lambda: parent.run(lambda: add(running)))
        line["parent_ms"], line["new_ms_in_turns"] = p_ms, n_ms
    return line


def index_add_call(flat, contrib, size):
    """One PyTorch call computing the same scatter from the precomputed
    contributions: ``index_add_`` into a preallocated table (its zeroing
    not counted; atomics, so not reproducible)."""
    buf = torch.zeros(size, dtype=torch.float32, device=flat.device)
    return lambda: buf.index_add_(0, flat, contrib)


class Parent:
    """The kernels of the checkout at ``root`` (``--parent DIR``), the
    commit before the zpc and triquadratic kernels were added, built from
    its sources with this checkout's nvcc flags. ``run(fn)`` calls fn with
    every kernel the parent's: each entry through this checkout's wrapper
    on the parent's library (no C interface changed). The parent's library
    lacks the entries in ``NEW``, which it is opened without; the kernels
    behind them have no parent.

    ctypes cannot check a C interface, so the parent's sources are
    declared by their SHA-256, and any other checkout is refused rather
    than handed arguments it does not take."""

    NEW = ("ionotomo_zpc_value_grad", "ionotomo_quad_value_grad",
           "ionotomo_zpc_value_grad_bwd", "ionotomo_trace_leapfrog_zpc",
           "ionotomo_trace_leapfrog_quad")

    SOURCES = {
        "cubic_value_grad.cu":
            "e7a491381cdfbf7886294e643e79676595109eba094861c18f65d665a0a5aa74",
        "cubic_value_grad_bwd.cu":
            "f1365e6eed27d762ff3da6e783bd8dbfb59bc6d97a9672df8144124bf5a987c8",
        "rows_value_bwd.cu":
            "8b89433a04e2db28da6ebddbca603d78de2def71956e78422e93094e39d52d85",
        "rows_value_bwd_batched.cu":
            "10788403e8f237c3a501e37d334331abaece27724ff3bcb704ca481eea7126b8",
        "rows_value_fwd.cu":
            "6783cfd657ca403f4d3996ace63b911a1ce59d402dcad4615a056c687b7fb92c",
        "rows_value_fwd_batched.cu":
            "33b0b3474550fda8a1440c6ad76f61290a168eeaf73dfd0074e71c7df6c48c3b",
        "trace_leapfrog_cubic.cu":
            "8b2253a0dbd13030464fac466cbeba30c8954f061a6ec84282891ddc089c45c3",
        "trace_leapfrog_zp.cu":
            "14fd0ee9d2a9c1df8e7cbca6a55126f9eefa3fee1805f24971abc052b847f699",
        "vector_gather.cu":
            "e0d19a2da2d4ccef5782631ae780053fa77062ae0c19c1e7935b9ff7ee882216",
        "zp_value_grad.cu":
            "b1564e7deffe6544f3801decbe9d163022e5df8175680cdb9522da1a2203766a",
        "zp_value_grad_bwd.cu":
            "eb6fb1308c6193f1a528bdeb52ae7c21be3c7e667df9382c1eb590bc5e878d90",
    }

    def __init__(self, root):
        from ionotomo_tpu_torch.kernels import build

        csrc = Path(root) / "ionotomo_tpu_torch" / "kernels" / "csrc"
        got = {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
               for f in csrc.glob("*.cu")}
        if got != self.SOURCES:
            raise ValueError(
                f"--parent {root}: its kernel sources are not those of the "
                f"commit whose C interface this script binds (differ: "
                f"{sorted(set(got.items()) ^ set(self.SOURCES.items()))})")
        info = build.build(csrc, build.BUILD_DIR / "parent")
        self.build = build
        self.lib = build.open_library(
            info["path"], [n for n in build._SIGNATURES if n not in self.NEW])
        print(f"  parent kernels from {csrc} (built={info['built']} in "
              f"{info['seconds']:.2f} s)")

    def run(self, fn):
        """fn() with the parent's kernels behind this checkout's
        wrappers."""
        saved = self.build.load()
        self.build._loaded["lib"] = self.lib
        try:
            return fn()
        finally:
            self.build._loaded["lib"] = saved


def _outputs(x):
    return [t for t in (x if isinstance(x, (tuple, list)) else (x,))
            if t is not None]


def compare_parent(name, parent_fn, new_fn, reps, pairs=2, new_timed=None,
                   parent_timed=None):
    """The parent's and this checkout's function on the same inputs:
    bitwise equal outputs, then device time in turns, ``pairs`` pairs
    (parent, new, new, parent, ...), each as ``*_timed`` where given (a
    kernel that adds in place, into one running table). Returns (parent
    ms, new ms)."""
    a, b = _outputs(parent_fn()), _outputs(new_fn())
    torch.cuda.synchronize()
    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: bitwise the parent's output")
    del a, b
    t = {"parent": [], "new": []}
    for i in range(pairs):
        turn = ("parent", "new") if i % 2 == 0 else ("new", "parent")
        for who in turn:
            t[who].append(device_ms(parent_timed or parent_fn
                                    if who == "parent"
                                    else new_timed or new_fn, reps))
    print(f"  {name}, in turns: parent "
          f"{', '.join(f'{x:.4f}' for x in t['parent'])} ms; new "
          f"{', '.join(f'{x:.4f}' for x in t['new'])} ms")
    return t["parent"], t["new"]


def parent_bitwise(parent, name, fn):
    """With a parent: fn() on the parent's kernels (``Parent.run``) and on
    this checkout's, bitwise equal outputs; untimed."""
    if parent is None:
        return
    a, b = _outputs(parent.run(fn)), _outputs(fn())
    torch.cuda.synchronize()
    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: bitwise the parent's output")


def parent_same(parent, name, fn, reps, pairs=2):
    """A kernel whose C interface this checkout kept, through this
    checkout's wrapper on the parent's library and on its own
    (compare_parent)."""
    if parent is not None:
        compare_parent(name, lambda: parent.run(fn), fn, reps, pairs)


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


def check_k1_bitwise(label, kernels, coef2d, grid, o, d, kw, n_steps,
                     parent=None, paths=(False, True)):
    """K1 as the tracer calls it, and packed and sorted whatever the
    batch, each bitwise the unpacked kernel in ray order (one thread a
    ray, 128 a block: the parent's arithmetic and order); with a parent,
    the call bitwise the parent's K1 too."""
    packed = kernels.pack_zp_taps(coef2d, grid)
    order = kernels.ray_order(o, d, grid)
    for keep_path in paths:
        parent_bitwise(parent, f"{label}, keep_path={keep_path}: K1",
                       lambda: kernels.trace_leapfrog_zp(
                           coef2d, grid, o, d, n_steps, keep_path, **kw))
        want = kernels.trace_leapfrog_zp_with(
            coef2d, grid, o, d, n_steps, keep_path, packed=None, order=None,
            threads=128, **kw)
        for what, out in (
                ("the call", kernels.trace_leapfrog_zp(
                    coef2d, grid, o, d, n_steps, keep_path, **kw)),
                ("packed and sorted", kernels.trace_leapfrog_zp_with(
                    coef2d, grid, o, d, n_steps, keep_path, packed=packed,
                    order=order, threads=256, **kw))):
            check(all(torch.equal(a, b) for a, b in zip(out, want)
                      if b is not None),
                  f"{label}, keep_path={keep_path}: K1, {what}, bitwise the "
                  f"unpacked kernel in ray order")
        del want


def check_trace_bitwise(label, kernels, name, table, grid, o, d, kw,
                        n_steps, paths=(False, True)):
    """A tracer (K1z, K1q) as the tracer calls it, and packed and sorted
    whatever the batch, each bitwise the unpacked kernel in ray order
    (one thread a ray, 128 a block), path on and off."""
    model = next(v for v in NEW_MODELS.values() if v[4] == name)
    call, with_ = getattr(kernels, name), getattr(kernels, name + "_with")
    packed = getattr(kernels, model[5])(table, grid)
    order = kernels.ray_order(o, d, grid)
    for keep_path in paths:
        want = with_(table, grid, o, d, n_steps, keep_path, packed=None,
                     order=None, threads=128, **kw)
        for what, out in (
                ("the call", call(table, grid, o, d, n_steps, keep_path,
                                  **kw)),
                ("packed and sorted", with_(
                    table, grid, o, d, n_steps, keep_path, packed=packed,
                    order=order, threads=256, **kw))):
            check(all(torch.equal(a, b) for a, b in zip(out, want)
                      if b is not None),
                  f"{label}, keep_path={keep_path}: {name}, {what}, bitwise "
                  f"the unpacked kernel in ray order")
        del want


def generic_k2(kernels, table, ri, wxy, zi, wz, xy_first):
    """K2's generic kernel (the parent's arithmetic: one scalar load a
    value, one thread a point, in ray order), reached through inputs off
    a 16-byte boundary (``testing.off_boundary``)."""
    from ionotomo_tpu_torch.testing import off_boundary

    return kernels.rows_value_fwd(table, *map(off_boundary, (ri, wxy, zi,
                                                             wz)), xy_first)


def k2_order_check(label, kernels, tricubic, model, table, grid_shape,
                   setup, xy_first, parent=None):
    """K2 over the model's point order (its inputs permuted into it), and
    in ray order, each bitwise K2's generic kernel in ray order
    (``generic_k2``); returns the order (a ``tricubic.PointOrder``). With
    a parent, K2 over the order bitwise the parent's K2."""
    ri, wxy, zi, wz = setup
    order = model.point_order(ri, wxy, zi, wz, grid_shape)
    want = generic_k2(kernels, table, ri, wxy, zi, wz, xy_first)
    got = tricubic.rows_value(table, ri, wxy, zi, wz, xy_first, order=order)
    in_ray_order = tricubic.rows_value(table, ri, wxy, zi, wz, xy_first)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, want) and torch.equal(in_ray_order, want)),
          f"{label}: K2 over the point order and in ray order bitwise K2's "
          f"generic kernel in ray order ({ri.shape[0]} points)")
    parent_bitwise(parent, f"{label}: K2 over the point order",
                   lambda: tricubic.rows_value(table, ri, wxy, zi, wz,
                                               xy_first, order=order))
    return order


def point_order_line(label, kernels, model, setup, grid_shape, parent=None):
    """K2's point order at one point set: the key kernel bitwise its plain
    version and timed beside its bound (each point's base row and z read,
    its key written), the order (keys and ``torch.sort``), the whole
    ``PointOrder`` (and the inputs permuted), and the permute kernel alone
    beside its plain version, ``index_select`` and its bound (the inputs
    read and written once, the order read); with a parent, the permute
    bitwise the parent's and timed in turns with it. Returns the keys'
    and the permute's lines."""
    ri, _, zi, _ = setup
    base = model.BASE_TRANSLATE
    keys = kernels.point_order_keys(ri, zi, base, grid_shape)
    check(bool(torch.equal(keys, kernels.point_order_keys_ref(
        ri, zi, base, grid_shape))), f"{label}: the point order's keys "
                                     f"bitwise their plain version")
    n = ri.shape[0]
    ms = device_ms(lambda: kernels.point_order_keys(ri, zi, base,
                                                    grid_shape), 20)
    plain = device_ms(lambda: kernels.point_order_keys_ref(ri, zi, base,
                                                           grid_shape), 5)
    sort_ms = device_ms(lambda: kernels.point_order(ri, zi, base,
                                                   grid_shape), 20)
    build_ms = device_ms(lambda: model.point_order(*setup, grid_shape), 20)
    b_ms, b_by = bound(12 * n, n * OPS_POINT_KEY)
    print(f"  point order at {label}: the keys {ms:.4f} ms (plain "
          f"{plain:.4f} ms, bound {b_ms:.4f} ms, {b_by}); keys and sort "
          f"{sort_ms:.4f} ms; with K2's inputs permuted into it "
          f"{build_ms:.4f} ms, by kernel: " + "; ".join(
              f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                  kernel_ms_by_name(lambda: model.point_order(
                      *setup, grid_shape), 5).items(),
                  key=lambda kv: -kv[1])))
    # the permute kernel alone
    order = kernels.point_order(ri, zi, base, grid_shape)
    perm = order.long()

    def permute():
        return kernels.permute_points(order, *setup)

    got = permute()
    check(all(torch.equal(a, t[perm]) for a, t in zip(got, setup)),
          f"{label}: the permuted inputs bitwise their plain version")
    del got
    p_ms = device_ms(permute, 20)
    p_plain = device_ms(lambda: [t[perm] for t in setup], 5)
    p_lib = device_ms(lambda: [torch.index_select(t, 0, order)
                               for t in setup], 5)
    pb_ms, pb_by = bound(2 * nbytes(*setup) + nbytes(order), 0)
    print(f"  the permute at {label}: kernel {p_ms:.4f} ms, plain "
          f"{p_plain:.4f} ms, index_select {p_lib:.4f} ms, bound "
          f"{pb_ms:.4f} ms ({pb_by})")
    perm_line = dict(max_abs_err=0.0, ms=p_ms, plain_ms=p_plain,
                     bound_ms=pb_ms, bound_by=pb_by, library_ms=p_lib,
                     points=n)
    if parent is not None:
        perm_line["parent_ms"], perm_line["new_ms_in_turns"] = \
            compare_parent(f"the permute at {label}",
                           lambda: parent.run(permute), permute, 20, pairs=3)
    return (dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None, order_ms=sort_ms,
                 build_ms=build_ms, points=n), perm_line)


def k1e_at(label, kernels, boxspline, table, grid, pts, parent=None,
           reps=50):
    """K1e at one shape: against its plain version (1e-5·max|table|; the
    gradient over the smallest spacing too), timed beside the plain
    version and its bound (the distinct values its points touch); with a
    parent, bitwise the parent's K1e and timed in turns with it. Returns
    the shape's line."""
    def k1e():
        return kernels.zp_value_grad(table, grid, pts)

    v_k, g_k = k1e()
    v_p, g_p = boxspline.interp_rows_with_grad_ref(table, grid, pts)
    torch.cuda.synchronize()
    tmax = float(table.abs().max())
    err_v = float((v_k - v_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    gtol = 1e-5 * tmax / float(grid.spacing.min())
    check(bool(torch.isfinite(v_k).all() and torch.isfinite(g_k).all()),
          f"K1e at {label}: output finite")
    check(err_v <= 1e-5 * tmax and err_g <= gtol,
          f"K1e at {label}: value max|err| {err_v:.3e} <= 1e-5*max|table| "
          f"{1e-5 * tmax:.3e}, gradient {err_g:.3e} <= {gtol:.3e}")
    ms = device_ms(k1e, reps)
    plain = device_ms(lambda: boxspline.interp_rows_with_grad_ref(
        table, grid, pts), 5)
    b_ms, b_by = k1e_bound(boxspline, grid, pts)
    print(f"  K1e at {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}, distinct values)")
    line = dict(max_abs_err=err_v, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=pts.shape[0])
    if parent is not None:
        line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
            f"K1e at {label}", lambda: parent.run(k1e), k1e, reps, pairs=3)
    return line


def phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results, parent=None):
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
    results["k1e_edge"] = k1e_at(f"{pts.shape[0]} edge-case points",
                                 kernels, boxspline, table, grid, pts,
                                 parent, reps=20)
    v_k, _ = kernels.zp_value_grad(table, grid, pts)

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
    # the point order at 2^20 edge-case points, and on the random rows
    order = k2_order_check("phase 2, zp", kernels, tricubic, boxspline,
                           table, shape, (ri, wxy, zi, wz), True, parent)
    k2_order_check("phase 2, cubic shape on random rows", kernels, tricubic,
                   tricubic, table, shape, (ri_c, wxy_c, zi_c, wz_c), False,
                   parent)
    ms_big = device_ms(
        lambda: kernels.rows_value_fwd(table, ri, wxy, zi, wz, True), 20)
    ms_ord = device_ms(lambda: tricubic.rows_value(
        table, ri, wxy, zi, wz, True, order=order), 20)
    plain_big = cuda_ms(
        lambda: tricubic.rows_value_ref(table, ri, wxy, zi, wz, True), 3)
    b_ms, b_by = k2_bound(ri, wxy, zi, wz, *table.shape,
                          boxspline.ZP_LIVE_TRANSLATES, FLOPS_K2_POINT)
    print(f"  K2 zp at {ri.shape[0]} edge-case points: kernel {ms_big:.4f} "
          f"ms in ray order, {ms_ord:.4f} ms over the point order; plain "
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
    coef3 = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    check_k1_bitwise(f"phase 2, {o.shape[0]} rays", kernels, coef3, grid3, o,
                     d, kw, N_STEPS, parent)
    # K1's pack alone, bitwise its plain version
    packed = kernels.pack_zp_taps(coef3, grid3)
    torch.cuda.synchronize()
    check(bool(torch.equal(packed, boxspline.pack_z_taps_ref(coef3))),
          "K1's pack bitwise its plain version")
    p_ms = device_ms(lambda: kernels.pack_zp_taps(coef3, grid3), 20)
    p_plain = device_ms(lambda: boxspline.pack_z_taps_ref(coef3), 5)
    b_ms, b_by = bound(nbytes(coef3, packed), 0)
    print(f"  K1's pack of the 128^3 table: kernel {p_ms:.4f} ms, plain "
          f"{p_plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["pack_zp_taps"] = {"line": dict(
        max_abs_err=0.0, ms=p_ms, plain_ms=p_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)}


def phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card, parent=None):
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
        kernels.reset_launches()
        out = run()
        torch.cuda.synchronize()
        if name == "kernel":
            launches = dict(kernels.launches)
            for k in ("trace_leapfrog_zp", "pack_zp_taps", "ray_order_keys"):
                check(launches[k] == 1, f"the bench's trace launched {k} "
                                        f"once")
            results["bench_launches"] = launches
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
    # the kernel's call (the pack, the sort, the tracer) against the plain
    # integrator on the same table
    coef2d = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    check_k1_bitwise(f"phase 3, {n_rays} rays", kernels, coef2d, grid, o, d,
                     kw, N_STEPS, parent)

    def k1():
        return kernels.trace_leapfrog_zp(coef2d, grid, o, d, N_STEPS, False,
                                         **kw)

    ms = device_ms(k1, 3)
    ne_vg = fermat.log_field_ne_vg(
        lambda x: boxspline.interp_rows_with_grad_ref(coef2d, grid, x))
    plain_ms = cuda_ms(lambda: fermat._trace_impl(
        ne_vg, o, d, FREQ_HZ, LENGTH_KM, N_STEPS, False, "leapfrog"), 1)
    b_ms, b_by = k1_bound(boxspline, kernels, coef2d, grid, o, d, N_STEPS,
                          False, kw)
    print(f"  K1's call at {n_rays} rays (pack, sort and trace): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); by kernel: " + "; ".join(
              f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                  kernel_ms_by_name(k1, 3).items(), key=lambda kv: -kv[1])))
    if parent is not None:
        p_ms, n_ms = compare_parent(f"K1 at {n_rays} rays",
                                    lambda: parent.run(k1), k1, 3, pairs=3)
        results["trace_leapfrog_zp"]["line"].update(parent_ms=p_ms,
                                                    new_ms_in_turns=n_ms)
    results["trace_leapfrog_zp"]["line"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    results["rays_per_s"] = rates


def k6_at(label, kernels, model, name, table, grid, pts, reps=20,
          plain_reps=2):
    """K6z or K6q at one shape: bitwise twice; against its plain version
    and against its twin in the kernel's order (1e-5·max|table| the value,
    over the smallest spacing the gradient); timed beside the plain
    version and its bound (the distinct values its points touch). Returns
    the shape's line."""
    interp = {"zpc_value_grad": "zpc", "quad_value_grad": "quadratic"}[name]
    _, live, flops = NEW_MODELS[interp][:3]
    kern = getattr(kernels, name)
    (v_k, g_k), (v2, g2) = kern(table, grid, pts), kern(table, grid, pts)
    torch.cuda.synchronize()
    check(bool(torch.equal(v_k, v2) and torch.equal(g_k, g2)),
          f"{name} at {label}: bitwise equal across two calls")
    check(bool(torch.isfinite(v_k).all() and torch.isfinite(g_k).all()),
          f"{name} at {label}: output finite")
    tmax = float(table.abs().max())
    gtol = 1e-5 * tmax / float(grid.spacing.min())
    errs = []
    for what, ref in (("plain version", model.interp_rows_with_grad_ref),
                      ("twin in the kernel's order",
                       model.interp_rows_with_grad_taps_ref)):
        v_p, g_p = ref(table, grid, pts)
        err_v = float((v_k - v_p).abs().max())
        err_g = float((g_k - g_p).abs().max())
        del v_p, g_p
        check(err_v <= 1e-5 * tmax and err_g <= gtol,
              f"{name} at {label} against its {what}: value max|err| "
              f"{err_v:.3e} <= 1e-5*max|table| {1e-5 * tmax:.3e}, gradient "
              f"{err_g:.3e} <= {gtol:.3e}")
        errs.append(err_v)
    del v_k, g_k, v2, g2
    ms = device_ms(lambda: kern(table, grid, pts), reps)
    plain = device_ms(lambda: model.interp_rows_with_grad_ref(table, grid,
                                                              pts),
                      plain_reps)
    b_ms, b_by = k6_bound(model, live, flops, grid, pts)
    print(f"  {name} at {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}, distinct values)")
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=pts.shape[0])


def phase2_new_models(dev, tricubic, zpcubic, triquadratic, fermat,
                      kernels, Grid3D, chapman, results, sizes=(N_GRID, 256),
                      n_points=1 << 20, n_rays=8192):
    """Phase 2 on the zpc and triquadratic models: K6z and K6q at the
    edge-case points of a random 128³ table and at 2²⁰ random points of a
    random 256³ table, K6zᵀ adding into a random table at the same
    points, K2 at zpc's (8, 4) shape over its point order, K1z and K1q
    against the plain tracer on 8192 rays (path on and off) and bitwise
    the unpacked kernels."""
    from ionotomo_tpu_torch.core.field_models import field_model
    from ionotomo_tpu_torch.testing import edge_case_points

    print("phase 2 (zpc, quadratic): K6z, K6q, K6zT, K2 at (8, 4), K1z and "
          "K1q against their plain versions")
    mods = {"zpcubic": zpcubic, "triquadratic": triquadratic}
    rng = np.random.default_rng(21)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)   # dyadic: exact
    for n_grid, where in zip(sizes, ("edge-case", "random")):
        shape = (n_grid,) * 3
        n_rows = n_grid * n_grid
        grid = Grid3D.create(origin, spacing, shape, device=dev)
        field = t(rng.normal(size=shape).astype(np.float32))
        if where == "edge-case":
            pts = t(edge_case_points(shape, origin, spacing, n_points, rng))
        else:
            hi = np.asarray(spacing) * (n_grid - 1)
            pts = t((np.asarray(origin) + rng.uniform(0, 1, (n_points, 3))
                     * hi).astype(np.float32))
        tag = f"{pts.shape[0]} {where} points of a {n_grid}^3 table"
        for interp, (mod, _, _, name, *_) in NEW_MODELS.items():
            model = mods[mod]
            table = field_model(interp).table(field, grid).contiguous()
            results.setdefault(name + "_at", {})[f"{where}_{n_grid}"] = \
                k6_at(tag, kernels, model, name, table, grid, pts)
            if interp == "zpc" and where == "edge-case":
                # K2 at (8, 4): zpc's value gather over its point order
                setup = zpcubic.row_setup(grid, pts)
                k2_order_check(f"phase 2, zpc (K=8, L=4), {tag}", kernels,
                               tricubic, zpcubic, table, shape, setup, True)
                err = float((tricubic.rows_value(table, *setup, True)
                             - tricubic.rows_value_ref(table, *setup, True)
                             ).abs().max())
                tmax = float(table.abs().max())
                check(err <= 1e-5 * tmax,
                      f"K2 zpc (K=8, L=4) at {tag}: max|err| {err:.3e} <= "
                      f"1e-5*max|table| {1e-5 * tmax:.3e} against the plain "
                      f"version")
                del setup
            del table
        # K6zᵀ adding into a random table at the same points
        cv = t(rng.normal(size=(pts.shape[0],)).astype(np.float32))
        cg = t(rng.normal(size=(pts.shape[0], 3)).astype(np.float32))
        plan = zpcubic.endpoint_plan(grid, pts)
        print_plan(f"K6zT at {tag}", plan)
        base = t(rng.normal(size=(n_rows, n_grid)).astype(np.float32))
        results.setdefault("zpc_value_grad_bwd_at", {})[
            f"{where}_{n_grid}"] = check_adding(
                f"K6zT at {tag}",
                lambda tb: kernels.zpc_value_grad_bwd(tb, grid, pts, cv, cg,
                                                      plan),
                lambda: zpcubic.interp_rows_with_grad_transpose_ref(
                    grid, pts, cv, cg),
                zpcubic.value_grad_transpose_terms(grid, pts, cv, cg),
                k6zt_bound(zpcubic, grid, pts, cv, cg, plan), base, plan,
                reps=5)
        del field, pts, cv, cg, plan, base
        torch.cuda.empty_cache()

    # K1z and K1q on 8192 rays of the phase-3 world
    grid3 = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid3)).contiguous()
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(n_rays, seed=1))
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    for interp, (_, _, _, _, name, _, _) in NEW_MODELS.items():
        for keep_path in (False, True):
            args = (m, grid3, o, d, FREQ_HZ, LENGTH_KM)
            tkw = dict(n_steps=N_STEPS, keep_path=keep_path,
                       method="leapfrog", interp=interp)
            b_k, t_k = fermat.trace_rays(*args, **tkw)
            b_p, t_p = fermat.trace_rays_ref(*args, **tkw)
            torch.cuda.synchronize()
            tag = f"{name} keep_path={keep_path}"
            check(b_k.points.shape == b_p.points.shape,
                  f"{tag} shape {tuple(b_k.points.shape)}")
            err_x = float((b_k.points - b_p.points).abs().max())
            err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
            check(err_x <= 1e-3, f"{tag} path max|dx| {err_x:.3e} km <= "
                                 f"1e-3 km against the plain tracer")
            check(err_t <= 1e-5, f"{tag} tau max rel err {err_t:.3e} <= "
                                 f"1e-5")
            check(bool(torch.equal(b_k.ds, b_p.ds)), f"{tag} ds equal")
        results[name] = {"tau_rel": err_t, "line": dict(max_abs_err=err_x)}
        table = field_model(interp).table(m, grid3).contiguous()
        check_trace_bitwise(f"phase 2, {o.shape[0]} rays", kernels, name,
                            table, grid3, o, d, kw, N_STEPS)


def phase3_new_tracers(dev, fermat, kernels, Grid3D, chapman, results,
                       card, n_rays=262144):
    """Phase 3 on the zpc and triquadratic models: K1z and K1q at the
    bench's configuration (262144 rays, leapfrog@64, 150 MHz) through
    ``trace_rays``, launches counted, bitwise the unpacked kernels, timed
    beside the plain tracer and the bound; then the rk4 trace on
    quadratic, which runs K6q once a stage, against the plain tracer, its
    launches counted, and K6q alone at its points."""
    from ionotomo_tpu_torch.core import triquadratic
    from ionotomo_tpu_torch.core.field_models import field_model

    print("phase 3 (zpc, quadratic): K1z and K1q in the bench.py "
          "configuration, and the rk4 trace on quadratic")
    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(n_rays))
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    args = (m, grid, o, d, FREQ_HZ, LENGTH_KM)
    for interp, (_, live, _, _, name, pack, fstep) in NEW_MODELS.items():
        def run():
            return fermat.trace_rays(*args, n_steps=N_STEPS, keep_path=False,
                                     method="leapfrog", interp=interp)
        kernels.reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        for k in (name, pack, "ray_order_keys"):
            check(launches[k] == 1, f"the bench's trace on {interp} "
                                    f"launched {k} once")
        check(bool(torch.isfinite(out[1]).all()
                   and torch.isfinite(out[0].points).all()),
              f"{name}: finite endpoints and TEC")
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        rate = n_rays / dt
        rows = field_model(interp).rows
        table = field_model(interp).table(m, grid).contiguous()
        check_trace_bitwise(f"phase 3, {n_rays} rays", kernels, name, table,
                            grid, o, d, kw, N_STEPS, paths=(False,))
        tracer = getattr(kernels, name)

        def call():
            return tracer(table, grid, o, d, N_STEPS, False, **kw)

        ms = device_ms(call, 3)
        ne_vg = fermat.log_field_ne_vg(
            lambda x: rows.interp_rows_with_grad_ref(table, grid, x))
        plain_ms = cuda_ms(lambda: fermat._trace_impl(
            ne_vg, o, d, FREQ_HZ, LENGTH_KM, N_STEPS, False, "leapfrog"), 1)
        b_ms, b_by = trace_bound(rows, live, tracer, fstep, table, grid, o, d,
                                 N_STEPS, False, kw)
        print(f"  {interp}: {rate:.1f} rays/s ({dt * 1e3:.3f} ms per call, "
              f"prefilter included; zp {results['rays_per_s']['kernel']:.1f} "
              f"above) on {card}; {name}'s call (pack, sort and trace) "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); by kernel: " + "; ".join(
                  f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                      kernel_ms_by_name(call, 3).items(),
                      key=lambda kv: -kv[1])))
        results[name]["line"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None)
        results[name]["launches"] = launches[name]
        results["rays_per_s"][interp] = rate

    # rk4 on quadratic: K6q is the field evaluator of every stage
    rk4 = dict(n_steps=N_STEPS, keep_path=False, method="rk4",
               interp="quadratic")
    kernels.reset_launches()
    b_k, t_k = fermat.trace_rays(*args, **rk4)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["quad_value_grad"] == 1 + 4 * N_STEPS,
          f"the rk4 trace on quadratic launched K6q once a stage and once "
          f"for p0 ({launches['quad_value_grad']} times)")
    b_p, t_p = fermat.trace_rays_ref(*args, **rk4)
    err_x = float((b_k.points - b_p.points).abs().max())
    err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
    check(err_x <= 1e-3 and err_t <= 1e-5,
          f"rk4 on quadratic at {n_rays} rays: endpoints max|dx| "
          f"{err_x:.3e} km <= 1e-3 km, tau max rel err {err_t:.3e} <= 1e-5 "
          f"against the plain tracer")
    del b_k, b_p, t_k, t_p
    # K6q alone at the rk4 trace's points halfway along the rays
    table = triquadratic.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    mid = kernels.trace_leapfrog_quad(table, grid, o, d, N_STEPS, True,
                                      **kw)[2][:, N_STEPS // 2].contiguous()
    results["quad_value_grad"] = {
        "launches": launches["quad_value_grad"],
        "line": k6_at(f"the bench trace's {n_rays} points halfway",
                      kernels, triquadratic, "quad_value_grad", table, grid,
                      mid, reps=20, plain_reps=3)}


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
                   chapman, results, profile=False, parent=None):
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
    if parent is not None:
        check(all(torch.equal(parent.run(lambda: predict_bent(
            m, grid, a, dd, fermat, rays, tec)), k1)
            for (m, a, dd), k1 in zip(on_dev, runs[0][0])),
            "the serving epochs bitwise on the parent's kernels")
    # K1 at the serving batch: bitwise the unpacked kernel, timed, and in
    # turns with the parent's
    m, a, dd = on_dev[0]
    o, dv = rays.make_ray_batch(a, dd)
    coef2d = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    check_k1_bitwise(f"phase 4, {o.shape[0]} rays", kernels, coef2d, grid, o,
                     dv, kw, N_STEPS, parent)

    def k1():
        return kernels.trace_leapfrog_zp(coef2d, grid, o, dv, N_STEPS, True,
                                         **kw)

    ms = device_ms(k1, 20)
    b_ms, b_by = k1_bound(boxspline, kernels, coef2d, grid, o, dv, N_STEPS,
                          True, kw)
    print(f"  K1's call at the serving batch ({o.shape[0]} rays, {N_STEPS} "
          f"steps, path): {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); by "
          f"kernel: " + "; ".join(
              f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                  kernel_ms_by_name(k1, 20).items(), key=lambda kv: -kv[1])))
    results["k1_serving"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
    if parent is not None:
        results["k1_serving"]["parent_ms"], \
            results["k1_serving"]["new_ms_in_turns"] = compare_parent(
                f"K1 at the serving batch ({o.shape[0]} rays)",
                lambda: parent.run(k1), k1, 20, pairs=3)
    # K1e at the first epoch's endpoints, as predict_bent evaluates E
    grid_e, coef_e, ends = serving_endpoints(dev, boxspline, fermat, rays,
                                             tec, Grid3D, chapman)
    results["k1e_serving"] = k1e_at(
        f"the serving batch's {ends.shape[0]} endpoints", kernels, boxspline,
        coef_e, grid_e, ends, parent)
    if profile:
        profile_epoch(*on_dev[0][:1], grid, *on_dev[0][1:], boxspline,
                      fermat, rays, tec, kernels)
    results["launches"] = launches
    results["ms_per_epoch"] = runs[1][1] * 1e3


def serving_loop(root=None, rounds=7, passes=25) -> int:
    """``--serving-loop``: ms per serving epoch (host clock, synchronised
    at the end of a round) over ``rounds`` rounds of ``passes`` passes
    over phase 4's four epochs, least, median and greatest round, for the
    package found at ``root`` (default: beside this script)."""
    if root is not None:
        sys.path.insert(0, str(Path(root).resolve()))
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.models import chapman
    import ionotomo_tpu_torch

    dev = torch.device("cuda", 0)
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    grid = grid_cpu.to(dev)
    on_dev = [(torch.from_numpy(perturbed_log_field(grid_cpu, r, chapman))
               .to(dev), torch.from_numpy(a).to(dev),
               torch.from_numpy(dd).to(dev))
              for r, a, dd in serving_epochs()]

    def loop(n):
        for _ in range(n):
            for m, a, dd in on_dev:
                predict_bent(m, grid, a, dd, fermat, rays, tec)
        torch.cuda.synchronize()

    loop(5)
    ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        loop(passes)
        ms.append((time.perf_counter() - t0) / (passes * len(on_dev)) * 1e3)
    ms.sort()
    print(f"serving loop, package {Path(ionotomo_tpu_torch.__file__).parent}: "
          f"{ms[0]:.3f} / {ms[len(ms) // 2]:.3f} / {ms[-1]:.3f} ms per epoch "
          f"(least / median / greatest of {rounds} rounds of "
          f"{passes * len(on_dev)} epochs) on {card_line()}")
    return 0


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
    # K2 over the point order at the same points, on zp and cubic
    table = t(np.random.default_rng(55).normal(size=(n_rows, n_grid))
              .astype(np.float32))
    k2_order_check(f"phase 5, zp, {n} edge-case points", kernels, tricubic,
                   boxspline, table, shape, (ri, wxy, zi, wz), True, parent)
    k2_order_check(f"phase 5, cubic, {n} edge-case points", kernels,
                   tricubic, tricubic, table, shape,
                   tricubic.row_setup(grid, pts), False, parent)
    del table
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
    parent_same(parent, "K3 zp at the edge-case points", k3, 5)

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
    parent_same(parent, "K3 cubic shape", k3_cubic, 5)

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
    parent_same(parent, "K1eT at the edge-case points", k1et, 5)


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
    from ionotomo_tpu_torch.configs import bent_dtec_data, make_rays
    from ionotomo_tpu_torch.testing import SOLVE_KERNELS

    def bent_dtec(m, grid, ants, dirs, noise_frac):
        # the bench traces the cubic model; this configuration keeps the
        # zp tracer (K1) it was first measured with
        return bent_dtec_data(m, grid, ants, dirs, FREQ_HZ, 256, noise_frac,
                              max_length_km=LENGTH_KM, interp="zp")

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
    d_obs, noise = bent_dtec(m_true, grid, ants, dirs, 0.01)
    ants_h, dirs_h = make_rays(20, 50, seed=99)
    d_h, _ = bent_dtec(m_true, grid, ants_h, dirs_h, 0.0)
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
    order = k2_order_check("phase 6, the solve's points", kernels,
                           tricubic, boxspline, table, grid.shape,
                           (op.ri, op.wxy, op.zi, op.wz), True, parent)
    check(bool(torch.equal(order.order, op.point_order().order)),
          "the geometry keeps the point order K2's wrapper makes")
    keys_line, perm_line = point_order_line(
        f"config 3b's {n_pts} zp points", kernels, boxspline,
        (op.ri, op.wxy, op.zi, op.wz), grid.shape, parent)
    results["point_order_keys_zp"] = {"line": keys_line}
    results["permute_points_zp"] = {"line": perm_line}
    at_solve_shape = {
        "rows_value_fwd": (
            lambda: tricubic.rows_value(table, op.ri, op.wxy, op.zi, op.wz,
                                        True, order=order),
            lambda: tricubic.rows_value_ref(table, op.ri, op.wxy, op.zi,
                                            op.wz, True),
            None,
            k2_bound(op.ri, op.wxy, op.zi, op.wz, n_rows, nz,
                     boxspline.ZP_LIVE_TRANSLATES, FLOPS_K2_POINT)),
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
    # K1e, E of every J, at the solve's endpoints
    results["zp_value_grad"] = {"line": k1e_at(
        f"the solve's {n_ends} endpoints", kernels, boxspline, table, grid,
        op.ends, parent)}
    for name in ("rows_value_fwd", "rows_value_bwd", "zp_value_grad_bwd"):
        parent_same(parent, f"{name} at the solve's shape",
                    at_solve_shape[name][0], 20)
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
    for name in SOLVE_KERNELS + ("point_order_keys", "permute_points"):
        check(launches[name] > 0,
              f"{name} launched in the solve ({launches[name]} times)")
    res2, secs2 = solve()
    resp, secs_p = solve(tec.dtec_paired_linear_ref)
    res3, secs3 = solve()
    check(bool(torch.isfinite(res1.m).all()), "solved field finite")
    check(bool(torch.equal(res1.m, res2.m) and torch.equal(res1.m, res3.m)),
          "the solve is bitwise equal across three runs")
    if parent is not None:
        res_p, secs_pp = parent.run(solve)
        check(bool(torch.equal(res_p.m, res1.m)
                   and float(res_p.residual_norm)
                   == float(res1.residual_norm)),
              f"the config-3b solve: field and final residual "
              f"{float(res_p.residual_norm)!r} bitwise the solve on the "
              f"parent's kernels ({secs_pp:.4f} s)")
        del res_p
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


def phase7_probe(dev, gather, kernels, results, parent=None):
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
    check(rec["rowgather_baseline_Mpt_evals_per_sec"] > 0
          and kernels.launches["cubic_value_grad"] > 0,
          f"the probe's row-gather baseline ran on K5 "
          f"({rec['rowgather_baseline_Mpt_evals_per_sec']:.1f} M point "
          f"evaluations/s)")
    flush, flush_names = l2_flush(dev)
    for rows, width in ((8, 128), (16384, 128)):
        table, idx = gather.probe_inputs(rows, width, dev)

        def kg():
            return gather.vector_gather(table, idx)

        def plain():
            return gather.vector_gather_ref(table, idx)

        ms, plain_ms = device_ms(kg, 50), device_ms(plain, 50)
        cold_ms = device_ms(lambda: (flush(), kg()), 20, exclude=flush_names)
        cold_plain = device_ms(lambda: (flush(), plain()), 20,
                               exclude=flush_names)
        (b_ms, b_by), distinct = kg_bound(table, idx)
        print(f"  KG at ({rows}, {width}): kernel {ms:.4f} ms, torch.gather "
              f"{plain_ms:.4f} ms; with the L2 cleared {cold_ms:.4f} ms, "
              f"torch.gather {cold_plain:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {distinct} distinct table values of "
              f"{rows * width})")
        line = dict(max_abs_err=rec["max_abs_err"], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=plain_ms,
                    l2_cleared_ms=cold_ms, l2_cleared_library_ms=cold_plain)
        if parent is not None:
            line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
                f"KG at ({rows}, {width})", lambda: parent.run(kg), kg, 50,
                pairs=3)
        if rows == 8:
            results["vector_gather_control"] = line
    results["vector_gather"] = {"launches": n, "line": line}


def check_and_time(label, kern, plain, library, bnd, scatter, reps=20,
                   plain_reps=3, timed=None):
    """One kernel at one shape against its plain version: within
    1e-4·max|out|, finite, and for a scatter bitwise equal across two
    calls; device ms of the kernel (of ``timed`` where given: a kernel
    that adds into a table is checked on fresh copies and timed into one
    running table), the plain version and the one-call library form
    (None: there is none). Returns the kernel's ``line``."""
    if scatter:
        got, same = _same_twice(kern)
        check(same, f"{label} bitwise equal across two calls")
    else:
        got = kern()
    want = plain()
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    del want
    check(bool(torch.isfinite(got).all()), f"{label} output finite")
    check(err <= 1e-4 * scale, f"{label} max|err| {err:.3e} <= 1e-4*max|out| "
                               f"{1e-4 * scale:.3e}")
    del got
    ms = device_ms(timed or kern, reps)
    plain_ms = device_ms(plain, plain_reps)
    lib_ms = device_ms(library, reps) if library is not None else None
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    b_ms, b_by = bnd
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one "
          f"PyTorch call {lib}, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def stencil_scatter_terms(tricubic, rays, grid, rb, y):
    """``tec_linear_adjoint``'s cubic branch as the reference writes it:
    the per-sample cotangent y_r·w_n·ds_r·1e3/TEC_SCALE (R·N,), and the
    flat voxel indices and contributions through the 64 stencil weights
    of every sample, (R·N·64,) each."""
    from ionotomo_tpu_torch import constants

    idx, w64 = tricubic.interp_weights(grid, rb.points.reshape(-1, 3))
    wq = rays.simpson_weights(rb.num_samples, torch.float32, y.device)
    coef = (y[:, None] * wq[None, :] * rb.ds[:, None]
            * (constants.KM_TO_M / constants.TEC_SCALE)).reshape(-1)
    return coef, idx.reshape(-1).long(), (w64 * coef[:, None]).reshape(-1)


def check_k4(label, tricubic, rays, tec, grid, rb, y):
    """K4: ``tec_linear_adjoint`` on cubic is K3 over the cubic row plan.
    The entry point against ``index_add_`` of the 64-weight contributions
    (the two round the weight products in another order: 1e-4·max, not
    bitwise), and bitwise equal to K3 called on the same plan; the times
    are K3's alone, the plan built once as a solve builds it."""
    nx, ny, nz = grid.shape
    ri, wxy, zi, wz = tricubic.row_setup(grid, rb.points.reshape(-1, 3))
    plan = tricubic.row_plan(ri, zi, nx * ny)
    print_plan(f"{label} (K3 on the cubic plan)", plan)
    coef, flat, contrib = stencil_scatter_terms(tricubic, rays, grid, rb, y)

    def k3():
        return tricubic.rows_value_transpose(coef, ri, wxy, zi, wz,
                                             (nx * ny, nz), plan)

    def plain():
        _, f, c = stencil_scatter_terms(tricubic, rays, grid, rb, y)
        return torch.zeros(grid.num_voxels, device=y.device).index_add_(
            0, f, c).reshape(nx * ny, nz)

    check(bool(torch.equal(tec.tec_linear_adjoint(y, grid, rb, "cubic"),
                           k3().reshape(grid.shape))),
          f"{label}: tec_linear_adjoint is K3 on the cubic plan, bitwise")
    return check_and_time(label, k3, plain,
                          index_add_call(flat, contrib, grid.num_voxels),
                          k3_bound(coef, ri, wxy, zi, wz, plan, nz),
                          scatter=True, reps=5, plain_reps=2)


def phase8_cubic_kernels(dev, tricubic, fermat, rays, tec, kernels, Grid3D,
                         chapman, results, parent=None):
    from ionotomo_tpu_torch.testing import edge_case_points

    print("phase 8: the tricubic kernels against their plain versions")
    rng = np.random.default_rng(8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)   # dyadic: exact
    for n_grid, where in ((128, "edge-case"), (256, "random")):
        shape = (n_grid,) * 3
        n_rows = n_grid * n_grid
        grid = Grid3D.create(origin, spacing, shape, device=dev)
        table = t(rng.normal(size=(n_rows, n_grid)).astype(np.float32))
        tmax = float(table.abs().max())
        if where == "edge-case":
            pts = t(edge_case_points(shape, origin, spacing, 1 << 20, rng))
        else:
            hi = np.asarray(spacing) * (n_grid - 1)
            pts = t((np.asarray(origin) + rng.uniform(0, 1, (1 << 20, 3))
                     * hi).astype(np.float32))
        n = pts.shape[0]
        tag = f"at {n} {where} points of a {n_grid}^3 table"

        # K5: value + physical gradient
        v_k, g_k = kernels.cubic_value_grad(table, grid, pts)
        v_p, g_p = tricubic.interp_rows_with_grad_ref(table, grid, pts)
        torch.cuda.synchronize()
        err_v = float((v_k - v_p).abs().max())
        err_g = float((g_k - g_p).abs().max())
        del v_p, g_p
        check(bool(torch.isfinite(v_k).all() and torch.isfinite(g_k).all()),
              f"K5 {tag}: output finite")
        check(err_v <= 1e-5 * tmax, f"K5 {tag}: value max|err| {err_v:.3e} "
                                    f"<= 1e-5*max|table| {1e-5 * tmax:.3e}")
        gtol = 1e-5 * tmax / min(spacing)
        check(err_g <= gtol, f"K5 {tag}: gradient max|err| {err_g:.3e} <= "
                             f"{gtol:.3e}")
        ms = device_ms(lambda: kernels.cubic_value_grad(table, grid, pts), 20)
        plain_ms = device_ms(
            lambda: tricubic.interp_rows_with_grad_ref(table, grid, pts), 2)
        b_ms, b_by = k5_bound(tricubic, grid, pts)
        print(f"  K5 {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        del v_k, g_k

        parent_same(parent, f"K5 {tag}",
                    lambda: kernels.cubic_value_grad(table, grid, pts), 20)

        # K5ᵀ: its transpose with respect to the table, added into one
        cv = t(rng.normal(size=(n,)).astype(np.float32))
        cg = t(rng.normal(size=(n, 3)).astype(np.float32))
        plan = tricubic.endpoint_plan(grid, pts)
        print_plan(f"K5T {tag}", plan)
        check_k5t(f"K5T {tag}", tricubic, kernels, grid, pts, cv, cg, plan,
                  table, parent, reps=5)
        del table, pts, cv, cg, plan
        torch.cuda.empty_cache()

    # K1c: the leapfrog tracer over cubic on 8192 rays of the phase-3 world
    grid3 = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid3)).contiguous()
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(8192, seed=1))
    for keep_path in (False, True):
        kw = dict(n_steps=N_STEPS, keep_path=keep_path, method="leapfrog",
                  interp="cubic")
        b_k, t_k = fermat.trace_rays(m, grid3, o, d, FREQ_HZ, LENGTH_KM, **kw)
        b_p, t_p = fermat.trace_rays_ref(m, grid3, o, d, FREQ_HZ, LENGTH_KM,
                                         **kw)
        torch.cuda.synchronize()
        check(b_k.points.shape == b_p.points.shape,
              f"K1c keep_path={keep_path} shape {tuple(b_k.points.shape)}")
        err_x = float((b_k.points - b_p.points).abs().max())
        err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
        check(err_x <= 1e-3, f"K1c keep_path={keep_path} path max|dx| "
                             f"{err_x:.3e} km <= 1e-3 km")
        check(err_t <= 1e-5, f"K1c keep_path={keep_path} tau max rel err "
                             f"{err_t:.3e} <= 1e-5")
        check(bool(torch.equal(b_k.ds, b_p.ds)), "K1c ds equal")
    results["trace_leapfrog_cubic"] = {"tau_rel": err_t,
                                       "line": dict(max_abs_err=err_x)}

    # K4 through K3: 8192 straight rays x 65 samples on the same grid
    rb = rays.sample_straight_rays(o, d, LENGTH_KM, 65)
    y = t(rng.normal(size=(rb.num_rays,)).astype(np.float32))
    check_k4(f"K4 at {rb.num_rays * 65} points of a 128^3 grid", tricubic,
             rays, tec, grid3, rb, y)


def phase9_config2(dev, fermat, rays, kernels, Grid3D, chapman, configs,
                   results, card, n_rays=262144, parent=None):
    print("phase 9: config 2 on the tricubic model (configs.config2)")
    kernels.reset_launches()
    rec = configs.config2(n_saturated=n_rays, device=dev)
    launches = dict(kernels.launches)
    print(f"  config2: {json.dumps(rec)}")
    print(f"  launches in config 2: {launches}")
    for name in CONFIG2_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in config 2 ({launches[name]} times)")
    check(launches["trace_leapfrog_zp"] == 0, "config 2 launched no zp tracer")
    check(rec["finite_6200"] and rec["finite_saturated"],
          "config 2: finite endpoints and TEC")
    print(f"  cubic, leapfrog@128: {rec['bent_rays_per_sec_6200']:.1f} rays/s "
          f"at {rec['rays_6200']} rays, "
          f"{rec['bent_rays_per_sec_saturated']:.1f} rays/s at "
          f"{rec['rays_saturated']} rays on {card}")

    # the phase-3 configuration on cubic: 262144 rays, leapfrog@64
    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(n_rays))

    def run():
        return fermat.trace_rays(m, grid, o, d, FREQ_HZ, LENGTH_KM,
                                 n_steps=N_STEPS, keep_path=False,
                                 method="leapfrog", interp="cubic")
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    rate64 = n_rays / dt
    print(f"  cubic, leapfrog@64: {rate64:.1f} rays/s ({dt * 1e3:.3f} ms per "
          f"call; zp in phase 3: {results['rays_per_s']['kernel']:.1f} "
          f"rays/s, prefilter included)")

    # K1c held against the plain tracer at the main path's own inputs:
    # config 2's two ray arrays at its 128 steps, through the entry points.
    # The saturated batch's two runs are also the ones that are timed.
    kw128 = dict(n_steps=128, keep_path=False, method="leapfrog",
                 interp="cubic")
    table = m.reshape(N_GRID * N_GRID, N_GRID)
    k128 = fermat._step_constants(FREQ_HZ, LENGTH_KM, 128)
    errs = {}
    for n_a, n_d in ((62, 100), (512, n_rays // 512)):
        ants, dirs = configs.make_rays(n_a, n_d)
        o2, d2 = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                                     torch.from_numpy(dirs).to(dev))
        out = {}

        def plain():
            out["p"] = fermat.trace_rays_ref(m, grid, o2, d2, FREQ_HZ,
                                             LENGTH_KM, **kw128)
        b_k, t_k = fermat.trace_rays(m, grid, o2, d2, FREQ_HZ, LENGTH_KM,
                                     **kw128)
        plain_ms = cuda_ms(plain, 1)
        b_p, t_p = out["p"]
        n2 = o2.shape[0]
        tag = f"K1c at {n2} rays x 128 steps"
        check(b_k.points.shape == b_p.points.shape == (n2, 2, 3),
              f"{tag}: endpoints {tuple(b_k.points.shape)}")
        check(bool(torch.isfinite(b_k.points).all()
                   and torch.isfinite(t_k).all()), f"{tag}: finite")
        err_x = float((b_k.points - b_p.points).abs().max())
        err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
        check(err_x <= 1e-3, f"{tag}: endpoint max|dx| {err_x:.3e} km <= "
                             f"1e-3 km against the plain tracer")
        check(err_t <= 1e-5, f"{tag}: tau max rel err {err_t:.3e} <= 1e-5")
        check(bool(torch.equal(b_k.ds, b_p.ds)), f"{tag}: ds equal")
        errs[n2] = (err_x, err_t)
        del out, b_k, b_p, t_k, t_p
        parent_same(
            parent, f"K1c at config 2's {n2} rays x 128 steps: per-ray "
                    f"x_end and tau",
            lambda: kernels.trace_leapfrog_cubic(table, grid, o2, d2, 128,
                                                 False, **k128)[:2],
            3, pairs=3)
    # the last case is the saturated batch: its times, its error and its
    # bound (operations per step counted from the kernel) go to the line.
    # The wrapper's time is the ray sort, the pack and the tracer.
    k64 = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)

    def k1c128():
        return kernels.trace_leapfrog_cubic(table, grid, o2, d2, 128, False,
                                            **k128)
    ms64 = device_ms(lambda: kernels.trace_leapfrog_cubic(
        table, grid, o, d, N_STEPS, False, **k64), 3)
    ms128 = device_ms(k1c128, 3)
    ev128 = cuda_ms(k1c128, 10)
    by_name = kernel_ms_by_name(k1c128, 3)

    def unpacked128():     # one launch of the former arithmetic and order
        return kernels.trace_leapfrog_cubic_with(
            table, grid, o2, d2, 128, False, packed=None, order=None,
            threads=128, **k128)
    u_ms, u_ev = device_ms(unpacked128, 3), cuda_ms(unpacked128, 10)
    print(f"  one launch of the unpacked K1c in ray order (128 threads) read "
          f"two ways: device_ms {u_ms:.4f} ms, cuda_ms {u_ev:.4f} ms "
          f"({100 * (u_ev - u_ms) / u_ev:.2f} % apart)")
    n_bytes = nbytes(table, o2, d2) + 16 * n_rays
    b_ms, b_by = bound(n_bytes, n_rays * 128 * FLOPS_K1C_STEP)
    b64 = bound(n_bytes, n_rays * N_STEPS * FLOPS_K1C_STEP)[0]
    print(f"  K1c alone at {n_rays} rays: {ms64:.4f} ms at 64 steps "
          f"(bound {b64:.4f}), {ms128:.4f} ms at 128 steps, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(f"  K1c at 128 steps read two ways: device_ms {ms128:.4f} ms (the "
          f"kernels' own durations), cuda_ms {ev128:.4f} ms (CUDA events "
          f"around 10 calls); by kernel: "
          + "; ".join(f"{v:.4f} ms {k[:40]}" for k, v in
                      sorted(by_name.items(), key=lambda kv: -kv[1])))
    results["trace_leapfrog_cubic"]["line"].update(
        max_abs_err=errs[n_rays][0], ms=ms128, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # the two kernels K1c's call launches before the tracer, at the
    # saturated batch, against their plain versions
    from ionotomo_tpu_torch.core import tricubic
    for name, kern, plain, n_bytes, n_ops in (
            ("pack_z_taps", lambda: kernels.pack_z_taps(table, grid),
             lambda: tricubic.pack_z_taps_ref(table),
             nbytes(table) + 16 * (N_GRID - 1) * N_GRID * N_GRID, 0),
            ("ray_order_keys", lambda: kernels.ray_order_keys(o2, d2, grid),
             lambda: kernels.ray_order_keys_ref(o2, d2, grid),
             nbytes(o2, d2) + 4 * n_rays, n_rays * OPS_RAY_KEY)):
        got, want = kern(), plain()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{name} at {n_rays} rays: bitwise "
                                      f"its plain version")
        k_ms, p_ms = device_ms(kern, 20), device_ms(plain, 5)
        nb_ms, nb_by = bound(n_bytes, n_ops)
        print(f"  {name} at {n_rays} rays: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {nb_ms:.4f} ms ({nb_by})")
        results[name] = {"line": dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=nb_ms,
            bound_by=nb_by, library_ms=None), "launches": launches[name]}
        del got, want
    results["trace_leapfrog_cubic"]["tau_rel"] = errs[n_rays][1]
    results["trace_leapfrog_cubic"]["launches"] = \
        launches["trace_leapfrog_cubic"]
    results["trace_leapfrog_cubic"]["cuda_ms"] = ev128
    results["trace_leapfrog_cubic"]["unpacked_ms"] = (u_ms, u_ev)
    results["config2"] = {**rec, "rays_per_s_leapfrog64": rate64,
                          "k1c_ms_64": ms64}


def profile_solve(solve, label="config-4 solve"):
    """Device time by kernel over one call of ``solve`` (a whole config-4
    solve, one filter step), and its share of the same call's wall time
    without the profiler. ``solve()`` returns (result, seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_us = solve()[1] * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  profiled {label}: kernels {busy:.1f} us in "
          f"{sum(r[2] for r in rows)} launches; the same without the "
          f"profiler {wall_us:.1f} us, device busy {100 * busy / wall_us:.1f} "
          f"%")
    for key, us, count in rows[:24]:
        print(f"    {us:10.1f} us {count:5d}x  {key[:100]}")


def jt_kernels(op, y, parent):
    """The kernels one Jᵀ on cubic launches (one profiler trace) and, with
    a parent, the same Jᵀ on the parent's kernels, bitwise equal."""
    new = kernel_launches(lambda: op.apply_t(y))
    print(f"  one J^T on cubic: {sum(new.values())} kernel launches: "
          + "; ".join(f"{n} x {k[:50]}" for k, n in sorted(new.items())))
    if parent is not None:
        check(bool(torch.equal(parent.run(lambda: op.apply_t(y)),
                               op.apply_t(y))),
              "J^T bitwise the parent's")


def kernel_launches(fn) -> dict:
    """Kernel launches of one call of ``fn`` by name (one profiler
    trace, after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0}


def config4_zpc2(dev, w, configs, tricubic, zpcubic, tec, kernels,
                 plain_full, results, profile=False):
    """Config 4 with the zpc2 inner Jacobian (``interp="cubic",
    interp_inner="zpc2"``, the reference's mixed-fidelity 256³ route):
    K2 at zpc's (8, 4) shape over each bundle's point order, bitwise the
    generic kernel and within 1e-4·max of its plain version, K6z and K6zᵀ
    (adding into a K3 table) at the solve's endpoints, the kernels one Jᵀ
    on zpc launches; then the solve through the entry point twice,
    bitwise equal (the card's version of the reference's zpc determinism
    gate, bench/probe_zp256.py), its kernels launched, within 1 % of the
    plain-version solve in residual and held-out dTEC rms, and below the
    prior on held-out rays. Returns the K2 lines by shape."""
    grid, nd = w.grid, w.n_dirs
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    print("phase 10 (zpc2 inner Jacobian): config 4 with "
          "interp_inner='zpc2'")
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32)
                         ).to(dev)
    table = zpcubic.prefilter(x).reshape(n_rows, nz).contiguous()
    at = {}
    op = None
    for rb in (w.rays, w.rays_inner):
        o_ = tec.dtec_paired_linear(w.m_prior, grid, rb, nd, 0, "hermite",
                                    "zpc2")
        if op is None:
            op = o_
        n_pts = o_.ri.shape[0]
        setup = (o_.ri, o_.wxy, o_.zi, o_.wz)
        order = k2_order_check(f"phase 10 zpc2, {n_pts} points", kernels,
                               tricubic, zpcubic, table, grid.shape, setup,
                               True)
        check(bool(torch.equal(order.order, o_.point_order().order)),
              "the zpc geometry keeps the point order K2's wrapper makes")

        def k2():
            return tricubic.rows_value(table, *setup, True, order=order)

        at[f"rows_value_fwd@zpc{n_pts}"] = line = check_and_time(
            f"K2 at {n_pts} points (K=8, L=4)", k2,
            lambda: tricubic.rows_value_ref(table, *setup, True), None,
            k2_bound(*setup, n_rows, nz, 7, FLOPS_K2_ZPC_POINT),
            scatter=False, plain_reps=2)
        line["ray_order_ms"] = device_ms(
            lambda: tricubic.rows_value(table, *setup, True), 20)
        print(f"  K2 at {n_pts} zpc points in ray order: "
              f"{line['ray_order_ms']:.4f} ms")
        del o_, order, setup
    ends, eplan = op.ends, op.end_plan
    n_ends = ends.shape[0]
    print_plan(f"K6zT at the solve's {n_ends} endpoints", eplan)
    results["zpc_value_grad"] = {"line": k6_at(
        f"the solve's {n_ends} endpoints", kernels, zpcubic,
        "zpc_value_grad", table, grid, ends, reps=50, plain_reps=5)}
    cv = torch.from_numpy(rng.normal(size=(n_ends,)).astype(np.float32)
                          ).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n_ends, 3)).astype(np.float32)
                          ).to(dev)
    k3_table = op._rows_t(torch.from_numpy(
        rng.normal(size=(op.ri.shape[0],)).astype(np.float32)).to(dev))
    results["zpc_value_grad_bwd"] = {"line": check_adding(
        f"K6zT at the solve's {n_ends} endpoints",
        lambda t: kernels.zpc_value_grad_bwd(t, grid, ends, cv, cg, eplan),
        lambda: zpcubic.interp_rows_with_grad_transpose_ref(grid, ends, cv,
                                                            cg),
        zpcubic.value_grad_transpose_terms(grid, ends, cv, cg),
        k6zt_bound(zpcubic, grid, ends, cv, cg, eplan), k3_table, eplan,
        reps=50, plain_reps=5)}
    y = torch.from_numpy(rng.normal(size=(w.rays.num_rays,))
                         .astype(np.float32)).to(dev)
    jt = kernel_launches(lambda: op.apply_t(y))
    print(f"  one J^T on zpc2: {sum(jt.values())} kernel launches: "
          + "; ".join(f"{n} x {k[:50]}" for k, n in sorted(jt.items())))
    del op, k3_table, table, x
    torch.cuda.empty_cache()

    def solve(world, **kw):
        t0 = time.perf_counter()
        res = configs.config4_solve(world, interp_inner="zpc2", **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def heldout(m):
        return configs.heldout_dtec_rms(m, grid, *w.heldout)

    kernels.reset_launches()
    za, secs_a = solve(w)
    launches = dict(kernels.launches)
    print(f"  launches in one zpc2-inner solve: {launches}")
    for name in ("rows_value_fwd", "rows_value_bwd", "zpc_value_grad",
                 "zpc_value_grad_bwd", "cubic_value_grad", "point_order_keys",
                 "permute_points"):
        check(launches[name] > 0,
              f"{name} launched in the zpc2-inner solve ({launches[name]} "
              f"times)")
    check(launches["zp_value_grad"] == 0 and launches["zp_value_grad_bwd"]
          == 0, "the zpc2-inner solve launched no zp kernel")
    zb, secs_b = solve(w)
    check(bool(torch.isfinite(za.m).all()), "zpc2-inner solve: field finite")
    check(bool(torch.equal(za.m, zb.m)),
          "the config-4 zpc2-inner solve is bitwise equal across two runs")
    del zb
    h_a, h_0 = heldout(za.m), heldout(w.m_prior)
    if plain_full:
        wp, plain_kw, what, res_k = w, {}, "the same schedule", za
    else:
        wp = w._replace(rays=w.rays_inner, rays_inner=None)
        plain_kw = dict(progressive=False, gn_iters=1)
        what = "one Gauss-Newton step on the @33 bundle"
        res_k, _ = solve(wp, **plain_kw)
    resp, secs_p = solve(wp, linearize=tec.dtec_paired_linear_ref,
                         **plain_kw)
    r_k, r_p = float(res_k.residual_norm), float(resp.residual_norm)
    h_k, h_p = heldout(res_k.m), heldout(resp.m)
    print(f"  the plain-version zpc2-inner solve ran {what}: {secs_p:.4f} s, "
          f"residual {r_p!r}, held-out {h_p!r}")
    check(abs(r_k - r_p) <= 1e-2 * r_p,
          f"zpc2 inner: final whitened residual {r_k:.4f} within 1% of the "
          f"plain solve's {r_p:.4f}")
    check(abs(h_k - h_p) <= 1e-2 * h_p,
          f"zpc2 inner: held-out dTEC rms {h_k:.4f} within 1% of the plain "
          f"solve's {h_p:.4f}")
    check(h_a < h_0, f"zpc2 inner: held-out dTEC rms {h_a:.4f} below the "
                     f"prior's {h_0:.4f}")
    print(f"  zpc2-inner solve: {secs_a:.4f}, {secs_b:.4f} s; residual "
          f"{float(za.residual_norm)!r}, held-out dTEC rms {h_a!r} (prior "
          f"{h_0!r})")
    results["config4_zpc2"] = {
        "seconds": [secs_a, secs_b], "plain_seconds": secs_p,
        "residual": float(za.residual_norm), "plain_residual": r_p,
        "heldout": h_a, "plain_heldout": h_p, "prior_heldout": h_0,
        "plain_what": what}
    results["config4_zpc2_launches"] = launches
    if profile:
        profile_solve(lambda: solve(w), "config-4 solve, zpc2 inner")
    del za, resp, res_k
    torch.cuda.empty_cache()
    return at


def phase10_config4(dev, tricubic, rays, tec, kernels, configs, results,
                    profile=False, parent=None, **world_kw):
    from ionotomo_tpu_torch.testing import CUBIC_SOLVE_KERNELS

    t0 = time.perf_counter()
    w = configs.config4_world(device=dev, **world_kw)
    torch.cuda.synchronize()
    grid, nd = w.grid, w.n_dirs
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    print(f"phase 10: config 4 on the tricubic model (configs.config4): grid "
          f"{grid.shape} spacing {[round(float(x), 3) for x in grid.spacing]}"
          f" km, {w.rays.num_rays} rays x {w.rays.num_samples} (inner "
          f"{w.rays_inner.num_samples}) samples, noise {w.noise:.4f}, set-up "
          f"{time.perf_counter() - t0:.2f} s")
    check(bool(torch.isfinite(w.d_obs).all() and torch.isfinite(w.m_true)
               .all()), "world: finite data and truth")

    # the plain versions gather whole table rows: (points, 16, nz) f32
    block = w.rays.num_rays * w.rays.num_samples * 16 * nz * 4
    free = torch.cuda.mem_get_info(dev)[0]
    plain_full = free > 2.5 * block
    print(f"  plain versions' gathered block {block / 1e9:.2f} GB, free "
          f"memory {free / 1e9:.2f} GB: the plain operator and solve run "
          + ("at full size" if plain_full else
             "on the @33 bundle, one Gauss-Newton step"))
    rb_check = w.rays if plain_full else w.rays_inner

    # the operator on the kernels against the plain-version operator
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32)
                         ).to(dev)
    y = torch.from_numpy(rng.normal(size=(w.rays.num_rays,))
                         .astype(np.float32)).to(dev)
    op = tec.dtec_paired_linear(w.m_prior, grid, rb_check, nd, 0, "hermite",
                                "cubic")
    ref = tec.dtec_paired_linear_ref(w.m_prior, grid, rb_check, nd, 0,
                                     "hermite", "cubic")
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
    del rx, rty, jx, jty
    timings = {
        "J": cuda_ms(lambda: op.apply(x), 10),
        "J^T": cuda_ms(lambda: op.apply_t(y), 10),
        "J plain": cuda_ms(lambda: ref.apply(x), 2),
        "J^T plain": cuda_ms(lambda: ref.apply_t(y), 2),
        "apply_sqrt": cuda_ms(lambda: w.cov.apply_sqrt(x), 20),
    }
    for name, ms in timings.items():
        print(f"  {name} ({rb_check.num_samples} samples): {ms:.4f} ms")
    del ref

    # K2 and K3 alone at the solve's two shapes, K5 and K5ᵀ at its
    # endpoints, each against its plain version
    table = x.reshape(n_rows, nz)
    ops = {rb_check.num_samples: op}
    for rb in (w.rays, w.rays_inner):
        if rb.num_samples not in ops:
            ops[rb.num_samples] = tec.dtec_paired_linear(
                w.m_prior, grid, rb, nd, 0, "hermite", "cubic")
    at_config4 = {}
    for n_s, o_ in sorted(ops.items(), reverse=True):
        n_pts = o_.ri.shape[0]
        ct = torch.from_numpy(rng.normal(size=(n_pts,)).astype(np.float32)
                              ).to(dev)
        print_plan(f"K3 at {n_pts} points", o_.row_plan)
        setup = (o_.ri, o_.wxy, o_.zi, o_.wz)
        order = k2_order_check(f"phase 10, {n_pts} points", kernels,
                               tricubic, tricubic, table, grid.shape, setup,
                               False, parent)
        check(bool(torch.equal(order.order, o_.point_order().order)),
              "the geometry keeps the point order K2's wrapper makes")

        def k2():
            return tricubic.rows_value(table, *setup, False, order=order)

        at_config4[f"rows_value_fwd@{n_pts}"] = line = check_and_time(
            f"K2 at {n_pts} points (K=16, L=4)", k2,
            lambda: tricubic.rows_value_ref(table, *setup, False),
            None, k2_bound(*setup, n_rows, nz, 16, FLOPS_K2_CUBIC_POINT),
            scatter=False, plain_reps=2)
        line["ray_order_ms"] = device_ms(
            lambda: tricubic.rows_value(table, *setup, False), 20)
        print(f"  K2 at {n_pts} points in ray order: "
              f"{line['ray_order_ms']:.4f} ms")
        if n_pts == w.rays.num_rays * w.rays.num_samples:
            keys_line, perm_line = point_order_line(
                f"config 4's {n_pts} points", kernels, tricubic, setup,
                grid.shape, parent)
            results["point_order_keys"] = {"line": keys_line}
            results["permute_points"] = {"line": perm_line}
        if parent is not None:
            line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
                f"K2 at {n_pts} points", lambda: parent.run(k2), k2, 20,
                pairs=3)
        parent_same(parent, f"K3 at {n_pts} points", lambda:
                    tricubic.rows_value_transpose(
                        ct, o_.ri, o_.wxy, o_.zi, o_.wz, o_.table_shape,
                        o_.row_plan), 20)
        at_config4[f"rows_value_bwd@{n_pts}"] = check_and_time(
            f"K3 at {n_pts} points (K=16, L=4)",
            lambda: tricubic.rows_value_transpose(
                ct, o_.ri, o_.wxy, o_.zi, o_.wz, o_.table_shape, o_.row_plan),
            lambda: tricubic.rows_value_transpose_ref(
                ct, o_.ri, o_.wxy, o_.zi, o_.wz, o_.table_shape),
            index_add_call(*tricubic.transpose_terms(
                ct, o_.ri, o_.wxy, o_.zi, o_.wz, o_.table_shape),
                n_rows * nz),
            k3_bound(ct, o_.ri, o_.wxy, o_.zi, o_.wz, o_.row_plan, nz),
            scatter=True, plain_reps=2)
        del ct
    ends, eplan = op.ends, op.end_plan
    n_ends = ends.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n_ends,)).astype(np.float32)
                          ).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n_ends, 3)).astype(np.float32)
                          ).to(dev)
    print_plan(f"K5T at the solve's {n_ends} endpoints", eplan)
    v_k, g_k = kernels.cubic_value_grad(table, grid, ends)
    v_p, g_p = tricubic.interp_rows_with_grad_ref(table, grid, ends)
    err_v = float((v_k - v_p).abs().max())
    check(err_v <= 1e-5 * float(table.abs().max()),
          f"K5 at the solve's endpoints: value max|err| {err_v:.3e} <= "
          f"1e-5*max|table|")
    check(float((g_k - g_p).abs().max())
          <= 1e-5 * float(table.abs().max()) / float(grid.spacing.min()),
          "K5 at the solve's endpoints: gradient within 1e-5*max|table|/h")
    k5_ms = device_ms(lambda: kernels.cubic_value_grad(table, grid, ends), 50)
    k5_plain = device_ms(
        lambda: tricubic.interp_rows_with_grad_ref(table, grid, ends), 5)
    b_ms, b_by = k5_bound(tricubic, grid, ends)
    print(f"  K5 at the solve's {n_ends} endpoints: kernel {k5_ms:.4f} ms, "
          f"plain {k5_plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["cubic_value_grad"] = {"line": dict(
        max_abs_err=err_v, ms=k5_ms, plain_ms=k5_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, points=n_ends)}
    if parent is not None:
        def k5():
            return kernels.cubic_value_grad(table, grid, ends)

        results["cubic_value_grad"]["line"].update(zip(
            ("parent_ms", "new_ms_in_turns"), compare_parent(
                f"K5 at the solve's {n_ends} endpoints",
                lambda: parent.run(k5), k5, 50, pairs=3)))
    # K5ᵀ adds into K3's output in Jᵀ: a K3 table of the solve's samples
    k3_table = ops[w.rays.num_samples]._rows_t(torch.from_numpy(
        rng.normal(size=(ops[w.rays.num_samples].ri.shape[0],))
        .astype(np.float32)).to(dev))
    results["cubic_value_grad_bwd"] = {"line": check_k5t(
        f"K5T at the solve's {n_ends} endpoints", tricubic, kernels, grid,
        ends, cv, cg, eplan, k3_table, parent, reps=50, plain_reps=5)}
    del k3_table
    jt_kernels(op, y, parent)
    check(not bool(op.row_plan.counters.any() or eplan.counters.any()),
          "the solve's plan counters back at zero")
    del op, ops, o_, v_k, g_k, v_p, g_p, table

    # K4 (ray_coverage's scatter) at the solve's 650,000 points
    at_config4["tec_linear_adjoint"] = check_k4(
        f"K4 at {w.rays.num_rays * w.rays.num_samples} points of the solve's "
        f"grid", tricubic, rays, tec, grid, w.rays, y)
    torch.cuda.empty_cache()

    # the solve through the entry point: configs.config4 runs it twice (an
    # untimed one first), the counters read around it
    kernels.reset_launches()
    rec = configs.config4(world=w)
    launches = dict(kernels.launches)
    print(f"  config4: {json.dumps(rec)}")
    print(f"  launches in config 4 (two solves and the metrics): {launches}")
    for name in CUBIC_SOLVE_KERNELS + ("point_order_keys", "permute_points"):
        check(launches[name] > 0,
              f"{name} launched in config 4 ({launches[name]} times)")
    check(launches["zp_value_grad"] == 0 and launches["zp_value_grad_bwd"]
          == 0, "config 4 on cubic launched no zp kernel")

    def solve(**kw):
        t0 = time.perf_counter()
        res = configs.config4_solve(w, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def heldout(m):
        return configs.heldout_dtec_rms(m, grid, *w.heldout)

    res1, secs1 = solve()
    res2, secs2 = solve()
    check(bool(torch.isfinite(res1.m).all()), "solved field finite")
    check(bool(torch.equal(res1.m, res2.m)),
          "the config-4 solve is bitwise equal across two runs")
    print(f"  final whitened residual {float(res1.residual_norm)!r}, held-out "
          f"dTEC rms {heldout(res1.m)!r} (full precision)")
    if parent is not None:
        res_p, secs_pp = parent.run(solve)
        check(bool(torch.equal(res_p.m, res1.m)
                   and float(res_p.residual_norm)
                   == float(res1.residual_norm)
                   and heldout(res_p.m) == heldout(res1.m)),
              f"config 4: field, final residual "
              f"{float(res_p.residual_norm)!r} and held-out rms "
              f"{heldout(res_p.m)!r} bitwise the solve on the parent's "
              f"kernels ({secs_pp:.4f} s)")
        del res_p
    from ionotomo_tpu_torch.core import zpcubic
    at_config4.update(config4_zpc2(dev, w, configs, tricubic, zpcubic, tec,
                                   kernels, plain_full, results, profile))
    if plain_full:
        plain_kw, what = {}, "the same schedule"
        res_k = res1
    else:
        plain_kw = dict(progressive=False, gn_iters=1)
        what = "one Gauss-Newton step on the @33 bundle"
        w = w._replace(rays=w.rays_inner, rays_inner=None)
        res_k, _ = solve(**plain_kw)
    resp, secs_p = solve(linearize=tec.dtec_paired_linear_ref, **plain_kw)
    resp2, _ = solve(linearize=tec.dtec_paired_linear_ref, **plain_kw)
    check(bool(torch.equal(resp.m, resp2.m)),
          "the plain-version solve is bitwise equal across two runs")
    del resp2
    r_k, r_p = float(res_k.residual_norm), float(resp.residual_norm)
    h_k, h_p, h_0 = heldout(res_k.m), heldout(resp.m), heldout(w.m_prior)
    print(f"  the plain-version solve ran {what}: {secs_p:.4f} s, residual "
          f"{r_p!r}")
    check(abs(r_k - r_p) <= 1e-2 * r_p,
          f"final whitened residual {r_k:.4f} within 1% of the plain "
          f"solve's {r_p:.4f}")
    check(abs(h_k - h_p) <= 1e-2 * h_p,
          f"held-out dTEC rms {h_k:.4f} within 1% of the plain solve's "
          f"{h_p:.4f}")
    h_1 = heldout(res1.m)
    check(h_1 < h_0, f"held-out dTEC rms {h_1:.4f} below the prior's "
                     f"{h_0:.4f}")
    del resp
    print(f"  kernel solve: {secs1:.4f}, {secs2:.4f} s (configs.config4: "
          f"{rec['value']:.4f} s); residual {float(res1.residual_norm):.4f}; "
          f"covered rmse {rec['covered_rmse_prior']:.4f} -> "
          f"{rec['covered_rmse_post']:.4f}")

    # the open question of the 256^3 zp inner Jacobian: a finding, no check
    if plain_full:
        za, zsecs_a = solve(interp_inner="zp")
        zb, zsecs_b = solve(interp_inner="zp")
        print(f"  interp_inner='zp' twice: bitwise equal "
              f"{bool(torch.equal(za.m, zb.m))}; held-out dTEC rms "
              f"{heldout(za.m):.4f} (all cubic {h_1:.4f}, prior {h_0:.4f}); "
              f"residual {float(za.residual_norm):.4f}; {zsecs_a:.4f}, "
              f"{zsecs_b:.4f} s (all cubic {secs1:.4f}, {secs2:.4f} s)")
        results["config4_zp_inner"] = {
            "bitwise_equal": bool(torch.equal(za.m, zb.m)),
            "heldout": heldout(za.m), "seconds": [zsecs_a, zsecs_b]}
        del za, zb
    if profile:
        profile_solve(solve)
        if parent is not None:
            profile_solve(lambda: parent.run(solve),
                          "config-4 solve on the parent's kernels")
    results["config4"] = {**rec, "seconds": [secs1, secs2],
                          "plain_seconds": secs_p, "residual": r_k,
                          "plain_residual": r_p, "heldout": h_k,
                          "plain_heldout": h_p, "prior_heldout": h_0,
                          "timings_ms": timings}
    results["config4_launches"] = launches
    results["at_config4"] = at_config4


B_MEMBERS = 8


def member_kernels_at(label, dev, tricubic, kernels, setup, plan, n_rows, nz,
                      xy_first, rng, parent=None, layout=False):
    """K2b and K3b at one point set with B_MEMBERS members: against the
    plain versions (1e-4·max), member by member bitwise against K2 and
    K3, K3b bitwise twice; device ms of each call (its pack and fold
    included), the plain version, the one-call form, the bound, B x the
    unbatched kernel, and each call's time by kernel. With a parent: both
    bitwise the parent's and timed in turns with it. ``layout``: also the
    pack and the fold alone against their plain versions (their lines)."""
    ri, wxy, zi, wz = setup
    n, b = ri.shape[0], B_MEMBERS
    k, l = ri.shape[1], zi.shape[1]
    tables = torch.from_numpy(rng.normal(size=(b, n_rows, nz))
                              .astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(dev)

    def k2b():
        return tricubic.rows_value(tables, ri, wxy, zi, wz, xy_first)

    def k2(m=0):
        return kernels.rows_value_fwd(tables[m], ri, wxy, zi, wz, xy_first)

    def k3b():
        return tricubic.rows_value_transpose(ct, ri, wxy, zi, wz,
                                             (n_rows, nz), plan)

    ct0 = ct[0].contiguous()

    def k3(c=ct0):
        return kernels.rows_value_bwd(c, plan, wxy, zi, wz, nz)

    got = k2b()
    check(all(bool(torch.equal(got[m], k2(m))) for m in range(b)),
          f"K2b at {label}: every member bitwise equal to K2 on that member")
    del got
    n_touched = touched_values(ri, zi, n_rows, nz)
    out = {}
    out["rows_value_fwd_batched"] = check_and_time(
        f"K2b at {label} (B={b}, K={k}, L={l}, {n} points)", k2b,
        lambda: tricubic.rows_value_ref(tables, ri, wxy, zi, wz, xy_first),
        None, bound(nbytes(ri, wxy, zi, wz) + 4 * b * (n_touched + n),
                    b * n * (2 * k * l + 2 * l)),
        scatter=False, plain_reps=2)
    got = k3b()
    check(all(bool(torch.equal(got[m], k3(ct[m].contiguous())))
              for m in range(b)),
          f"K3b at {label}: every member bitwise equal to K3 on that member")
    check(not bool(plan.counters.any()), "the plan's counters at zero")
    del got
    flat, contrib = tricubic.transpose_terms(ct, ri, wxy, zi, wz,
                                             (n_rows, nz))
    buf = torch.zeros((b, n_rows * nz), dtype=torch.float32, device=dev)
    lv = plan.live
    out["rows_value_bwd_batched"] = check_and_time(
        f"K3b at {label} (B={b}, {plan_stats(plan)['pairs']} pairs)", k3b,
        lambda: tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz,
                                                  (n_rows, nz)),
        lambda: buf.index_add_(1, flat, contrib),
        bound(nbytes(ct, zi, wz, ri[:, :lv], wxy[:, :lv])
              + 4 * b * n_rows * nz,
              b * plan_stats(plan)["pairs"] * (1 + 2 * l)),
        scatter=True, plain_reps=2)
    del flat, contrib, buf
    for name, fn in (("K2b", k2b), ("K3b", k3b)):
        print(f"  {name}'s call at {label}, by kernel: " + "; ".join(
            f"{v:.4f} ms {key[:48]}" for key, v in sorted(
                kernel_ms_by_name(fn, 10).items(), key=lambda kv: -kv[1])))
    if parent is not None:
        for name, fn in (("rows_value_fwd_batched", k2b),
                         ("rows_value_bwd_batched", k3b)):
            p_ms, n_ms = compare_parent(f"{name} at {label}",
                                        lambda: parent.run(fn), fn, 20,
                                        pairs=3)
            out[name]["parent_ms"], out[name]["new_ms_in_turns"] = p_ms, n_ms
    k2_ms, k3_ms = device_ms(k2, 20), device_ms(k3, 20)
    print(f"  unbatched at {label}: K2 {k2_ms:.4f} ms, K3 {k3_ms:.4f} ms; "
          f"{b} x K2 {b * k2_ms:.4f} ms against K2b "
          f"{out['rows_value_fwd_batched']['ms']:.4f} ms, {b} x K3 "
          f"{b * k3_ms:.4f} ms against K3b "
          f"{out['rows_value_bwd_batched']['ms']:.4f} ms")
    for name, one in (("rows_value_fwd_batched", k2_ms),
                      ("rows_value_bwd_batched", k3_ms)):
        out[name]["unbatched_ms"] = one
    if layout:
        out.update(member_layout_kernels(label, tricubic, kernels, tables,
                                         plan, rng))
    torch.cuda.empty_cache()
    return out


def member_layout_kernels(label, tricubic, kernels, tables, plan, rng):
    """The two kernels K2b's and K3b's calls launch beside the gather and
    the reduce, alone at the call's shapes: the pack of the tables
    (bitwise its plain version; one call: a transposing copy) and the fold
    of random partial rows (bitwise its plain version; no one call)."""
    b, n_rows, nz = tables.shape
    flat = tables.view(b, -1)

    def pack():
        return kernels.pack_members(flat)

    def plain_pack():
        return tricubic.pack_members_ref(flat)
    check(bool(torch.equal(pack(), plain_pack())),
          f"pack_members of {b} tables at {label}: bitwise its plain version")
    groups = -(-b // kernels.MEMBER_GROUP)
    lines = {"pack_members": check_and_time(
        f"pack_members of {b} tables ({tuple(tables.shape)}) at {label}",
        pack, plain_pack,
        (lambda: flat.t().contiguous()) if b == kernels.MEMBER_GROUP
        else None,
        bound(nbytes(flat) + 4 * kernels.MEMBER_GROUP * groups * flat.shape[1],
              0), scatter=False)}
    parts = torch.from_numpy(rng.normal(size=(b, plan.n_seg_max, nz))
                             .astype(np.float32)).to(tables.device)
    base = torch.zeros_like(tables)
    running = base.clone()

    def fold():
        return kernels.fold_member_rows(parts, plan, base.clone())

    def plain_fold():
        return tricubic.fold_member_rows_ref(parts, plan, base.clone())
    check(bool(torch.equal(fold(), plain_fold())),
          f"fold_member_rows at {label}: bitwise its plain version")
    nseg = plan.row_seg[1:] - plan.row_seg[:-1]
    multi = nseg > 1
    folded = int(nseg[multi].sum())
    n_multi = int(multi.sum())
    print(f"  {n_multi} rows of several segments hold {folded} of the "
          f"{int(plan.row_seg[-1])} segments (busiest row "
          f"{int(nseg.max())})")
    lines["fold_member_rows"] = check_and_time(
        f"fold_member_rows at {label} ({n_multi} rows, {folded} segments)",
        fold, plain_fold, None,
        bound(4 * b * nz * (folded + n_multi), b * nz * folded),
        scatter=False, plain_reps=2,
        timed=lambda: kernels.fold_member_rows(parts, plan, running))
    return lines


def batched_k1e_at(label, dev, kernels, boxspline, grid, pts, rng,
                   parent=None, reps=50):
    """The batched K1e with B_MEMBERS random tables at one point set, over
    a pack made beforehand (as K2b's gather shares it in the operator):
    every member bitwise K1e on that member's table; within
    1e-5·max|table| (the gradient over the smallest spacing) of the plain
    version; timed beside B launches of K1e, the plain version and its
    bound (every member's distinct values). With a parent: bitwise the
    parent's batched K1e and timed in turns with it."""
    b = B_MEMBERS
    nx, ny, nz = grid.shape
    tables = torch.from_numpy(rng.normal(size=(b, nx * ny, nz))
                              .astype(np.float32)).to(dev)
    packed = kernels.pack_members(tables.view(b, -1))

    def batched():
        return kernels.zp_value_grad_batched(tables, grid, pts, packed)

    def looped():
        return [kernels.zp_value_grad(tables[m], grid, pts)
                for m in range(b)]

    v, g = batched()
    check(all(torch.equal(v[m], vm) and torch.equal(g[m], gm)
              for m, (vm, gm) in enumerate(looped())),
          f"the batched K1e at {label}: every member bitwise K1e on that "
          f"member")
    v_p, g_p = boxspline.interp_rows_with_grad_batched_ref(tables, grid, pts)
    tmax = float(tables.abs().max())
    err_v = float((v - v_p).abs().max())
    err_g = float((g - g_p).abs().max())
    gtol = 1e-5 * tmax / float(grid.spacing.min())
    check(err_v <= 1e-5 * tmax and err_g <= gtol,
          f"the batched K1e at {label}: value max|err| {err_v:.3e} <= "
          f"1e-5*max|table|, gradient {err_g:.3e} <= {gtol:.3e}")
    del v, g, v_p, g_p
    ms, loop_ms = device_ms(batched, reps), device_ms(looped, reps)
    plain = device_ms(lambda: boxspline.interp_rows_with_grad_batched_ref(
        tables, grid, pts), 2)
    b_ms, b_by = k1e_bound(boxspline, grid, pts, members=b)
    print(f"  the batched K1e at {label} (B={b}): kernel {ms:.4f} ms, "
          f"{b} x K1e {loop_ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    line = dict(max_abs_err=err_v, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=pts.shape[0],
                unbatched_ms=loop_ms / b, looped_ms=loop_ms)
    if parent is not None:
        line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
            f"the batched K1e ({b} members) at {label}",
            lambda: parent.run(batched), batched, reps, pairs=3)
    return line


def phase11_member_kernels(dev, world, boxspline, tricubic, tec, kernels,
                           Grid3D, results, parent=None):
    from ionotomo_tpu_torch.testing import edge_case_points

    print(f"phase 11: the member-axis kernels K2b and K3b (B={B_MEMBERS}) "
          f"against their plain versions and the unbatched kernels")
    rng = np.random.default_rng(11)
    at = {}
    nx, ny, nz = world.grid.shape
    for name, rb in (("config 5's outer bundle", world.rays),
                     ("config 5's inner bundle", world.rays_inner)):
        geo = tec.DtecGeometry(world.grid, rb, world.n_dirs, 0, "hermite",
                               "zp")
        print_plan(f"K3b at {name}", geo.row_plan)
        at[f"zp@{geo.ri.shape[0]}"] = member_kernels_at(
            name, dev, tricubic, kernels, (geo.ri, geo.wxy, geo.zi, geo.wz),
            geo.row_plan, nx * ny, nz, True, rng, parent,
            layout=rb is world.rays)
        del geo
    shape = (N_GRID,) * 3
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    pts = torch.from_numpy(edge_case_points(shape, origin, spacing, 1 << 20,
                                            rng)).to(dev)
    n_rows = N_GRID * N_GRID
    for name, rows, xy_first in (("zp", boxspline, True),
                                 ("cubic", tricubic, False)):
        setup = rows.row_setup(grid, pts)
        plan = rows.row_plan(setup[0], setup[2], n_rows)
        label = f"the {pts.shape[0]} edge-case points, {name}"
        print_plan(f"K3b at {label}", plan)
        at[f"{name}@edge"] = member_kernels_at(
            label, dev, tricubic, kernels, setup, plan, n_rows, N_GRID,
            xy_first, rng, parent)
        del setup, plan
    n_outer = world.rays.num_rays * world.rays.num_samples
    # the batched K1e at config 5's endpoints and at the edge-case points
    ends = tec._endpoint_tangents(world.rays.points)[0]
    for key, label, g, p in (
            (f"zp@{n_outer}", f"config 5's {ends.shape[0]} endpoints",
             world.grid, ends),
            ("zp@edge", f"the {pts.shape[0]} edge-case points", grid, pts)):
        at[key]["zp_value_grad_batched"] = batched_k1e_at(
            label, dev, kernels, boxspline, g, p, rng, parent)
    for name in ("rows_value_fwd_batched", "rows_value_bwd_batched",
                 "pack_members", "fold_member_rows", "zp_value_grad_batched"):
        results[name] = {"line": at[f"zp@{n_outer}"].pop(name)
                         if name in ("pack_members", "fold_member_rows")
                         else at[f"zp@{n_outer}"][name]}
    results["at_member_shapes"] = at


class PlainCalls:
    """Counts the calls of the kernels' plain versions while active, so a
    phase can show that its kernel path reached none."""

    NAMES = ("rows_value_ref", "rows_value_transpose_ref",
             "interp_rows_with_grad_ref", "interp_rows_with_grad_batched_ref",
             "interp_rows_with_grad_transpose_ref")

    def __init__(self, *modules):
        self.modules, self.count, self.saved = modules, 0, []

    def __enter__(self):
        for mod in self.modules:
            for name in self.NAMES:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue
                self.saved.append((mod, name, fn))

                def counted(*a, _fn=fn, **k):
                    self.count += 1
                    return _fn(*a, **k)

                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class MemberE:
    """Counts E's applications to a member axis while active: calls of
    ``PairedDtecLinear._value_grad`` with a (B, R, nz) table."""

    def __init__(self, tec):
        self.cls, self.count = tec.PairedDtecLinear, 0

    def __enter__(self):
        self.saved = fn = self.cls._value_grad

        def counted(op, table, *a, **k):
            self.count += table.dim() == 3
            return fn(op, table, *a, **k)

        self.cls._value_grad = counted
        return self

    def __exit__(self, *exc):
        self.cls._value_grad = self.saved


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase12_config5(dev, world, boxspline, tricubic, tec, kernels, configs,
                    results, profile=False, n_steps=30, chunk=6,
                    parent=None):
    from ionotomo_tpu_torch.testing import KALMAN_KERNELS, MEMBER_KERNELS

    w = world
    print(f"phase 12: config 5, the frozen-flow Kalman filter "
          f"(configs.config5): grid {w.grid.shape} spacing "
          f"{[round(float(x), 3) for x in w.grid.spacing]} km, {n_steps} "
          f"epochs x {w.rays.num_rays} rays x {w.rays.num_samples} (inner "
          f"{w.rays_inner.num_samples}) samples, zp, cg 10, chunks of "
          f"{chunk}, noise {w.noise:.4f}")
    check(bool(torch.isfinite(w.d_seq).all()
               and torch.isfinite(w.m_true_last).all()),
          "world: finite data and truth")
    check(tuple(w.d_seq.shape[:1]) == (n_steps,), f"{n_steps} epochs of data")

    # the entry point: a warm-up run and a timed run, counters read around
    cache = {}
    plans0 = tricubic.plans_built[0]
    kernels.reset_launches()
    with PlainCalls(tricubic, boxspline) as plain_calls:
        rec = configs.config5(world=w, chunk=chunk, geometry_cache=cache)
        launches = dict(kernels.launches)
    plans_run = tricubic.plans_built[0] - plans0
    print(f"  config5: {json.dumps(rec)}")
    print(f"  launches in config 5 (two runs of {n_steps} steps and the "
          f"metrics): {launches}; row plans built {plans_run} (both runs "
          f"share them), geometries {len(cache)}")
    for name in KALMAN_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in config 5 ({launches[name]} times)")
    check(all(launches[name] == 0 for name in MEMBER_KERNELS),
          "the point filter launched no member-axis kernel")
    check(plain_calls.count == 0,
          "the kernel path called no plain version")
    check(rec["heldout_dtec_rms_post"] < rec["heldout_dtec_rms_prior"],
          f"held-out dTEC rms {rec['heldout_dtec_rms_post']:.4f} below the "
          f"prior's {rec['heldout_dtec_rms_prior']:.4f}")

    def run(**kw):
        return timed(lambda: configs.config5_filter(
            w, chunk=chunk, geometry_cache=cache, **kw))

    kernels.reset_launches()
    (m_a, pre_a, post_a), secs_a = run()
    results["config5_run_launches"] = dict(kernels.launches)
    (m_b, pre_b, post_b), secs_b = run()
    check(bool(torch.isfinite(m_a).all()), "filtered state finite")
    check(bool(torch.equal(m_a, m_b) and torch.equal(pre_a, pre_b)
               and torch.equal(post_a, post_b)),
          "the chunked filter is bitwise equal across two runs")
    (m_1, pre_1, post_1), secs_1 = timed(lambda: configs.config5_filter(
        w, chunk=None, geometry_cache=cache))
    check(bool(torch.equal(m_a, m_1) and torch.equal(pre_a, pre_1)
               and torch.equal(post_a, post_1)),
          f"one call of {n_steps} steps is bitwise equal to the "
          f"{n_steps // chunk} chained chunks")
    check(bool((post_a < pre_a).all()),
          "every step's post-update residual is below its pre-update "
          "residual")
    # K1e, E of every step's J, at the outer bundle's endpoints
    nx, ny, nz = w.grid.shape
    results["k1e_config5"] = k1e_at(
        f"config 5's {2 * w.rays.num_rays} endpoints", kernels, boxspline,
        boxspline.prefilter(w.m_bg).reshape(nx * ny, nz), w.grid,
        tec._endpoint_tangents(w.rays.points)[0], parent)

    # the first chunk on the plain versions of the kernels
    (m_k, pre_k, post_k), _ = run(n_steps=chunk)
    if parent is not None:
        (m_q, pre_q, post_q), _ = parent.run(lambda: run(n_steps=chunk))
        check(bool(torch.equal(m_q, m_k) and torch.equal(pre_q, pre_k)
                   and torch.equal(post_q, post_k)),
              f"the first {chunk} steps bitwise on the parent's kernels")
        del m_q, pre_q, post_q
    (m_p, pre_p, post_p), secs_p = run(
        n_steps=chunk, linearize=tec.dtec_paired_linear_ref)
    for name, a, b in (("pre-update", pre_k, pre_p),
                       ("post-update", post_k, post_p)):
        rel = float(((a - b).abs() / b).max())
        check(rel <= 1e-2, f"first chunk: {name} residuals within 1% of "
                           f"the plain-version filter's (max {rel:.3e})")
    h_k = configs.config5_heldout_rms(m_k, w, "zp", chunk - 1)
    h_p = configs.config5_heldout_rms(m_p, w, "zp", chunk - 1)
    check(abs(h_k - h_p) <= 1e-2 * h_p,
          f"first chunk: held-out dTEC rms {h_k:.4f} within 1% of the "
          f"plain-version filter's {h_p:.4f}")
    print(f"  {n_steps} steps: {secs_a:.4f}, {secs_b:.4f} s chunked, "
          f"{secs_1:.4f} s in one call (configs.config5: "
          f"{rec['value']:.4f} s, {rec['timesteps_per_sec']:.2f} steps/s); "
          f"the plain-version filter's first {chunk} steps {secs_p:.4f} s; "
          f"residual reduction {rec['mean_residual_reduction']:.3f}; covered "
          f"rmse {rec['covered_rmse_prior']:.4f} -> "
          f"{rec['covered_rmse_post']:.4f}; held-out "
          f"{rec['heldout_dtec_rms_prior']:.4f} -> "
          f"{rec['heldout_dtec_rms_post']:.4f}")
    if profile:
        def one_step():
            return timed(lambda: configs.kalman.kalman_filter(
                w.grid, configs._expand_steps(w.rays, 1), w.d_seq[6:7],
                w.noise, m_k, w.cov, w.wind, w.dt_s, num_directions=w.n_dirs,
                cg_iters=10, advect_first=True, m_clim=w.m_bg,
                rays_inner_seq=configs._expand_steps(w.rays_inner, 1),
                interp="zp", geometry_cache=cache))
        profile_solve(one_step, "config-5 filter step")
    per_run = {k: v // 2 for k, v in launches.items()}
    results["config5"] = {**rec, "seconds": [secs_a, secs_b, secs_1],
                          "plain_chunk_seconds": secs_p, "plans": plans_run,
                          "heldout_chunk": h_k, "plain_heldout_chunk": h_p}
    results["config5_launches"] = launches
    print(f"  about {sum(per_run.values()) // n_steps} hand-written kernel "
          f"launches a step")
    return cache


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (a host copy)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase13_enkf(dev, world, cache, boxspline, tricubic, tec, kernels,
                 configs, results, profile=False, n_steps=6, parent=None):
    from ionotomo_tpu_torch.testing import ENKF_KERNELS

    w, b = world, B_MEMBERS
    print(f"phase 13: the ensemble filter at config 5's world "
          f"(configs.config5_enkf): {b} members, {n_steps} steps, cg 10, "
          f"inner @{w.rays_inner.num_samples}")
    noise = configs.enkf_noise(w, b, n_steps, seed=0)

    def run(**kw):
        return timed(lambda: configs.config5_enkf_filter(
            w, noise, geometry_cache=cache, **kw))

    run(n_steps=1)                                   # warm-up
    kernels.reset_launches()
    with PlainCalls(tricubic, boxspline) as plain_calls, \
            MemberE(tec) as e_calls:
        res_a, secs_a = run(n_steps=n_steps)
        launches = dict(kernels.launches)
    print(f"  launches in one run of {n_steps} ensemble steps: {launches}")
    for name in ENKF_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in the ensemble filter ({launches[name]} "
              f"times)")
    check(launches["rows_value_fwd"] == 0 and launches["rows_value_bwd"] == 0,
          "the member update launched K2b and K3b, and the unbatched K2 and "
          "K3 not once in their place")
    check(launches["zp_value_grad"] == 0
          and launches["zp_value_grad_batched"] == e_calls.count,
          f"E on the member axis: the batched K1e once per application "
          f"({launches['zp_value_grad_batched']} launches, {e_calls.count} "
          f"applications), the unbatched K1e never")
    check(launches["zp_value_grad_bwd"] % b == 0,
          f"the endpoint transpose ran once per member "
          f"({launches['zp_value_grad_bwd']})")
    check(plain_calls.count == 0, "the kernel path called no plain version")
    res_b, secs_b = run(n_steps=n_steps)
    ra, rb_ = res_a[0], res_b[0]
    check(bool(torch.isfinite(ra.ensemble).all()), "final ensemble finite")
    check(bool(torch.equal(ra.ensemble, rb_.ensemble)
               and torch.equal(ra.mean_seq, rb_.mean_seq)
               and torch.equal(ra.std_seq, rb_.std_seq)),
          "the ensemble filter is bitwise equal across two runs")
    sha = digest(ra.ensemble, ra.mean_seq, ra.std_seq)
    print(f"  sha256 of the final ensemble, mean_seq and std_seq after "
          f"{n_steps} steps: {sha}")
    if parent is not None:
        (rp,), _ = parent.run(lambda: run(n_steps=n_steps))
        p_sha = digest(rp.ensemble, rp.mean_seq, rp.std_seq)
        check(p_sha == sha, f"the ensemble filter on the parent's kernels: "
                            f"sha256 {p_sha}, the same")
        del rp
    res_c, _ = run(n_steps=n_steps, chunk=n_steps // 2)
    check(bool(torch.equal(ra.ensemble, res_c[-1].ensemble)
               and torch.equal(ra.mean_seq, torch.cat(
                   [r.mean_seq for r in res_c]))),
          f"{n_steps} steps in one call are bitwise equal to "
          f"{n_steps // 2} + {n_steps // 2} chained through ens0 and "
          f"step_offset")
    spread = ra.std_seq[-1]
    check(bool(torch.isfinite(spread).all()) and float(spread.min()) >= 0
          and float(spread.mean()) > 0,
          f"spread finite and positive (mean {float(spread.mean()):.4f}, "
          f"min {float(spread.min()):.3e})")
    h_m = configs.config5_heldout_rms(ra.mean_seq[-1], w, "zp", n_steps - 1)
    h_0 = configs.config5_heldout_rms(w.m_bg, w, "zp", n_steps - 1)
    check(h_m < h_0, f"the mean's held-out dTEC rms {h_m:.4f} at epoch "
                     f"{n_steps - 1} below the prior's {h_0:.4f}")

    # one step through the plain versions of the kernels
    (one_k,), _ = run(n_steps=1)
    (one_p,), secs_p = run(n_steps=1, linearize=tec.dtec_paired_linear_ref)
    upd = float(torch.linalg.norm(one_p.mean_seq[0] - w.m_bg))
    rel = float(torch.linalg.norm(one_k.mean_seq[0] - one_p.mean_seq[0])) / upd
    check(rel <= 1e-2, f"one step: the mean's update within 1% of the "
                       f"plain-version filter's (relative L2 {rel:.3e})")
    hk = configs.config5_heldout_rms(one_k.mean_seq[0], w, "zp", 0)
    hp = configs.config5_heldout_rms(one_p.mean_seq[0], w, "zp", 0)
    sk, sp = float(one_k.std_seq[0].mean()), float(one_p.std_seq[0].mean())
    check(abs(hk - hp) <= 1e-2 * hp and abs(sk - sp) <= 1e-2 * sp,
          f"one step: held-out rms {hk:.4f} and mean spread {sk:.5f} within "
          f"1% of the plain-version filter's {hp:.4f}, {sp:.5f}")
    rec = configs.config5_enkf(world=w, n_members=b, n_steps=n_steps,
                               geometry_cache=cache)
    print(f"  config5_enkf: {json.dumps(rec)}")
    point_step = min(results["config5"]["seconds"]) / \
        results["config5"]["steps"]
    step = min(secs_a, secs_b) / n_steps
    print(f"  an ensemble step of {b} members: {step:.4f} s "
          f"({secs_a:.4f}, {secs_b:.4f} s for {n_steps} steps); {b} x the "
          f"point filter's {point_step:.4f} s a step = {b * point_step:.4f} "
          f"s: the member axis buys {b * point_step / step:.2f} x; the "
          f"plain-version ensemble step {secs_p:.4f} s")
    if profile:
        profile_solve(lambda: run(n_steps=1), "ensemble filter step")
        if parent is not None:
            profile_solve(lambda: parent.run(lambda: run(n_steps=1)),
                          "ensemble filter step on the parent's kernels")
    results["config5_enkf"] = {**rec, "seconds": [secs_a, secs_b],
                               "seconds_per_step": step,
                               "point_seconds_per_step": point_step,
                               "heldout": h_m, "prior_heldout": h_0,
                               "plain_step_seconds": secs_p,
                               "sha256": sha}
    results["enkf_launches"] = launches


def kernel_ms_by_name(fn, reps: int) -> dict:
    """Device ms a call of ``fn`` spends in each kernel, by name, from one
    profiler trace over ``reps`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def k1c_study(reps=3) -> int:
    """``--k1c-study``: what binds K1c at config 2's saturated batch
    (262,144 rays = 512 antennas x 512 directions, 128 steps, the 128^3
    Chapman cube). Every variant is held bitwise to the unpacked kernel
    in ray order (the kernel before the redesign) and timed by
    ``device_ms``: the table unpacked or z-tap-packed; the rays in their
    own order (a warp = one antenna's 32 directions), sorted by direction
    then origin (``kernels.ray_order``: parallel rays from neighbouring
    antennas) or by origin then direction (one antenna's neighbouring
    directions); 64, 128 and 256 threads a block; and the time against
    the step count. The packed variants read one pack made before the
    timing (the pack's own time is phase 9's). Prints ptxas's registers
    for the tracer."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    info = build.build()
    print(f"build: built={info['built']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "trace_leapfrog" in line or "registers" in line:
            print(f"  ptxas: {line.strip()}")
    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    table = m.reshape(N_GRID * N_GRID, N_GRID)
    ants, dirs = configs.make_rays(512, 512)
    o, d = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                               torch.from_numpy(dirs).to(dev))
    n = o.shape[0]
    packed = kernels.pack_z_taps(table, grid)
    key = kernels.ray_order_keys_ref(o, d, grid).long() + 2 ** 31
    orders = {
        "own order": None,
        "direction, then origin": kernels.ray_order(o, d, grid),
        "origin, then direction": torch.argsort(
            ((key & 0xFFFF) << 16) | (key >> 16)).to(torch.int32),
    }
    check(bool(torch.all(torch.diff(key[orders["direction, then origin"]
                                        .long()]) >= 0)),
          "ray_order sorts the rays by the plain version's keys")

    def run(steps, pk, order, threads):
        kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, steps)
        return kernels.trace_leapfrog_cubic_with(
            table, grid, o, d, steps, False, packed=pk, order=order,
            threads=threads, **kw)

    want = run(128, None, None, 128)
    rows = []
    for layout in ("unpacked", "packed"):
        pk = packed if layout == "packed" else None
        for oname, order in orders.items():
            for threads in (64, 128, 256):
                label = f"K1c {layout:8s} {oname:24s} {threads:4d} threads"
                got = run(128, pk, order, threads)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b)
                          for a, b in zip(got[:2], want[:2])),
                      f"{label}: bitwise the unpacked kernel in ray order")
                ms = device_ms(lambda: run(128, pk, order, threads), reps)
                rows.append((layout, oname, threads, ms))
                print(f"  {label}: {ms:.4f} ms")
    best = min(rows, key=lambda r: r[-1])
    print(f"  fastest: {best}")
    pk = packed if best[0] == "packed" else None
    for steps in (16, 32, 64, 128):
        a = device_ms(lambda: run(steps, None, None, 128), reps)
        b = device_ms(lambda: run(steps, pk, orders[best[1]], best[2]),
                      reps)
        print(f"  {steps:4d} steps: unpacked, own order, 128 threads {a:.4f} "
              f"ms; fastest variant {b:.4f} ms")
    by_name = kernel_ms_by_name(lambda: kernels.trace_leapfrog_cubic(
        table, grid, o, d, 128, False, **fermat._step_constants(
            FREQ_HZ, LENGTH_KM, 128)), reps)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"  the wrapper, by kernel: {ms:.4f} ms  {name[:90]}")
    # config 2's literal array: 6,200 rays, 24-49 blocks of 256-128
    o6, d6 = rays.make_ray_batch(*(torch.from_numpy(a).to(dev)
                                   for a in configs.make_rays(62, 100)))
    k = fermat._step_constants(FREQ_HZ, LENGTH_KM, 128)
    want6 = kernels.trace_leapfrog_cubic_with(
        table, grid, o6, d6, 128, False, packed=None, order=None,
        threads=128, **k)
    order6 = kernels.ray_order(o6, d6, grid)
    for layout, pk in (("unpacked", None), ("packed", packed)):
        for oname, order in (("own order", None), ("sorted", order6)):
            for threads in (32, 64, 128, 256):
                def run6():
                    return kernels.trace_leapfrog_cubic_with(
                        table, grid, o6, d6, 128, False, packed=pk,
                        order=order, threads=threads, **k)
                got = run6()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got[:2],
                                                            want6[:2])),
                      f"K1c at 6200 rays, {layout}, {oname}, {threads}: "
                      f"bitwise")
                print(f"  K1c at 6200 rays {layout:8s} {oname:9s} "
                      f"{threads:4d} threads: {device_ms(run6, 5):.4f} ms")
    print(f"  ray_order at 6200 rays "
          f"{device_ms(lambda: kernels.ray_order(o6, d6, grid), 10):.4f} ms")
    sort_ms = device_ms(lambda: kernels.ray_order(o, d, grid), 10)
    k = fermat._step_constants(FREQ_HZ, LENGTH_KM, 128)
    wrapper_ms = device_ms(lambda: kernels.trace_leapfrog_cubic(
        table, grid, o, d, 128, False, **k), reps)
    wrapper_ev = cuda_ms(lambda: kernels.trace_leapfrog_cubic(
        table, grid, o, d, 128, False, **k), 10)
    print(f"  ray_order alone {sort_ms:.4f} ms; the wrapper (sort, pack, "
          f"trace) {wrapper_ms:.4f} ms by device_ms, {wrapper_ev:.4f} ms by "
          f"CUDA events; {n} rays on {card}")
    return 0


def k2_study(reps=20) -> int:
    """``--k2-study``: what binds K2 at config 4's two bundles (650,000 and
    330,000 points of the 65- and 33-sample bundles, a (65536, 256) table,
    past the L2), at config 3b's 650,000 zp points (a (16384, 128) table)
    and at two more (zp on 256^3, cubic on 128^3). Every way is held
    bitwise to K2's generic kernel in ray order (``generic_k2``, the
    kernel before the redesign) and timed by ``device_ms``: the generic
    kernel; the fixed-shape kernel in ray order and over the model's
    point order (its inputs permuted into it), each with a point's index
    and weight rows read as 16-byte vectors (the default build) and as
    scalars (a library built with ``K2_ROW_VECTORS=0``); the order's keys
    and sort and the whole ``PointOrder``; and a floor: every point moved
    into one cell, so that every tap after the first warp's hits L1.
    Prints each shape's distinct table values and its bound, and ptxas's
    registers for K2."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import boxspline, tricubic
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    libs = {}
    for loads, defines in (("vector rows", ()),
                           ("scalar rows", ("K2_ROW_VECTORS=0",))):
        info = build.build(defines=defines)
        libs[loads] = build.open_library(info["path"])
        print(f"build ({loads}): built={info['built']} in "
              f"{info['seconds']:.2f} s")
        for line in ptxas_lines(info["log"], ("rows_value_fwd",)):
            print(f"  ptxas ({loads}): {line}")
    default = build.load()

    def with_lib(loads, fn):
        build._loaded["lib"] = libs[loads]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    ants, dirs = configs.make_rays(100, 100)
    shapes = []
    for model, n_grid, n_s in ((tricubic, 256, 65), (tricubic, 256, 33),
                               (boxspline, 128, 65), (boxspline, 256, 65),
                               (tricubic, 128, 65)):
        grid = chapman.grid_enclosing_rays(ants, dirs, shape=(n_grid,) * 3,
                                           h_min_km=0.0, device=dev)
        rb = configs.straight_bundle(ants, dirs, n_s, dev)
        shapes.append((model, grid, model.row_setup(
            grid, rb.points.reshape(-1, 3))))
    rng = np.random.default_rng(21)
    for model, grid, setup in shapes:
        ri, wxy, zi, wz = setup
        xy_first = model is boxspline
        n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
        table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                                 .astype(np.float32)).to(dev)
        n = ri.shape[0]
        label = (f"{'zp' if xy_first else 'cubic'} {n} points of "
                 f"{grid.shape[0]}^3")
        want = generic_k2(kernels, table, *setup, xy_first)
        ms = device_ms(lambda: generic_k2(kernels, table, *setup, xy_first),
                       reps)
        print(f"  {label}: the generic kernel in ray order {ms:.4f} ms")
        base = model.BASE_TRANSLATE
        sort_ms = device_ms(lambda: kernels.point_order(ri, zi, base,
                                                        grid.shape), 10)
        build_ms = device_ms(lambda: model.point_order(*setup, grid.shape),
                             10)
        po = model.point_order(*setup, grid.shape)
        print(f"  {label}: the point order's keys and sort {sort_ms:.4f} ms, "
              f"the whole PointOrder {build_ms:.4f} ms")
        for loads in libs:
            for oname, order in (("ray order", None), ("point order", po)):
                def k2():
                    return tricubic.rows_value(table, *setup, xy_first,
                                               order=order)
                got = with_lib(loads, k2)
                torch.cuda.synchronize()
                check(bool(torch.equal(got, want)),
                      f"{label}, {loads}, {oname}: bitwise")
                ms = with_lib(loads, lambda: device_ms(k2, reps))
                print(f"  {label}: {loads}, {oname}: {ms:.4f} ms")
        # the floor: every point in the first point's cell
        one = [t[:1].expand_as(t).contiguous() for t in (ri, zi)]
        ms = device_ms(lambda: kernels.rows_value_fwd(
            table, one[0], wxy, one[1], wz, xy_first), reps)
        print(f"  {label}: every point in one cell: {ms:.4f} ms")
        live = boxspline.ZP_LIVE_TRANSLATES if xy_first else 16
        b_ms, b_by = k2_bound(*setup, n_rows, nz, live,
                              FLOPS_K2_POINT if xy_first
                              else FLOPS_K2_CUBIC_POINT)
        print(f"  {label}: {touched_values(ri[:, :live], zi, n_rows, nz)} "
              f"distinct table values of {n_rows * nz}; bound {b_ms:.4f} "
              f"ms ({b_by}) on {card}")
        del table, want, po, one
        torch.cuda.empty_cache()
    return 0


def gather_study(reps=50) -> int:
    """``--gather-study``: what binds KG and the point order's permute.
    Each variant is a library of its own (``build.build(defines=...)``),
    held bitwise to the plain version and timed by ``device_ms`` in two
    passes of opposite order beside the default build.

    KG at the probe's inputs (``probe_inputs``) of (8, 128), the one-vreg
    control, and of (4096, 128), (16384, 128) and (65536, 128): one
    element a thread (the default), four a thread (``KG_FORCE=4``), a
    CTA a band of 8 columns read through L1 (``KG_FORCE=2``), a band's
    row slabs in CTAs' own shared memory (``KG_FORCE=3``) and a band held
    by a cluster of 1, 2, 4 or 8 CTAs, read through distributed shared
    memory (``KG_CLUSTER=C``; "not taken" where the band does not fit),
    each warm (the 24 MB of table, indices and output stay in the L2
    across launches) and with the L2 cleared before each launch
    (``l2_flush``, untimed); ``torch.gather`` beside them; the bound from
    the distinct table values the indices touch, and a floor: the
    default kernel with idx[i, j] = i, a copy whose every sector is
    full.

    The permute at config 4's 650,000 cubic points (K = 16, L = 4) and
    config 3b's 650,000 zp points (K = 8, L = 3), each in its point order
    and in a random one: the default, a tile of 256 points of one array a
    block staged through shared memory; a thread a point
    (``PERMUTE_VARIANT=0``, the kernel before the redesign); a 16-byte
    vector or word of one array a thread without a tile
    (``PERMUTE_VARIANT=1``); tiles of 128 and 512 points
    (``PERMUTE_TILE``, ``PERMUTE_THREADS=512``) and 8 loads a thread in
    flight (``PERMUTE_LOADS=8``); ``index_select`` beside them; the bound
    from the inputs and outputs moved once and the order read once."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import boxspline, tricubic
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman
    from ionotomo_tpu_torch.probes import gather

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    variants = {"default": (), "four a thread": ("KG_FORCE=4",),
                "a band a CTA through L1": ("KG_FORCE=2",),
                "row slabs in shared memory": ("KG_FORCE=3",),
                **{f"band in a cluster, C={c}": (f"KG_CLUSTER={c}",)
                   for c in (1, 2, 4, 8)},
                "a thread a point": ("PERMUTE_VARIANT=0",),
                "an element a thread": ("PERMUTE_VARIANT=1",),
                "tile of 128": ("PERMUTE_TILE=128",),
                "tile of 512": ("PERMUTE_TILE=512",),
                "tile of 512, 512 threads": ("PERMUTE_TILE=512",
                                             "PERMUTE_THREADS=512"),
                "8 loads in flight": ("PERMUTE_LOADS=8",)}
    libs = {}
    for name, defines in variants.items():
        info = build.build(defines=defines)
        libs[name] = build.open_library(info["path"])
        print(f"build ({name}): built={info['built']} in "
              f"{info['seconds']:.2f} s")
        for kern, regs in ptxas_lines(info["log"], (
                "vector_gather_kernel", "vector_gather_vec4",
                "vector_gather_band", "vector_gather_l1", "vector_gather_slab",
                "permute_points")):
            print(f"  ptxas ({name}): {kern}: {regs}")
    default = build.load()

    def with_lib(name, fn):
        build._loaded["lib"] = libs[name]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    def timed_in_passes(label, names, fn, want, **kw):
        times = {}
        for pass_ in (names, names[::-1]):
            for name in pass_:
                try:
                    got = with_lib(name, fn)
                except RuntimeError as e:
                    times[name] = f"not taken ({str(e)[-40:]})"
                    continue
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in
                          zip(_outputs(got), want)),
                      f"{label}, {name}: bitwise the plain version")
                times.setdefault(name, []).append(with_lib(
                    name, lambda: device_ms(fn, reps, **kw)))
        for name, t in times.items():
            print(f"  {label}, {name}: " + (t if isinstance(t, str) else
                  ", ".join(f"{x:.4f}" for x in t) + " ms"))

    flush, flush_names = l2_flush(dev)
    kg_names = list(variants)[:8]
    for rows in (8, 4096, 16384, 65536):
        table, idx = gather.probe_inputs(rows, 128, dev)
        want = [gather.vector_gather_ref(table, idx)]
        (b_ms, b_by), distinct = kg_bound(table, idx)
        label = f"KG at ({rows}, 128)"
        print(f"  {label}: bound {b_ms:.4f} ms ({b_by}: {distinct} "
              f"distinct table values of {table.numel()}) on {card}")

        def kg():
            return gather.vector_gather(table, idx)

        ident = torch.arange(rows, dtype=torch.int32, device=dev)[
            :, None].expand(rows, 128).contiguous()
        floor = device_ms(lambda: gather.vector_gather(table, ident), reps)
        floor_cold = device_ms(lambda: (flush(), gather.vector_gather(
            table, ident)), reps, exclude=flush_names)
        print(f"  {label}, the floor (idx[i, j] = i, every sector full): "
              f"warm {floor:.4f} ms, L2 cleared {floor_cold:.4f} ms")
        timed_in_passes(f"{label}, warm", kg_names, kg, want)
        timed_in_passes(f"{label}, L2 cleared", kg_names,
                        lambda: (flush(), kg())[1], want,
                        exclude=flush_names)
        warm = device_ms(lambda: gather.vector_gather_ref(table, idx), reps)
        cold = device_ms(lambda: (flush(), gather.vector_gather_ref(
            table, idx)), reps, exclude=flush_names)
        print(f"  {label}, torch.gather: warm {warm:.4f} ms, L2 cleared "
              f"{cold:.4f} ms")
        del table, idx, want, ident
    del flush
    torch.cuda.empty_cache()

    ants, dirs = configs.make_rays(100, 100)
    rb = configs.straight_bundle(ants, dirs, 65, dev)
    perm_names = ["default"] + list(variants)[8:]
    for model, n_grid, what in ((tricubic, 256, "config 4's cubic"),
                                (boxspline, 128, "config 3b's zp")):
        grid = chapman.grid_enclosing_rays(ants, dirs, shape=(n_grid,) * 3,
                                           h_min_km=0.0, device=dev)
        setup = model.row_setup(grid, rb.points.reshape(-1, 3))
        n = setup[0].shape[0]
        po = kernels.point_order(setup[0], setup[2], model.BASE_TRANSLATE,
                                 grid.shape)
        rand = torch.randperm(n, generator=torch.Generator().manual_seed(3)
                              ).to(torch.int32).to(dev)
        b_ms, b_by = bound(2 * nbytes(*setup) + nbytes(po), 0)
        print(f"  the permute at {what} {n} points: bound {b_ms:.4f} ms "
              f"({b_by}) on {card}")
        for oname, order in (("point order", po), ("random order", rand)):
            label = f"the permute at {what} points, {oname}"
            want = [t[order.long()] for t in setup]
            timed_in_passes(label, perm_names,
                            lambda: kernels.permute_points(order, *setup),
                            want)
            ms = device_ms(lambda: [torch.index_select(t, 0, order)
                                    for t in setup], 5)
            print(f"  {label}, index_select: {ms:.4f} ms")
            del want
        del setup, po, rand
        torch.cuda.empty_cache()
    return 0


def k1_study(reps=3) -> int:
    """``--k1-study``: what binds K1 at bench.py's batch (262,144 rays, 64
    steps, the 128^3 Chapman cube) and at the serving batch (62 x 10 rays,
    64 steps, path). Every variant is held bitwise to the unpacked kernel
    in ray order at 128 threads (the kernel before the redesign) and timed
    by ``device_ms``: the table unpacked or z-tap-packed; the rays in their
    own order or sorted (``kernels.ray_order``); 32-256 threads a block.
    The packed variants read one pack made before the timing; the pack's
    and the sort's own times are printed beside them. Then the whole call
    (its pack and sort included) three ways at batches from 10,000 to
    262,144 rays: unpacked in ray order at 32 threads (the wrapper's
    small batch), packed at 64, packed and sorted at 64 (its large
    batch); ``kernels.TRACE_ZP_RAYS_PER_SM`` is where the last starts to
    beat the first. Prints ptxas's registers for the tracer."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core import boxspline
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    info = build.build()
    print(f"build: built={info['built']} in {info['seconds']:.2f} s")
    for line in ptxas_lines(info["log"], ("trace_leapfrog",)):
        print(f"  ptxas: {line}")
    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    coef = boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    packed = kernels.pack_zp_taps(coef, grid)
    pack_ms = device_ms(lambda: kernels.pack_zp_taps(coef, grid), 20)
    print(f"  the pack {pack_ms:.4f} ms")
    _, ants, dirs = serving_epochs()[0]
    batches = {"bench.py's 262144 rays": (bench_rays(262144), False),
               "serving's 620 rays": (tuple(
                   t.cpu().numpy() for t in rays.make_ray_batch(
                       torch.from_numpy(ants), torch.from_numpy(dirs))),
                   True)}
    for label, ((o, d), path) in batches.items():
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        order = kernels.ray_order(o, d, grid)
        print(f"  {label}: ray_order "
              f"{device_ms(lambda: kernels.ray_order(o, d, grid), 10):.4f} "
              f"ms")

        def run(pk, order, threads):
            return kernels.trace_leapfrog_zp_with(
                coef, grid, o, d, N_STEPS, path, packed=pk, order=order,
                threads=threads, **kw)

        want = run(None, None, 128)
        rows = []
        for layout, pk in (("unpacked", None), ("packed", packed)):
            for oname, od in (("own order", None), ("sorted", order)):
                for threads in (32, 64, 128, 256):
                    got = run(pk, od, threads)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, want)
                              if b is not None),
                          f"{label}, {layout}, {oname}, {threads}: bitwise")
                    ms = device_ms(lambda: run(pk, od, threads),
                                   reps if not path else 20)
                    rows.append((ms, layout, oname, threads))
                    print(f"  {label}: {layout:8s} {oname:9s} {threads:4d} "
                          f"threads: {ms:.4f} ms")
        print(f"  {label}: fastest {min(rows)}")

        def call():
            return kernels.trace_leapfrog_zp(coef, grid, o, d, N_STEPS, path,
                                             **kw)

        print(f"  {label}: the wrapper (pack, sort if any, trace) "
              f"{device_ms(call, reps if not path else 20):.4f} ms; by "
              f"kernel: " + "; ".join(
                  f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                      kernel_ms_by_name(call, 3).items(),
                      key=lambda kv: -kv[1])) + f"; on {card}")
    # where the pack and the sort start to pay: the whole call at batches
    # of bench.py's rays
    o_all, d_all = (torch.from_numpy(a).to(dev) for a in bench_rays(262144))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (10000, 128 * sms, 256 * sms, 320 * sms, 384 * sms, 448 * sms,
              512 * sms, 1024 * sms):
        o, d = o_all[:n].contiguous(), d_all[:n].contiguous()
        ways = {
            "unpacked, ray order, 32": lambda: kernels.trace_leapfrog_zp_with(
                coef, grid, o, d, N_STEPS, False, packed=None, order=None,
                threads=32, **kw),
            "packed, ray order, 64": lambda: kernels.trace_leapfrog_zp_with(
                coef, grid, o, d, N_STEPS, False,
                packed=kernels.pack_zp_taps(coef, grid), order=None,
                threads=64, **kw),
            "packed, sorted, 64": lambda: kernels.trace_leapfrog_zp_with(
                coef, grid, o, d, N_STEPS, False,
                packed=kernels.pack_zp_taps(coef, grid),
                order=kernels.ray_order(o, d, grid), threads=64, **kw)}
        print(f"  {n} rays ({n / sms:.0f} an SM), the call with its pack and "
              f"sort: " + "; ".join(f"{k} {device_ms(f, reps):.4f} ms"
                                    for k, f in ways.items()))
    return 0


def k5t_study(reps=20) -> int:
    """``--k5t-study``: the accumulating K5ᵀ's register budget at config
    4's 20,000 endpoints (a plan of ~40,700 used segments of ~8 pairs) and
    at phase 8's dense shapes. The kernel's budget is a constant of its
    source (``K5T_MIN_BLOCKS``, 4 blocks of 256 an SM); the study builds
    the library again with 1 (the compiler's own choice), 3 and 6, and
    times each build's K5ᵀ into one running table, bitwise the default
    build's, beside ``index_add_`` into one. Prints ptxas's registers and
    spills of each build."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import tricubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.testing import edge_case_points

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    budgets = (1, 3, 4, 6)
    libs = {}
    for budget in budgets:
        info = build.build(defines=() if budget == 4 else
                           (f"K5T_MIN_BLOCKS={budget}",))
        libs[budget] = build.open_library(info["path"])
        log = info["log"].splitlines()
        for i, line in enumerate(log):
            if "cubic_value_grad_bwd_kernel" in line:
                print(f"  ptxas, budget {budget}: "
                      + " | ".join(x.strip()[:90] for x in log[i:i + 4]))
    default = build.load()

    def with_lib(budget, fn):
        build._loaded["lib"] = libs[budget]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    rng = np.random.default_rng(8)
    w = configs.config4_world(device=dev)
    geo = tec.DtecGeometry(w.grid, w.rays, w.n_dirs, 0, "hermite", "cubic")
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    cases = [("config 4's endpoints", w.grid, geo.ends)]
    for n_grid, where in ((128, "edge-case"), (256, "random")):
        g = Grid3D.create(origin, spacing, (n_grid,) * 3, device=dev)
        if where == "edge-case":
            pts = edge_case_points((n_grid,) * 3, origin, spacing, 1 << 20,
                                   rng)
        else:
            hi = np.asarray(spacing) * (n_grid - 1)
            pts = (np.asarray(origin) + rng.uniform(0, 1, (1 << 20, 3)) * hi
                   ).astype(np.float32)
        cases.append((f"{where} points of {n_grid}^3", g,
                      torch.from_numpy(pts).to(dev)))
    for label, grid, pts in cases:
        n = pts.shape[0]
        cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)
                              ).to(dev)
        cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)
                              ).to(dev)
        plan = tricubic.endpoint_plan(grid, pts)
        print_plan(f"K5T at {label}", plan)
        table = torch.from_numpy(rng.normal(size=(grid.num_voxels,))
                                 .astype(np.float32)).to(dev).reshape(
            grid.shape[0] * grid.shape[1], grid.shape[2])
        want = kernels.cubic_value_grad_bwd(table.clone(), grid, pts, cv, cg,
                                            plan)
        running = table.clone()
        for budget in budgets:
            got = with_lib(budget, lambda: kernels.cubic_value_grad_bwd(
                table.clone(), grid, pts, cv, cg, plan))
            torch.cuda.synchronize()
            tag = (f"K5T at {label}, register budget {budget} blocks an "
                   f"SM")
            check(bool(torch.equal(got, want)), f"{tag}: bitwise")
            ms = with_lib(budget, lambda: device_ms(
                lambda: kernels.cubic_value_grad_bwd(running, grid, pts, cv,
                                                     cg, plan), reps))
            print(f"  {tag}: {ms:.4f} ms")
        lib = device_ms(index_add_call(*tricubic.value_grad_transpose_terms(
            grid, pts, cv, cg), grid.num_voxels), reps)
        print(f"  index_add_ into a running table at {label}: {lib:.4f} ms")
        del plan, table, running, want, got
        torch.cuda.empty_cache()
    return 0


def serving_endpoints(dev, boxspline, fermat, rays, tec, Grid3D, chapman):
    """Phase 4's first serving epoch: (grid, the prefiltered zp table, the
    1,240 endpoints of its 620 bent rays), the points at which
    ``predict_bent`` evaluates E."""
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    grid = grid_cpu.to(dev)
    r, ants, dirs = serving_epochs()[0]
    m = torch.from_numpy(perturbed_log_field(grid_cpu, r, chapman)).to(dev)
    o, dv = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                                torch.from_numpy(dirs).to(dev))
    rb, _ = fermat.trace_rays(m, grid, o, dv, FREQ_HZ, LENGTH_KM,
                              n_steps=N_STEPS, keep_path=True,
                              method="leapfrog", interp="zp")
    ends, _ = tec._endpoint_tangents(rb.points)
    return grid, boxspline.prefilter(m).reshape(N_GRID * N_GRID, N_GRID), ends


def straight_endpoints(configs, chapman, tec, dev, n_grid):
    """(grid, endpoints) of the 100 x 100 straight rays (65 samples) in the
    n_grid^3 grid enclosing them: config 3b's and config 5's 20,000 at
    128^3 (one geometry: both bundles are ``configs.make_rays(100,
    100)``), config 4's at 256^3."""
    ants, dirs = configs.make_rays(100, 100)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(n_grid,) * 3,
                                       h_min_km=0.0, device=dev)
    rb = configs.straight_bundle(ants, dirs, 65, dev)
    return grid, tec._endpoint_tangents(rb.points)[0]


def e_study(reps=50) -> int:
    """``--e-study``: what binds E, the endpoint value + gradient kernels,
    at the main paths' endpoints: K1e at serving's 1,240 (phase 4's first
    epoch) and at config 3b's and config 5's 20,000; K5 at config 4's
    20,000; E over 8 members at config 5's 20,000, eight launches of K1e
    against one of the batched K1e (over a pack made beforehand, as the
    operator shares K2b's). Each kernel at 32, 64, 128 and 256 threads a
    block (the library built again for each through ``build.build(defines=
    ...)``), in ray order and in endpoint order (the endpoints sorted by
    their stencil's base cell, ``kernels.point_order`` of their row
    set-up: the kernels read them permuted and leave their outputs in that
    order, so the order's reads are timed without the scattered writes an
    ordered kernel would add), every variant bitwise the default build in
    ray order (permuted alike), timed in two passes of opposite order.
    Each shape's bound: the distinct table values its endpoints touch (all
    members for the batched shape), the points read and the outputs
    written once. Prints ptxas's registers of each build."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import (boxspline, triquadratic, tricubic,
                                         zpcubic)
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    sizes = (32, 64, 128, 256)
    names = ("ZP_VALUE_GRAD_THREADS", "ZP_VALUE_GRAD_BATCHED_THREADS",
             "CUBIC_VALUE_GRAD_THREADS")
    libs = {}
    for bs in sizes:
        info = build.build(defines=tuple(f"{n}={bs}" for n in names))
        libs[bs] = build.open_library(info["path"])
        for kern, regs in ptxas_lines(info["log"], ("zp_value_grad_kernel",
                                                    "zp_value_grad_batched",
                                                    "cubic_value_grad_kernel")):
            print(f"  ptxas, {bs} threads: {kern}: {regs}")
    default = build.load()

    def with_lib(bs, fn):
        build._loaded["lib"] = libs[bs]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    rng = np.random.default_rng(9)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    grid_s, coef_s, ends_s = serving_endpoints(dev, boxspline, fermat, rays,
                                               tec, Grid3D, chapman)
    grid5, ends5 = straight_endpoints(configs, chapman, tec, dev, N_GRID)
    grid4, ends4 = straight_endpoints(configs, chapman, tec, dev, 256)
    tables5 = rand(B_MEMBERS, grid5.shape[0] * grid5.shape[1],
                   grid5.shape[2])
    packed5 = kernels.pack_members(tables5.view(B_MEMBERS, -1))
    field4 = rand(grid4.shape[0] * grid4.shape[1], grid4.shape[2])

    def perm_of(model, grid, pts):
        ri, _, zi, _ = model.row_setup(grid, pts)
        return kernels.point_order(ri, zi, model.BASE_TRANSLATE,
                                   grid.shape).long()

    def k1e(coef, grid):
        return lambda pts: kernels.zp_value_grad(coef, grid, pts)

    def looped(pts):
        return [t for b in range(B_MEMBERS)
                for t in kernels.zp_value_grad(tables5[b], grid5, pts)]

    def batched(pts):
        return kernels.zp_value_grad_batched(tables5, grid5, pts, packed5)

    cases = [
        ("K1e at serving's endpoints", k1e(coef_s, grid_s), ends_s,
         boxspline, grid_s, k1e_bound(boxspline, grid_s, ends_s)),
        ("K1e at config 3b's and 5's endpoints", k1e(tables5[0], grid5),
         ends5, boxspline, grid5, k1e_bound(boxspline, grid5, ends5)),
        ("K5 at config 4's endpoints",
         lambda pts: kernels.cubic_value_grad(field4, grid4, pts), ends4,
         tricubic, grid4, k5_bound(tricubic, grid4, ends4)),
        (f"{B_MEMBERS} x K1e at config 5's endpoints", looped, ends5,
         boxspline, grid5,
         k1e_bound(boxspline, grid5, ends5, members=B_MEMBERS)),
        (f"the batched K1e, {B_MEMBERS} members, at config 5's endpoints",
         batched, ends5, boxspline, grid5,
         k1e_bound(boxspline, grid5, ends5, members=B_MEMBERS)),
    ]
    for label, fn, pts, model, grid, (b_ms, b_by) in cases:
        n, perm = pts.shape[0], perm_of(model, grid, pts)
        orders = {"ray order": pts, "endpoint order": pts[perm].contiguous()}
        want = [t.clone() for t in _outputs(fn(pts))]
        torch.cuda.synchronize()
        print(f"  {label} ({pts.shape[0]} points): bound {b_ms:.6f} ms "
              f"({b_by})")
        times = {}
        for pass_ in (sizes, sizes[::-1]):
            for bs in pass_:
                for order, p in orders.items():
                    got = with_lib(bs, lambda: _outputs(fn(p)))
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, w if order == "ray order"
                                          else w[perm] if w.shape[0] == n
                                          else w[:, perm])
                              for a, w in zip(got, want)),
                          f"{label}, {bs} threads, {order}: bitwise the "
                          f"default build in ray order")
                    times.setdefault((bs, order), []).append(with_lib(
                        bs, lambda: device_ms(lambda: fn(p), reps)))
        for (bs, order), t in sorted(times.items()):
            print(f"  {label}, {bs} threads a block, {order}: "
                  f"{', '.join(f'{x:.4f}' for x in t)} ms")
    return 0


def ptxas_lines(log, fragments):
    """(kernel, "Used ... registers ...") of each kernel in an nvcc -Xptxas
    -v log whose mangled name holds one of ``fragments``; the kernel named
    by the fragment and its template arguments."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            hit = [f for f in fragments if f in mangled]
            name = (hit[0] + mangled.split(hit[0])[1][:12]) if hit else None
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split(":", 1)[1].strip()))
            name = None
    return out


def member_study(reps=10) -> int:
    """``--member-study``: what K2b's and K3b's calls spend, kernel by
    kernel, at config 5's two bundles and the zp edge-case points (8
    members), and both built six more ways through ``build.build(defines=
    ...)``: K3b's scan without its cut-off at the longest run
    (``K3B_FULL_SCAN``: all five steps, as K3 takes them), its fold with 8
    or 32 rows a block (``K3B_FOLD_ROWS``, 1 by default) or in blocks of
    128 threads (``K3B_FOLD_THREADS``, 256 by default), its reduce's
    registers set for 4 blocks an SM (``K3B_MIN_BLOCKS``), and K2b's
    gather's for 3 (``K2B_MIN_BLOCKS``; the defaults leave the compiler
    its choice); each build's K2b and K3b bitwise the default build's.
    Prints ptxas's registers of the member kernels."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import boxspline
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.testing import edge_case_points

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    variants = {"default": (), "full scan": ("K3B_FULL_SCAN=1",),
                "fold 8 rows a block": ("K3B_FOLD_ROWS=8",),
                "fold 32 rows a block": ("K3B_FOLD_ROWS=32",),
                "fold 128 threads": ("K3B_FOLD_THREADS=128",),
                "reduce 4 blocks": ("K3B_MIN_BLOCKS=4",),
                "gather 3 blocks": ("K2B_MIN_BLOCKS=3",)}
    libs = {}
    for label, defines in variants.items():
        info = build.build(defines=defines)
        libs[label] = build.open_library(info["path"])
        for name, used in ptxas_lines(info["log"], (
                "rows_value_bwd_batched_kernel", "fold_member_rows_kernel",
                "rows_value_fwd_batched_kernel", "pack_members_kernel")):
            print(f"  ptxas, {label}: {name}: {used}")
    default = build.load()

    def with_lib(label, fn):
        build._loaded["lib"] = libs[label]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    rng = np.random.default_rng(12)
    w = configs.config5_world(device=dev)
    nx, ny, nz = w.grid.shape
    cases = []
    for name, rb in (("outer bundle", w.rays), ("inner bundle",
                                                w.rays_inner)):
        geo = tec.DtecGeometry(w.grid, rb, w.n_dirs, 0, "hermite", "zp")
        cases.append((f"config 5's {name}", (geo.ri, geo.wxy, geo.zi,
                                             geo.wz), geo.row_plan, nx * ny,
                      nz))
    shape = (N_GRID,) * 3
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    pts = torch.from_numpy(edge_case_points(shape, origin, spacing, 1 << 20,
                                            rng)).to(dev)
    setup = boxspline.row_setup(grid, pts)
    cases.append(("the zp edge-case points", setup,
                  boxspline.row_plan(setup[0], setup[2], N_GRID * N_GRID),
                  N_GRID * N_GRID, N_GRID))
    b = B_MEMBERS
    for label, (ri, wxy, zi, wz), plan, n_rows, nz_ in cases:
        print_plan(f"K3b at {label}", plan)
        tables = torch.from_numpy(rng.normal(size=(b, n_rows, nz_))
                                  .astype(np.float32)).to(dev)
        ct = torch.from_numpy(rng.normal(size=(b, ri.shape[0]))
                              .astype(np.float32)).to(dev)
        calls = {
            "K2b": lambda: kernels.rows_value_fwd_batched(tables, ri, wxy,
                                                          zi, wz, True),
            "K3b": lambda: kernels.rows_value_bwd_batched(ct, plan, wxy, zi,
                                                          wz, nz_)}
        for name, fn in calls.items():
            by = kernel_ms_by_name(fn, reps)
            print(f"  {name} at {label}: the call {device_ms(fn, reps):.4f} "
                  f"ms; by kernel: " + "; ".join(
                      f"{v:.4f} ms {k[:48]}" for k, v in
                      sorted(by.items(), key=lambda kv: -kv[1])))
            want = fn()
            for variant in variants:
                got = with_lib(variant, fn)
                torch.cuda.synchronize()
                check(bool(torch.equal(got, want)),
                      f"{name} at {label}, {variant}: bitwise the default "
                      f"build")
                ms = with_lib(variant, lambda: device_ms(fn, reps))
                print(f"  {name} at {label}, {variant}: {ms:.4f} ms")
            del want, got
        del tables, ct
        torch.cuda.empty_cache()
    return 0


def plain_solves(n, root=None) -> int:
    """``--plain-solves N [--root DIR]``: config 4's solve once on the
    kernels and N times on the plain versions (``dtec_paired_linear_ref``,
    phase 10's schedule at full size) for the package found at ``root``
    (default: beside this script); each final residual and held-out dTEC
    rms to full precision, and how many distinct plain results there
    were. Run for two checkouts to see whether a plain result that strays
    is new."""
    if root is not None:
        sys.path.insert(0, str(Path(root).resolve()))
    import ionotomo_tpu_torch
    from ionotomo_tpu_torch import configs
    from ionotomo_tpu_torch.forward import tec

    dev = torch.device("cuda", 0)
    w = configs.config4_world(device=dev)

    def solve(**kw):
        res = configs.config4_solve(w, **kw)
        torch.cuda.synchronize()
        return (float(res.residual_norm),
                configs.heldout_dtec_rms(res.m, w.grid, *w.heldout))

    print(f"plain solves, package {Path(ionotomo_tpu_torch.__file__).parent}"
          f" on {card_line()}")
    print(f"  kernel solve: residual, held-out rms {solve()!r}")
    got = []
    for i in range(n):
        got.append(solve(linearize=tec.dtec_paired_linear_ref))
        print(f"  plain solve {i}: residual, held-out rms {got[-1]!r}")
    res = [r for r, _ in got]
    print(f"  {n} plain solves: {len(set(got))} distinct results; residual "
          f"least {min(res)!r}, greatest {max(res)!r}")
    return 0


def kernels_line(results) -> dict:
    """The per-kernel JSON object of a run from the phases' results."""
    from ionotomo_tpu_torch.testing import MEMBER_KERNELS
    src = "ionotomo_tpu_torch/kernels/csrc/"
    # launches: K1, K1e and K2 in the serving run (phase 4; K1e's
    # launches on every main path beside it in "launches_by_path": one
    # config-3b solve, config 5's 30 chunked steps, 6 ensemble steps),
    # K1's pack in one trace of bench.py's batch (phase 3), K3
    # and K1eᵀ in the config-3b solve (phase 6), KG in the probe (phase 7),
    # K1c and the pack and key kernels it launches in config 2 (phase 9),
    # K5, K5ᵀ, the point order's keys and its permute in config 4 (phase
    # 10; both per main path in "launches_by_path": one config-3b solve,
    # config 4's run, config 5's entry point (two runs of 30 steps, the
    # geometries built), 30 steps over built geometries, 6 ensemble
    # steps). Error, ms
    # and bound: K1's call at the bench shape (262144 rays x 64 steps: the
    # pack, the sort and the tracer), K1's pack of the 128^3 table (phase
    # 2), the point order's keys and its permute at config 4's 650,000
    # points (library_ms of the permute: index_select; "at" holds both at
    # config 3b's 650,000 zp points, phase 6); K1e at the
    # config-3b solve's 20,000 endpoints (phase 6; "at" holds it at
    # serving's endpoints, config 5's and phase 2's edge-case points); K2
    # (over the geometry's point order), K3 and K1eᵀ
    # at the config-3b solve's shapes (650,000 points, 20,000 endpoints);
    # KG at (16384, 128), its bound from the distinct table values
    # its indices touch ("l2_cleared_ms": with the L2 cleared before each
    # launch; "at" the (8, 128) control); K1c at
    # config 2's saturated batch (262144 rays x 128 steps: the call, the
    # sort, the pack and the tracer; the pack and the keys alone beside
    # it); K5 and K5ᵀ at
    # config 4's 20,000 endpoints. library_ms: index_add_ of the
    # precomputed contributions for the scatters, torch.gather for KG.
    # "kernels_at_config4" holds K2 and K3 again at config 4's two cubic
    # shapes, and K4, which is K3 on the cubic row plan, with the launches
    # of config 4's run. K2b and K3b: launches in one run of the ensemble
    # filter (phase 13), error, ms (the whole call: K2b's pack, K3b's pack
    # and fold included) and bound at config 5's outer bundle (650,000
    # points, 8 members; phase 11), the batched K1e at its 20,000
    # endpoints (over a pack made beforehand, as K2b's is shared); the
    # pack (of the 8 tables) and the fold
    # (of random partial rows over that bundle's plan) alone there, with
    # their launches in the same run; "kernels_at_member_shapes" holds K2b
    # and K3b at phase 11's other shapes, each beside the unbatched
    # kernel's ms on one member. K6z and K6zᵀ: launches in one config-4
    # solve with the zpc2 inner Jacobian, error, ms and bound at its 20,000
    # endpoints (K6zᵀ adding into a K3 table; library_ms: index_add_ into
    # a running table), "at" phase 2's edge-case and random points; K6q:
    # launches in the rk4 trace on quadratic at the bench's batch, error,
    # ms and bound at that trace's points halfway, "at" phase 2's points;
    # K1z and K1q: launches in one trace of the bench's batch, error (8192
    # rays, phase 2), ms and bound of the call (pack, sort and trace) at
    # the bench's batch. "kernels_at_config4" holds K2 at zpc's (8, 4)
    # shape at the solve's two bundles, with its launches in one
    # zpc2-inner solve.
    c4 = results["config4_launches"]
    launches = {**results["launches"],
                **{k: results["solve_launches"][k]
                   for k in ("rows_value_bwd", "zp_value_grad_bwd")},
                "vector_gather": results["vector_gather"]["launches"],
                **{k: results[k]["launches"] for k in CONFIG2_KERNELS},
                "cubic_value_grad": c4["cubic_value_grad"],
                "cubic_value_grad_bwd": c4["cubic_value_grad_bwd"],
                "point_order_keys": c4["point_order_keys"],
                "permute_points": c4["permute_points"],
                "pack_zp_taps": results["bench_launches"]["pack_zp_taps"],
                **{k: results["enkf_launches"][k] for k in MEMBER_KERNELS},
                **{k: results["config4_zpc2_launches"][k]
                   for k in ("zpc_value_grad", "zpc_value_grad_bwd")},
                **{k: results[k]["launches"]
                   for k in ("quad_value_grad", "trace_leapfrog_zpc",
                             "trace_leapfrog_quad")}}
    entries = [
        ("trace_leapfrog_zp", "trace_leapfrog_zp.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("zp_value_grad", "zp_value_grad.cu",
         "ionotomo_tpu/core/boxspline.py:253"),
        ("zp_value_grad_batched", "zp_value_grad.cu",
         "ionotomo_tpu/core/boxspline.py:253"),
        ("rows_value_fwd", "rows_value_fwd.cu",
         "ionotomo_tpu/core/tricubic.py:284"),
        ("rows_value_bwd", "rows_value_bwd.cu",
         "ionotomo_tpu/core/tricubic.py:377"),
        ("zp_value_grad_bwd", "zp_value_grad_bwd.cu",
         "ionotomo_tpu/core/boxspline.py:253"),
        ("vector_gather", "vector_gather.cu", "bench/probe_gather.py:21"),
        ("trace_leapfrog_cubic", "trace_leapfrog_cubic.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("pack_z_taps", "trace_leapfrog_cubic.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("ray_order_keys", "trace_leapfrog_cubic.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("cubic_value_grad", "cubic_value_grad.cu",
         "ionotomo_tpu/core/tricubic.py:529"),
        ("cubic_value_grad_bwd", "cubic_value_grad_bwd.cu",
         "ionotomo_tpu/core/tricubic.py:529"),
        ("rows_value_fwd_batched", "rows_value_fwd_batched.cu",
         "ionotomo_tpu/core/tricubic.py:296"),
        ("rows_value_bwd_batched", "rows_value_bwd_batched.cu",
         "ionotomo_tpu/core/tricubic.py:380"),
        ("pack_members", "rows_value_fwd_batched.cu",
         "ionotomo_tpu/core/tricubic.py:296"),
        ("fold_member_rows", "rows_value_bwd_batched.cu",
         "ionotomo_tpu/core/tricubic.py:380"),
        ("point_order_keys", "rows_value_fwd.cu",
         "ionotomo_tpu/core/tricubic.py:284"),
        ("permute_points", "rows_value_fwd.cu",
         "ionotomo_tpu/core/tricubic.py:284"),
        ("pack_zp_taps", "trace_leapfrog_zp.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("zpc_value_grad", "zpc_value_grad.cu",
         "ionotomo_tpu/core/zpcubic.py:108"),
        ("zpc_value_grad_bwd", "zpc_value_grad_bwd.cu",
         "ionotomo_tpu/core/zpcubic.py:108"),
        ("quad_value_grad", "quad_value_grad.cu",
         "ionotomo_tpu/core/triquadratic.py:173"),
        ("trace_leapfrog_zpc", "trace_leapfrog_zpc.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
        ("trace_leapfrog_quad", "trace_leapfrog_quad.cu",
         "ionotomo_tpu/geometry/fermat.py:204"),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def entry(name, f, rep, n, line):
        return {"name": name, "route": "cuda", "source": src + f,
                "replaces": rep, "launches": n, **{k: line[k] for k in keys}}

    at4 = []
    for label, line in results["at_config4"].items():
        name = label.split("@")[0]
        if name == "tec_linear_adjoint":
            at4.append({**entry(name, "rows_value_bwd.cu",
                                "ionotomo_tpu/forward/tec.py:379",
                                c4["rows_value_bwd"], line),
                        "through": "rows_value_bwd"})
        else:
            rep = {"rows_value_fwd": "ionotomo_tpu/core/tricubic.py:284",
                   "rows_value_bwd": "ionotomo_tpu/core/tricubic.py:377"}
            # K2 at zpc's shape: its launches in one zpc2-inner solve
            runs = results["config4_zpc2_launches"] if "@zpc" in label else c4
            at4.append({**entry(name, name + ".cu", rep[name], runs[name],
                                line), "shape": label})
    reps = {name: (f, rep) for name, f, rep in entries}
    k1e = {**entry("zp_value_grad", *reps["zp_value_grad"],
                   launches["zp_value_grad"], results["zp_value_grad"]["line"]),
           "launches_by_path": {
               "serving": results["launches"]["zp_value_grad"],
               "config3b_solve": results["solve_launches"]["zp_value_grad"],
               "config5_30_steps":
                   results["config5_run_launches"]["zp_value_grad"],
               "enkf_6_steps": results["enkf_launches"]["zp_value_grad"],
               "enkf_6_steps_batched":
                   results["enkf_launches"]["zp_value_grad_batched"]},
           "at": {k: results[k] for k in ("k1e_serving", "k1e_config5",
                                          "k1e_edge")}}
    members = [{**entry(name, *reps[name], launches[name], line),
                "shape": shape, "members": B_MEMBERS,
                "unbatched_ms": line["unbatched_ms"]}
               for shape, lines in results["at_member_shapes"].items()
               for name, line in lines.items()]
    by_path = {name: {"config3b_solve": results["solve_launches"][name],
                      "config4": c4[name],
                      "config5_entry": results["config5_launches"][name],
                      "config5_30_steps":
                          results["config5_run_launches"][name],
                      "enkf_6_steps": results["enkf_launches"][name]}
               for name in ("point_order_keys", "permute_points")}
    extra = {
        "zp_value_grad": k1e,
        **{name: {**entry(name, *reps[name], launches[name],
                          results[name]["line"]),
                  "at": results[name + "_at"]}
           for name in ("zpc_value_grad", "zpc_value_grad_bwd",
                        "quad_value_grad")},
        "vector_gather": {
            **entry("vector_gather", *reps["vector_gather"],
                    launches["vector_gather"],
                    results["vector_gather"]["line"]),
            "l2_cleared_ms": results["vector_gather"]["line"]
            ["l2_cleared_ms"],
            "at": {"control_8x128": results["vector_gather_control"]}},
        **{name: {**entry(name, *reps[name], launches[name],
                          results[name]["line"]),
                  "launches_by_path": by_path[name],
                  "at": {"zp_650000": results[name + "_zp"]["line"]}}
           for name in by_path},
    }
    return {"kernels": [extra[name] if name in extra else
                        entry(name, f, rep, launches[name],
                              results[name]["line"])
                        for name, f, rep in entries],
            "kernels_at_config4": at4, "kernels_at_member_shapes": members}


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    parent_dir = args[args.index("--parent") + 1] if "--parent" in args \
        else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if "--e-study" in args:
        return e_study()
    if "--k1c-study" in args:
        return k1c_study()
    if "--k5t-study" in args:
        return k5t_study()
    if "--member-study" in args:
        return member_study()
    if "--k2-study" in args:
        return k2_study()
    if "--gather-study" in args:
        return gather_study()
    if "--k1-study" in args:
        return k1_study()
    root = args[args.index("--root") + 1] if "--root" in args else None
    if "--serving-loop" in args:
        return serving_loop(root)
    if "--plain-solves" in args:
        return plain_solves(int(args[args.index("--plain-solves") + 1]), root)

    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import (boxspline, triquadratic, tricubic,
                                         zpcubic)
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
        print("  no --parent DIR: no phase holds a kernel to the parent's")
    results = {}
    phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results, parent)
    phase2_new_models(dev, tricubic, zpcubic, triquadratic, fermat, kernels,
                      Grid3D, chapman, results)
    phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card, parent)
    phase3_new_tracers(dev, fermat, kernels, Grid3D, chapman, results, card)
    phase4_serving(dev, boxspline, fermat, rays, tec, kernels, Grid3D, chapman,
                   results, profile, parent)
    phase5_adjoint_kernels(dev, boxspline, tricubic, kernels, Grid3D,
                           results, parent)
    phase6_solve(dev, boxspline, tricubic, fermat, rays, tec, kernels,
                 chapman, priors, solvers, results, profile, parent)
    phase7_probe(dev, gather, kernels, results, parent)
    phase8_cubic_kernels(dev, tricubic, fermat, rays, tec, kernels, Grid3D,
                         chapman, results, parent)
    phase9_config2(dev, fermat, rays, kernels, Grid3D, chapman, configs,
                   results, card, parent=parent)
    phase10_config4(dev, tricubic, rays, tec, kernels, configs, results,
                    profile, parent)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world5 = configs.config5_world(device=dev)
    torch.cuda.synchronize()
    print(f"config 5's world (30 epochs of 10,000 bent rays at 128 steps "
          f"through the drifting analytic world): set-up "
          f"{time.perf_counter() - t0:.2f} s")
    phase11_member_kernels(dev, world5, boxspline, tricubic, tec, kernels,
                           Grid3D, results, parent)
    cache5 = phase12_config5(dev, world5, boxspline, tricubic, tec, kernels,
                             configs, results, profile, parent=parent)
    phase13_enkf(dev, world5, cache5, boxspline, tricubic, tec, kernels,
                 configs, results, profile, parent=parent)

    line = kernels_line(results)
    solve, c2, c4 = results["solve"], results["config2"], results["config4"]
    print(f"rays/s: kernel {results['rays_per_s']['kernel']:.1f}, plain "
          f"{results['rays_per_s']['plain']:.1f}; serving "
          f"{results['ms_per_epoch']:.3f} ms/epoch; config-3b solve "
          f"{min(solve['seconds']):.4f} s (plain {solve['plain_seconds']:.4f} "
          f"s)")
    print(f"cubic: config 2 {c2['bent_rays_per_sec_saturated']:.1f} rays/s "
          f"saturated, {c2['bent_rays_per_sec_6200']:.1f} at "
          f"{c2['rays_6200']} rays (leapfrog@128), "
          f"{c2['rays_per_s_leapfrog64']:.1f} at leapfrog@64; config 4 solve "
          f"{min(c4['seconds']):.4f} s (plain {c4['plain_seconds']:.4f} s), "
          f"held-out dTEC rms {c4['prior_heldout']:.4f} -> "
          f"{c4['heldout']:.4f}")
    rz, c4z = results["rays_per_s"], results["config4_zpc2"]
    print(f"zpc and quadratic: bench trace (leapfrog@64) {rz['zpc']:.1f} and "
          f"{rz['quadratic']:.1f} rays/s (zp {rz['kernel']:.1f}, cubic "
          f"{c2['rays_per_s_leapfrog64']:.1f}); config 4 with the zpc2 "
          f"inner Jacobian {min(c4z['seconds']):.4f} s (plain "
          f"{c4z['plain_seconds']:.4f} s), held-out dTEC rms "
          f"{c4z['prior_heldout']:.4f} -> {c4z['heldout']:.4f}")
    c5, e5 = results["config5"], results["config5_enkf"]
    print(f"config 5: {c5['steps']} filter steps in "
          f"{min(c5['seconds']):.4f} s ({c5['steps'] / min(c5['seconds']):.2f}"
          f" steps/s), held-out dTEC rms {c5['heldout_dtec_rms_prior']:.4f} "
          f"-> {c5['heldout_dtec_rms_post']:.4f}; ensemble step of "
          f"{B_MEMBERS} members {e5['seconds_per_step']:.4f} s against "
          f"{B_MEMBERS} x {e5['point_seconds_per_step']:.4f} s")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
