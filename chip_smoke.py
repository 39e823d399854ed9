"""Drive the PyTorch/CUDA port's bent-ray forward paths (leapfrog, rk4, the
split-field and the stochastic beam trace), its MAP inversion paths on the
zp and the tricubic field model, its time-evolving path (the frozen-flow
Kalman filter and the ensemble filter), its streaming service
(``serving.EpochService``), its batch inversion
(``inversion.pipeline.InversionPipeline``), its forward prediction with
Faraday rotation (``predict``) and its multi-device layer (``parallel/``,
its shards in turn on the card), on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also: device time by kernel of
                                       # one serving epoch, one
                                       # Gauss-Newton step (and its host
                                       # time by op), one config-4 solve
                                       # (cubic, and with the zpc2 inner
                                       # Jacobian), one filter step and one
                                       # ensemble
                                       # step (torch.profiler)
    python3 chip_smoke.py --service    # only: the build and phase 15, the
                                       # streaming service
    python3 chip_smoke.py --invert     # only: the build and phase 16, the
                                       # batch inversion (with --profile:
                                       # one snapshot solve profiled;
                                       # --parent DIR as below)
    python3 chip_smoke.py --predict    # only: the build and phase 17,
                                       # predict (with --profile: one
                                       # timestep of each form profiled)
    python3 chip_smoke.py --sharded    # only: the build and phase 18, the
                                       # multi-device layer (with
                                       # --depth-study: the profile
                                       # estimate and GCV on the ray mesh
                                       # by depth of CG, against data
                                       # moved by 1e-7)
    python3 chip_smoke.py --theta-study
                                       # only: phase 16's estimate_profile
                                       # solve by depth of CG and of
                                       # Gauss-Newton, on the card, the
                                       # CPU, and the CPU in float64
    python3 chip_smoke.py --parent DIR # also: hold the kernels to those of
                                       # the checkout at DIR (the commit
                                       # before K3b's fold and the batched
                                       # K1e were redesigned; any other
                                       # sources are refused): every
                                       # kernel bitwise at
                                       # the phases' shapes and timed in
                                       # turns; config 4's solves (all
                                       # cubic and zpc2 inner), config 5's
                                       # first chunk and the ensemble
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
                                       # the batched K1e), K6z beside
                                       # its launch floor at 1 to 2^20
                                       # points, and K6q beside its
                                       # launch floor at 1,240 to 2^20
                                       # (with --parent DIR: in turns
                                       # with the parent's)
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
    python3 chip_smoke.py --k6zt-study # only: what binds K6zT at config
                                       # 4's endpoints and the edge-case
                                       # points (the plan's shape, the
                                       # first design, a task a segment,
                                       # the task list, beside
                                       # index_add_; a library each)
    python3 chip_smoke.py --rk4-study  # only: what binds K1r on the four
                                       # models at the bench's batch (how
                                       # often rk4's stages share a cell;
                                       # block size, register budget: a
                                       # library each) and K1s's rk4
                                       # under each build
    python3 chip_smoke.py --k1zq-study [--parent DIR]
                                       # only: what binds K1z, K1q and
                                       # K1s at the bench's batch
                                       # (registers, the SASS of a step
                                       # and its issue-slot bound, beside
                                       # every tracer's; register budget
                                       # and block size: a library a
                                       # budget; the call's pieces and
                                       # where sorting pays; with DIR the
                                       # parent's launch)
    python3 chip_smoke.py --member-study [--parent DIR]
                                       # only: K2b's and K3b's calls by
                                       # kernel at config 5's bundles and
                                       # the zp edge-case points, both
                                       # built with other scan and
                                       # register settings; K3b's fold by
                                       # its grid; the batched K1e by
                                       # lanes a point, block size and
                                       # translate form at 1,240, 20,000
                                       # and 917,504 points, beside its
                                       # launch floor (with DIR: the
                                       # parent's fold and K1e in turns)
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
   over K1's pack), rays/s beside K1's, each also one ray below its own
   threshold (the table as it is) and at it (sorted and packed), path on
   and off, bitwise the unpacked kernel and the parent's call; and K6q
   timed at the bench trace's points halfway.
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
   versions, with their bounds (the fold over the z spans K3b's reduce
   writes there; with ``--parent`` the fold alone at every shape, bitwise
   the parent's and in turns). The batched K1e (E over 8 members, one
   launch) at 1,240 and 20,000 of config 5's endpoints and at the zp
   edge-case points: every member bitwise K1e on that member, within
   1e-5·max of the plain version, beside 8 launches of K1e and its
   bound.
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

14. The tracers the port took last, at ``bench.py``'s configuration (a
   128³ Chapman + perturbation world, 262,144 rays, 150 MHz, 1000 km, no
   path): on zp, cubic, zpc and quadratic, rk4@64 through ``trace_rays``
   launches K1r once and no K1e, K5, K6z or K6q, agrees with the
   per-stage route it replaces (``_trace_impl`` over ``field_evaluator``,
   with ``--parent`` on the parent's kernels) and with the plain tracer
   on 8192 rays, path on and off (1e-3 km, 1e-5 relative TEC), is
   bitwise the unpacked kernel in ray order, path on and off, and is
   timed (the call by kernel, the plain version, the bound at 4
   evaluations a step, and the per-stage route against K1r in turns on
   the host clock, with the route's launches and device time; with
   ``--parent`` bitwise the parent's K1r and timed in turns with its own
   call, 64 rays a block on zp, zpc and quadratic). The split tracer K1s at
   leapfrog@32 and rk4@64 with a single-layer background: launched once
   with its pack and sort, bitwise the unpacked kernel, timed beside the
   full-field cubic call; single-layer and 3 layers + curved Earth +
   plasmasphere against ``trace_rays_split_ref`` on 8192 rays. The beam
   noise of phase 4's first epoch (62 × 10 rays × 8 paths on zp,
   leapfrog@64): one K1 call, against the plain route on CPU tensors,
   bitwise a per-path loop of K1, timed beside phase 4's epoch.
   ``calc_rays(straight_line_approx=False)`` at that geometry: K1c with
   its path against the plain tracer.
15. The streaming service (``serving.EpochService``) at
   ``EngineConfig``'s defaults (128³, cubic, Hermite, 129 samples, cg 40,
   the point filter) with adaptive R (α 0.3) over a stream of 110
   one-epoch files from ``data.synth`` at its defaults (62 antennas × 10
   directions, 30 s cadence, 150 MHz), each file arriving before a poll
   of ``process_available``. The card's machine has no h5py, so the files
   are held in memory (``service_class``: placeholders in the watch
   directory, DataPacks by name, each Solution kept as its SHA-256); the
   state file and the JSONL records are the service's own. The epoch
   latency (the service's own seconds and the host clock around each
   poll; median, p90 and max after 5 warm-up epochs), rays/s, the
   geometry an epoch builds, one profiled epoch (launches, device busy
   time and share, top kernels); the path's kernels
   (``testing.SERVICE_KERNELS``) must have launched; held-out dTEC rms
   (62 antennas toward 2 other directions) at the last epoch below the
   prior's; the stream split at half and resumed by a new service gives
   every Solution's SHA-256; the first 3 epochs within 1 % of the same
   service on the CPU (the plain versions) in field update and held-out
   rms; an 8-member ensemble service over 6 epochs bitwise across a
   restart at 3; one epoch with beam noise (8 paths, K1c) and the
   spectrum diagnostic (K2b, K3b), a sounding file, then another epoch;
   three epochs with ``interp="zp"`` (K1e, K1eᵀ).
16. The batch inversion (``InversionPipeline``) at full width: ``data.
   synth``'s defaults over 8 timesteps, built in memory (no h5py there),
   on ``EngineConfig``'s 128³ grid with the ``invert`` CLI's defaults
   (map_gauss_newton, gn 2, cg 40, cubic, Hermite@129, von Kármán 80
   km). The default snapshot mode over the 8 timesteps (seconds a
   timestep, rays/s, residual, held-out dTEC rms over 20 of the array's
   antennas toward 50 other directions against the prior's at every
   timestep; K2, K3, K5, K5ᵀ and the point order must have launched),
   then each other mode once (robust_gn, steepest, lsqr_smoothness,
   batched_gn on 4 timesteps, kalman in 2 chunks, enkf with 8 members on
   4, posterior_samples=8, bent with retrace_every 1, beam noise of 8
   paths, the GCV and evidence prior selection, estimate_profile with
   slant anchors of the truth), each finite and below the prior's
   held-out rms, each launching its kernels; kill and resume after
   timestep 4 of 8 in the snapshot and Kalman modes with the Solution's
   SHA-256 equal; one snapshot solve on the card against the same solve
   on the CPU, with K2 and K3 rounded to bfloat16 as controls; K2b with
   its pack and K3b with its fold at B = 8 over the snapshot geometry's
   79,980 points against their plain versions (``kernels_at_invert``).
17. ``predict`` (``__main__.predict``, what the CLI's ``predict`` runs
   between its file reads and writes) at its defaults (cubic,
   Hermite@129, 1000 km) on phase 16's world and the 128³ Solution of a
   snapshot ``InversionPipeline`` run over it at the ``invert`` CLI's
   defaults, in memory, in four forms (``testing.PREDICT_FORMS``):
   straight; straight with RM; bent at leapfrog@64 with RM; bent on zp
   with RM. Each: the host clock a timestep (3 calls of 8 timesteps after
   a warm-up), rays/s, launches a timestep (its kernels must have
   launched), finite, the dRM's reference-antenna row exactly 0, two
   calls bitwise equal; the straight residual rms below 0.6 × the
   observed, bent within 5 % of max|dTEC| of straight; the card against
   the CPU on 2 timesteps (dTEC within 1e-4·max|dTEC|, RM per ray within
   1e-4·max|RM|) with K2 rounded to bfloat16 as a control that both
   readings must catch. The sky screens on a 62 × 40 synth DataPack on
   64³ (hyperparameters fitted on 30 directions at 150 steps, the 10
   held out below 0.8 × the per-antenna mean's error, two runs bitwise,
   card against CPU: means within 1e-3·max|dTEC|, hyperparameters 1e-3
   relative); the structure function of the predicted phases (β > 0);
   ``checked`` on the card (a NaN raises; a checked timestep bitwise the
   unchecked); with ``--profile`` one timestep of each form profiled;
   K2 in ray order at the straight (79,980) and bent (40,300) bundles'
   points, K5 at the 1,240 endpoints and K1c with its path at 620 rays ×
   64 steps against their plain versions (``kernels_at_predict``).
18. The multi-device layer with S shards in turn on the one card
   (``phase18_sharded``; arithmetic, not a multi-card speed): K7 and K7ᵀ
   over 8 x-shards at config 4's world, 917,504 edge-case points and 2²⁰
   points of 512³ (K7 summed bitwise K5, K7ᵀ bitwise its plain version,
   the halo exchange exact; ``kernels_at_sharded``), the sharded-grid
   J/Jᵀ and LSQR (K7's main path, its launches), ``trace_rays_sharded``
   bitwise the integrator over K5, the ray mesh's snapshot solve and
   filter chunk, ``member_parallel_enkf`` over 2 and 8 groups, the
   pipeline with ``mesh=``.

With ``--parent``, KG at both of phase 7's shapes and the permute at
phases 6 and 10 are bitwise the parent's and timed in turns with it, as
are K1e at every shape above, K5 at phases 8 and 10, the batched K1e,
K1z and K1q at phases 2 and 3 (at 262,144 rays and on either side of each
one's threshold), K6zT at phase 2's points and config 4's endpoints, and
K1r and K1s at phase 14.

The last lines are a JSON object of per-kernel results (each kernel's
bound: the larger of the bytes it must move over 3.35 TB/s and its f32
operations over 67 TFLOP/s, from this run's inputs), the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero at once, before any build.
"""
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib
import json
import shutil
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


@contextlib.contextmanager
def card_clocks(label):
    """The card's SM and memory clocks [MHz], temperature [°C] and power
    draw [W], sampled by nvidia-smi every 100 ms while the body runs; the
    least, median and greatest of each printed ("not measured" where
    nvidia-smi gave no sample). The sampler is stopped on the way out."""
    keys = ("clocks.sm", "clocks.mem", "temperature.gpu", "power.draw")
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader,nounits", "--id=0", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        proc = None
    try:
        yield
    finally:
        text = ""
        if proc is not None:
            proc.terminate()
            try:
                text = proc.communicate(timeout=10)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                text = proc.communicate()[0]
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        rows = [r for r in rows if len(r) == len(keys)]
        if not rows:
            print(f"  card clocks during {label}: not measured")
        else:
            cols = np.array(rows).T
            print(f"  card clocks during {label} ({len(rows)} samples, "
                  f"least/median/greatest): " + "; ".join(
                      f"{k} {c.min():g}/{np.median(c):g}/{c.max():g}"
                      for k, c in zip(keys, cols)))


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


class Timing(float):
    """A time in ms that says how it was taken, in ``by``: "profiler" (the
    durations of the kernels in a torch.profiler trace: device time),
    "cuda_events" (CUDA events around the calls: the gaps between
    launches included, an upper bound on device time) or "host_clock"
    (the host's clock around synchronised calls)."""

    def __new__(cls, ms, by: str):
        t = super().__new__(cls, ms)
        t.by = by
        return t


def timed_by(line) -> dict:
    """How each time of a kernel's line was taken (``Timing.by``), for
    its row of the ``kernels`` line."""
    return {k: getattr(line[k], "by", "not recorded")
            for k in ("ms", "plain_ms", "library_ms")
            if line.get(k) is not None}


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
    return Timing(start.elapsed_time(end) / reps, "cuda_events")


def agreed_reading(readings, tol=0.1):
    """The larger of the last two readings if they agree within ``tol`` of
    it, else None: a profiler trace that lost records reads low, and two
    traces in a row rarely lose the same share."""
    if len(readings) < 2:
        return None
    a, b = readings[-2:]
    return max(a, b) if abs(a - b) <= tol * max(a, b) else None


def whole_readings(traces, reps, launches=None):
    """Per-call ms of each profiler trace with its lost records made good.
    A trace is ``{kernel name: (records, summed µs)}`` over ``reps`` equal
    calls. Records get lost whole (seen: 17 of 20 launches of one kernel in
    most traces, two or three of five ``index_add_`` calls) while the
    durations of those that remain are right, so a kernel counts its mean
    duration times its launches a call: the most records any trace holds
    over ``reps``, rounded (a stray record, a first-use copy, rounds to
    none). Where every trace lost the same share of a call's records (seen:
    2 of 8 in every trace of K7's 8 shard launches, which read ¾), those
    counts fall short, so ``launches``, the launches each trace's calls
    made (``call_launches``: sources that lose no record), sets the call's
    whole count: where it is greater, each kernel's count is raised in
    proportion. A trace with no kernel left reads None."""
    names = {name for t in traces for name in t}
    per_call = {name: round(max(t.get(name, (0, 0.0))[0] for t in traces)
                            / reps) for name in names}
    out = []
    for i, t in enumerate(traces):
        kept = [(n, us, per_call[name]) for name, (n, us) in t.items()
                if per_call[name] > 0 and n > 0]
        if not kept:
            out.append(None)
            continue
        counted = sum(k for _, _, k in kept)
        whole = None if launches is None else launches[i] / reps
        scale = whole / counted if whole and whole > counted else 1.0
        out.append(sum(us / n * k for n, us, k in kept) * scale / 1e3)
    return out


#: The calls of the CUDA runtime (cuda*) and of CUDA's lower API (cu*)
#: that put work on the card, one launch, copy or fill each. The profiler
#: records them on the host (its CPU activity), so they are counted
#: whether or not the card's record of the work comes back.
RUNTIME_LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaMemcpy2DAsync", "cudaMemset2DAsync"})
#: The launch counters of every package of kernels in this process beside
#: this checkout's ``kernels.launches`` (``Parent.package`` adds the
#: parent's).
LAUNCH_COUNTERS = []


def port_launches() -> int:
    """The launches every wrapper of the port's kernels has counted."""
    from ionotomo_tpu_torch import kernels
    return sum(sum(c.values()) for c in [kernels.launches] + LAUNCH_COUNTERS)


def launched(name: str) -> int:
    """The launches of the wrapper ``name``, this checkout's and any
    parent package's (whose wrappers ``Parent.run`` puts in place)."""
    from ionotomo_tpu_torch import kernels
    return sum(c.get(name, 0) for c in [kernels.launches] + LAUNCH_COUNTERS)


def reset_all_launches() -> None:
    """Every wrapper's launch counter to 0, the parent package's too."""
    from ionotomo_tpu_torch import kernels
    kernels.reset_launches()
    for c in LAUNCH_COUNTERS:
        for name in c:
            c[name] = 0


_RUNTIME_SEES_PORT = []


def runtime_sees_port() -> bool:
    """Whether the profiler's runtime records hold the port's launches
    (made through its own library, not PyTorch's), found once by tracing
    one launch of ``pack_members``."""
    if not _RUNTIME_SEES_PORT:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from ionotomo_tpu_torch import kernels

        x = torch.ones((1, 1), device="cuda")
        kernels.pack_members(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kernels.pack_members(x)
            torch.cuda.synchronize()
        _RUNTIME_SEES_PORT.append(runtime_records(prof.key_averages(),
                                                  DeviceType) > 0)
        print(f"  the profiler's runtime records "
              f"{'hold' if _RUNTIME_SEES_PORT[0] else 'lack'} the port's "
              f"launches")
    return _RUNTIME_SEES_PORT[0]


def runtime_records(events, device_type) -> int:
    """The runtime records (``RUNTIME_LAUNCHES``) among a trace's
    ``key_averages``."""
    return sum(e.count for e in events if e.device_type == device_type.CPU
               and e.key in RUNTIME_LAUNCHES)


def call_launches(port, runtime, excluded=0) -> int:
    """The launches a trace's calls made: the port's wrappers' count
    ``port`` and the runtime records (which hold the port's own where
    ``runtime_sees_port``; asked only where both counts are not 0), less
    the ``excluded`` kernels' launches."""
    if port and runtime and runtime_sees_port():
        port = 0
    return port + runtime - excluded


#: A profiler reading of a call that launches one kernel once is retaken
#: when it falls below this share of the call's CUDA-event time. CUDA events bound
#: device time from above, and for a kernel that keeps the card busy the
#: two differ by the gaps between launches, a few percent; a trace that
#: lost whole records reads a half or a third (seen: K1r on quadratic at
#: 0.5245 ms against ~1.09). 0.75 lies between the two.
TRACE_SHARE_OF_EVENTS = 0.75
#: ... but not below this share: there the host, not the kernel, sets the
#: event time (seen: 8 launches of K1e in a loop, 0.0235 ms of device time
#: in 0.449 ms of events), and the two cannot be compared.
TRACE_HOST_BOUND_SHARE = 0.25
#: ... and only where the CUDA-event time is at least this (ms) a call:
#: below it the host's launch cost (a wrapper takes ~0.03-0.1 ms) sets the
#: event time of any kernel.
TRACE_EVENTS_FLOOR_MS = 0.2


def plausible_readings(traces, reps, events_ms=None, launches=None):
    """The readings of ``traces`` (``whole_readings``, over the calls'
    ``launches`` where known) that may be taken: all of them, except for
    a call of one kernel (``one_kernel``) whose CUDA-event time
    ``events_ms`` is at least ``TRACE_EVENTS_FLOOR_MS``, where a reading
    between ``TRACE_HOST_BOUND_SHARE`` and ``TRACE_SHARE_OF_EVENTS`` of it
    is set aside (it lost records that no other trace kept)."""
    readings = [r for r in whole_readings(traces, reps, launches)
                if r is not None]
    if events_ms is None or not one_kernel(traces, reps) \
            or events_ms < TRACE_EVENTS_FLOOR_MS:
        return readings
    return [r for r in readings
            if not TRACE_HOST_BOUND_SHARE * events_ms <= r
            < TRACE_SHARE_OF_EVENTS * events_ms]


def one_kernel(traces, reps) -> bool:
    """Whether the traces hold the records of one kernel only, launched
    once a call of the ``reps``: several launches a call leave the host's
    gaps between them in the event time (seen: the plain permute's four
    index kernels, 0.148 ms of device time in 0.205 ms of events)."""
    names = {name for t in traces for name in t}
    return len(names) == 1 and round(
        max(t.get(name, (0, 0.0))[0] for t in traces for name in names)
        / reps) == 1


def device_ms(fn, reps: int, exclude=()) -> float:
    """Mean device time of ``fn`` in ms: the durations of the kernels (and
    copies) it runs on the card, those named in ``exclude`` left out (an
    L2 flush, ``l2_flush``), from torch.profiler's CUPTI trace over
    ``reps`` calls after a warm-up. Unlike ``cuda_ms`` it does not count
    the card waiting for the host between launches, which is most of a
    small kernel's wall time here. A trace can come back empty or short of
    records, so every trace is read with its lost records made good
    (``whole_readings``, over the launches its calls made: the port's
    wrappers' counters read before and after the ``reps`` calls, and the
    trace's runtime records for PyTorch's own kernels and copies), and
    traces are taken until two in a row agree
    within 10 % (``agreed_reading``). For a call of one kernel the
    readings are also held to its CUDA-event time (``cuda_ms``, taken once
    after the first trace): one short of it by a lost record's share is
    set aside and another trace taken (``plausible_readings``). After
    eight traces without an agreeing pair the largest reading is taken and
    a line says so. Where every trace came back empty, the CUDA-event time
    is taken, and a line says so. The result is a ``Timing`` that says
    which of the two it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces, launches, events_ms = [], [], None
    for _ in range(8):
        before = port_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        port = port_launches() - before
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        traces.append({e.key: (e.count, e.self_device_time_total)
                       for e in kernels if e.key not in exclude})
        launches.append(call_launches(
            port, runtime_records(events, DeviceType),
            sum(e.count for e in kernels if e.key in exclude)))
        if events_ms is None and one_kernel(traces, reps):
            events_ms = cuda_ms(fn, reps)
        ms = agreed_reading(plausible_readings(traces, reps, events_ms,
                                               launches))
        if ms is not None:
            return Timing(ms, "profiler")
    readings = [r for r in whole_readings(traces, reps, launches)
                if r is not None]
    if not readings:
        # a CUPTI trace can come back empty: seen eight times in a row for
        # the plain pack of the service's 2 tables after 14 phases of
        # tracing, where every earlier run had read it
        ms = cuda_ms(fn, reps)
        print(f"  note: torch.profiler recorded no device time in eight "
              f"traces; CUDA events taken, {ms:.4f} ms")
        return Timing(ms, "cuda_events")
    kept = plausible_readings(traces, reps, events_ms, launches)
    print(f"  note: no two profiler traces in a row agreed, {readings}"
          + (f" (CUDA events {events_ms:.4f} ms; "
             f"{len(readings) - len(kept)} set aside as short)"
             if events_ms is not None else "")
          + "; the largest is taken")
    return Timing(max(readings), "profiler")


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
# K1r: four evaluations a step, each with its _rhs stage (the exp, the
# sqrt, the divisions), counted as 4 x the model's leapfrog step; the rk4
# tracers by field model: (tracer, its pack, the model's module, live rows
# a point, flops a leapfrog step, its value + gradient kernel).
RK4_TRACERS = {
    "zp": ("trace_rk4_zp", "pack_zp_taps", "boxspline", 7, FLOPS_K1_STEP,
           "zp_value_grad"),
    "cubic": ("trace_rk4_cubic", "pack_z_taps", "tricubic", 16,
              FLOPS_K1C_STEP, "cubic_value_grad"),
    "zpc": ("trace_rk4_zpc", "pack_z_taps", "zpcubic", 7, FLOPS_K1Z_STEP,
            "zpc_value_grad"),
    "quadratic": ("trace_rk4_quad", "pack_zp_taps", "triquadratic", 9,
                  FLOPS_K1Q_STEP, "quad_value_grad"),
}
EVALUATORS = tuple(v[5] for v in RK4_TRACERS.values())
# K1s: K1c's step (leapfrog) or 4 of them (rk4) plus, per evaluation, the
# single-layer background: z, two exps, the profile and its derivative.
FLOPS_BACKGROUND = 30
#: the pack each tracer's call reads
TRACER_PACKS = {**{v[4]: v[5] for v in NEW_MODELS.values()},
                **{v[0]: v[1] for v in RK4_TRACERS.values()}}
# One ray's sort key (ray_order_keys_kernel): four quantised coordinates
# (5-6 each), four 8-bit spreads (9 each) and the combination (6).
OPS_RAY_KEY = 64
# One point's row-major sort key as the set-up's rows hold it: two clamps
# and the row * nz + z (6); the bound keeps this definition, though the
# kernel recomputes the base cell from the points.
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


def k6zt_plan_shape(plan):
    """What K6zᵀ's warps take at a plan (host reads, outside any timing):
    occupied rows, used segments, the longest row in pairs, the rows of
    several segments (a ticket and a fold each), and the task list: tasks
    of whole short rows with their pairs a task, and segments of long
    rows."""
    counts = torch.diff(plan.offsets)
    nseg = torch.diff(plan.row_seg)
    tasks = plan.tasks[:int(plan.n_tasks)]
    groups = tasks[:, 0] < 0
    pairs = (tasks[:, 2] - tasks[:, 1])[groups].float()
    spans = ((tasks[:, 3] >> 16) - (tasks[:, 3] & 0xFFFF) + 1)[~groups]
    return {"occupied_rows": int((counts > 0).sum()),
            "segments": int(plan.row_seg[-1]),
            "longest_row": int(counts.max()),
            "rows_to_fold": int((nseg > 1).sum()),
            "tasks": int(plan.n_tasks),
            "short_row_tasks": int(groups.sum()),
            "pairs_a_short_row_task": float(pairs.mean()) if len(pairs)
            else 0.0,
            "long_row_tasks": int((~groups).sum()),
            "long_row_span_mean": float(spans.float().mean()) if len(spans)
            else 0.0}


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


def check_k5(label, tricubic, kernels, table, grid, ends, reps=50,
             plain_reps=5):
    """K5 at one point set against its plain version: the value within
    1e-5·max|table|, the gradient within 1e-5·max|table|/h; device ms of
    the kernel and the plain version beside the bound. Returns its
    ``line`` (the value's error)."""
    v_k, g_k = kernels.cubic_value_grad(table, grid, ends)
    v_p, g_p = tricubic.interp_rows_with_grad_ref(table, grid, ends)
    err_v = float((v_k - v_p).abs().max())
    check(err_v <= 1e-5 * float(table.abs().max()),
          f"{label}: value max|err| {err_v:.3e} <= 1e-5*max|table|")
    check(float((g_k - g_p).abs().max())
          <= 1e-5 * float(table.abs().max()) / float(grid.spacing.min()),
          f"{label}: gradient within 1e-5*max|table|/h")
    del v_k, g_k, v_p, g_p
    ms = device_ms(lambda: kernels.cubic_value_grad(table, grid, ends), reps)
    plain = device_ms(
        lambda: tricubic.interp_rows_with_grad_ref(table, grid, ends),
        plain_reps)
    b_ms, b_by = k5_bound(tricubic, grid, ends)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err_v, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=ends.shape[0])


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
    commit before the point order's keys and K6q were redesigned, built
    from its sources with this checkout's nvcc flags. ``run(fn)`` calls fn
    with every kernel the parent's, each entry through this checkout's
    wrapper on the parent's library, so that ``run(call)`` is the parent's
    whole call, for every kernel whose C interface this checkout kept. The
    entries in ``CHANGED`` took another interface here, so the library is
    opened without them; the parent's own package (``package``, loaded
    from ``root`` under another name, its wrappers and plans on this
    library) calls them as the parent did, and ``run`` puts its wrappers
    of them (``WRAPPERS``) in place of this checkout's, and each field
    model's ``point_order`` (``POINT_ORDER_MODELS``) by one that builds the
    parent's order (its keys read from the set-up's rows) into this
    checkout's ``PointOrder``. The
    parent's library lacks the entries in ``NEW``, which it is opened
    without; the kernels behind them have no parent. ``SORT_AND_PACK``
    holds the parent's entries of ``kernels.SORT_AND_PACK`` that this
    checkout changed and ``KERNELS`` the other module attributes behind
    its calls; ``run`` swaps them in.

    ctypes cannot check a C interface, so the parent's sources are
    declared by their SHA-256, and any other checkout is refused rather
    than handed arguments it does not take."""

    NEW = ()
    CHANGED = ("ionotomo_point_order_keys",)
    WRAPPERS = ()
    POINT_ORDER_MODELS = ("boxspline", "tricubic", "zpcubic")
    SORT_AND_PACK = {}
    KERNELS = {}

    SOURCES = {
        "cubic_sharded.cu":
            "8fd06f5e4e2390a0fcf59ec4bb9671a1412b208e0ca4323c68bf8afccf1a4f89",
        "cubic_sharded_bwd.cu":
            "ea79ceccf40848c6fbf698db4ce2748a8c60ff970b77853825b682b833f07013",
        "cubic_value_grad.cu":
            "e7a491381cdfbf7886294e643e79676595109eba094861c18f65d665a0a5aa74",
        "cubic_value_grad_bwd.cu":
            "ffdc7c8ce20291e6f8ec2b657f62b99c37ac6fa184175db24e361c1a1e6c954b",
        "quad_value_grad.cu":
            "800fec21e2b9b81d89cf9103f0668c69e085b3841a8bb98e2305316e15045fd3",
        "rows_value_bwd.cu":
            "8b89433a04e2db28da6ebddbca603d78de2def71956e78422e93094e39d52d85",
        "rows_value_bwd_batched.cu":
            "d2ee71fe6ce7842b061af73b44af546f1411e1758dbc2452bad76d2593e7c7ae",
        "rows_value_fwd.cu":
            "81e6c5a1dcb4796668ff9d8e4220ee7843502dfc4fed5750fec47b599ac5888d",
        "rows_value_fwd_batched.cu":
            "33b0b3474550fda8a1440c6ad76f61290a168eeaf73dfd0074e71c7df6c48c3b",
        "trace_leapfrog_cubic.cu":
            "0d0688e3bcf98ac0e3b8c230ff3e0a4dd39e7a3141c333cc72cf3b29747a150c",
        "trace_leapfrog_quad.cu":
            "fd0da91eb2f104bb6fb605b3d1f085c1dd6e0bd9d765ea165d8ad1090f7f12ce",
        "trace_leapfrog_zp.cu":
            "70f00ed2bf84a597ada93c24ee66deafafa23d7b40e2e297d623f4e78af7f500",
        "trace_leapfrog_zpc.cu":
            "36ffa013cc5104dfb2f5939f0bcf053a28df6d5e514eb9e572614dc13e58ea1c",
        "trace_split.cu":
            "f1149b7f5e66142e68583e3ebda462c338a567ae8534aa53768fdf1e9eee113a",
        "vector_gather.cu":
            "e0d19a2da2d4ccef5782631ae780053fa77062ae0c19c1e7935b9ff7ee882216",
        "zp_value_grad.cu":
            "12f7563e18fccf8ef0056214b83c81daaba628df02b008b5210c8bce8b801027",
        "zp_value_grad_bwd.cu":
            "eb6fb1308c6193f1a528bdeb52ae7c21be3c7e667df9382c1eb590bc5e878d90",
        "zpc_value_grad.cu":
            "10bb527cee3092ef9da662aee2cf772568fad3a8e92800040a2f4a6f3e35759f",
        "zpc_value_grad_bwd.cu":
            "8f5c547e2058e82d1e1062222bd57848a37e1c375f72c28be6c589e736d369fc",
    }

    def __init__(self, root):
        from ionotomo_tpu_torch.kernels import build

        self.root = Path(root)
        csrc = self.root / "ionotomo_tpu_torch" / "kernels" / "csrc"
        got = {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
               for f in csrc.glob("*.cu")}
        if got != self.SOURCES:
            raise ValueError(
                f"--parent {root}: its kernel sources are not those of the "
                f"commit whose C interface this script binds (differ: "
                f"{sorted(set(got.items()) ^ set(self.SOURCES.items()))})")
        info = build.build(csrc, build.BUILD_DIR / "parent")
        self.build, self.info = build, info
        self.lib = build.open_library(
            info["path"], [n for n in build._SIGNATURES
                           if n not in self.NEW + self.CHANGED])
        for name in self.CHANGED:
            setattr(self.lib, name, self._refused(name))
        self._package = None
        print(f"  parent kernels from {csrc} (built={info['built']} in "
              f"{info['seconds']:.2f} s)")

    @staticmethod
    def _refused(name):
        def call(*args):
            raise RuntimeError(f"{name}: the parent's entry takes another C "
                               f"interface; call it through "
                               f"Parent.package()")
        return call

    def package(self):
        """The parent's ``ionotomo_tpu_torch``, loaded from ``root`` as
        ``parent_ionotomo_tpu_torch`` (its own modules, wrappers and
        plans), its kernels on the parent's library opened with the
        parent's own C signatures."""
        if self._package is None:
            import importlib
            import importlib.util

            name = "parent_ionotomo_tpu_torch"
            pkg = self.root / "ionotomo_tpu_torch"
            spec = importlib.util.spec_from_file_location(
                name, pkg / "__init__.py",
                submodule_search_locations=[str(pkg)])
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
            pbuild = importlib.import_module(name + ".kernels.build")
            pbuild._loaded["lib"] = pbuild.open_library(self.info["path"])
            LAUNCH_COUNTERS.append(
                importlib.import_module(name + ".kernels").launches)
            self._package = module
        return self._package

    def point_order(self, model):
        """The parent's ``point_order`` of the field model ``model`` (a
        module of ``ionotomo_tpu_torch.core``) under this checkout's
        signature: the parent's keys, sort and permute, as this checkout's
        ``PointOrder`` of the same set-up."""
        from ionotomo_tpu_torch.core import tricubic

        pmod = importlib.import_module(
            f"{self.package().__name__}.core.{model.__name__.split('.')[-1]}")

        def point_order(grid, points, ri, wxy, zi, wz):
            po = pmod.point_order(ri, wxy, zi, wz, grid.shape)
            return tricubic.PointOrder(po.order, po.ri, po.wxy, po.zi,
                                       po.wz, (ri, wxy, zi, wz))
        return point_order

    def run(self, fn):
        """fn() with the parent's kernels behind this checkout's wrappers
        (the parent's own wrappers of ``CHANGED`` and its point orders)
        and the parent's launch of each call."""
        from ionotomo_tpu_torch import kernels
        pk = importlib.import_module(self.package().__name__ + ".kernels")
        swaps = [(kernels, k, v) for k, v in {
            "SORT_AND_PACK": {**kernels.SORT_AND_PACK, **self.SORT_AND_PACK},
            **self.KERNELS,
            **{w: getattr(pk, w) for w in self.WRAPPERS}}.items()]
        for name in self.POINT_ORDER_MODELS:
            model = importlib.import_module("ionotomo_tpu_torch.core."
                                            + name)
            swaps.append((model, "point_order", self.point_order(model)))
        saved = self.build.load(), [(m, k, getattr(m, k))
                                    for m, k, _ in swaps]
        self.build._loaded["lib"] = self.lib
        for m, k, v in swaps:
            setattr(m, k, v)
        try:
            return fn()
        finally:
            self.build._loaded["lib"] = saved[0]
            for m, k, v in saved[1]:
                setattr(m, k, v)


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
                        n_steps, paths=(False, True), parent=None):
    """A tracer (K1z, K1q, K1r) as the tracer calls it, and packed and
    sorted whatever the batch, each bitwise the unpacked kernel in ray
    order (one thread a ray, 128 a block), path on and off; with a parent,
    the call bitwise the parent's."""
    call, with_ = getattr(kernels, name), getattr(kernels, name + "_with")
    packed = getattr(kernels, TRACER_PACKS[name])(table, grid)
    order = kernels.ray_order(o, d, grid)
    for keep_path in paths:
        parent_bitwise(parent, f"{label}, keep_path={keep_path}: {name}",
                       lambda: call(table, grid, o, d, n_steps, keep_path,
                                    **kw))
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


def k2_order_check(label, kernels, tricubic, model, table, grid, points,
                   setup, xy_first, parent=None):
    """K2 over the model's point order of ``setup`` (``row_setup(grid,
    points)``; its inputs permuted into it), and in ray order, each bitwise
    K2's generic kernel in ray order (``generic_k2``); returns the order (a
    ``tricubic.PointOrder``). Rows made up without points (``points``
    None) take the order of the rows' own keys. With a parent, K2 over the
    order bitwise the parent's K2."""
    ri, wxy, zi, wz = setup
    if points is None:
        o = torch.sort(kernels.point_order_keys_ref(
            ri, zi, model.BASE_TRANSLATE, grid.shape), stable=True
        ).indices.to(torch.int32)
        order = tricubic.PointOrder(o, *kernels.permute_points(o, *setup),
                                    setup)
    else:
        order = model.point_order(grid, points, ri, wxy, zi, wz)
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


def order_tensors(po):
    """A ``PointOrder``'s order and permuted inputs."""
    return po.order, po.ri, po.wxy, po.zi, po.wz


_FLOORS = {}


def floor_library():
    """The library built with every launch-floor define of the kernels
    this checkout redesigned last (``POINT_KEYS_LAUNCH_FLOOR``,
    ``K6Q_LAUNCH_FLOOR``: their launches with an empty body), built once
    a process."""
    from ionotomo_tpu_torch.kernels import build

    if "lib" not in _FLOORS:
        info = build.build(defines=("POINT_KEYS_LAUNCH_FLOOR=1",
                                    "K6Q_LAUNCH_FLOOR=1"))
        _FLOORS["lib"] = build.open_library(info["path"])
        print(f"  launch-floor library (built={info['built']} in "
              f"{info['seconds']:.2f} s)")
    return _FLOORS["lib"]


def with_library(lib, fn):
    """fn() with every wrapper on the library ``lib``."""
    from ionotomo_tpu_torch.kernels import build

    saved = build.load()
    build._loaded["lib"] = lib
    try:
        return fn()
    finally:
        build._loaded["lib"] = saved


def floor_in_turns(fn, reps, pairs=2):
    """fn()'s device ms and its launch floor's (fn on ``floor_library``),
    in turns (kernel, floor, floor, kernel, ...): (kernel ms, floor ms)
    lists."""
    floor = floor_library()
    t = {"kernel": [], "floor": []}
    for i in range(pairs):
        for who in (("kernel", "floor") if i % 2 == 0
                    else ("floor", "kernel")):
            t[who].append(device_ms(fn, reps) if who == "kernel"
                          else with_library(floor,
                                            lambda: device_ms(fn, reps)))
    return t["kernel"], t["floor"]


def point_order_line(label, kernels, model, grid, points, setup,
                     parent=None):
    """K2's point order at one point set: the key kernel (from the points)
    bitwise the key the set-up's rows hold (``point_order_keys_ref``) and
    its plain version, timed beside its launch floor (in turns), its plain
    version and its bound (each point's base row and z read, its key
    written: 12 B a point; the points it reads make 16 B a point), the
    order (keys and ``torch.sort``), the whole ``PointOrder`` (and the
    inputs permuted), and the permute kernel alone beside its plain
    version, ``index_select`` and its bound (the inputs read and written
    once, the order read); with a parent, the keys, the ``PointOrder``
    and the permute bitwise the parent's (its keys from the rows), the
    keys and the permute timed in turns with it. Returns the keys' and
    the permute's lines."""
    ri, _, zi, _ = setup
    base, rule, shape = model.BASE_TRANSLATE, model.POINT_RULE, grid.shape
    n = ri.shape[0]

    def keys_fn():
        return kernels.point_order_keys(points, grid, rule)

    keys = keys_fn()
    want = kernels.point_order_keys_ref(ri, zi, base, shape)
    check(bool(torch.equal(keys, want)),
          f"{label}: the point order's keys from the points bitwise the "
          f"keys of the set-up's rows")
    check(bool(torch.equal(kernels.point_order_keys_plain(
        points, grid, model.base_cell), want)),
          f"{label}: the keys' plain version bitwise the keys of the "
          f"set-up's rows")
    del keys, want
    ms = device_ms(keys_fn, 20)
    k_turns, f_turns = floor_in_turns(keys_fn, 20)
    plain = device_ms(lambda: kernels.point_order_keys_plain(
        points, grid, model.base_cell), 5)
    sort_ms = device_ms(lambda: kernels.point_order(points, grid, rule,
                                                    model.base_cell), 20)
    build_ms = device_ms(lambda: model.point_order(grid, points, *setup), 20)
    b_ms, b_by = bound(12 * n, n * OPS_POINT_KEY)
    pb_ms = bound(16 * n, n * OPS_POINT_KEY)[0]
    print(f"  point order at {label}: the keys {ms:.4f} ms (in turns with "
          f"its launch floor {', '.join(f'{x:.4f}' for x in k_turns)} vs "
          f"{', '.join(f'{x:.4f}' for x in f_turns)}; plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; read from the points "
          f"{pb_ms:.4f}); keys and sort {sort_ms:.4f} ms; with K2's inputs "
          f"permuted into it {build_ms:.4f} ms, by kernel: " + "; ".join(
              f"{v:.4f} ms {key[:40]}" for key, v in sorted(
                  kernel_ms_by_name(lambda: model.point_order(
                      grid, points, *setup), 5).items(),
                  key=lambda kv: -kv[1])))
    keys_line = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, order_ms=sort_ms,
                     build_ms=build_ms, points=n, points_bound_ms=pb_ms,
                     kernel_ms_in_turns=k_turns, floor_ms=f_turns)
    if parent is not None:
        pk = importlib.import_module(parent.package().__name__ + ".kernels")
        keys_line["parent_ms"], keys_line["new_ms_in_turns"] = \
            compare_parent(f"the keys at {label} (the parent's from the "
                           f"rows)", lambda: pk.point_order_keys(
                               ri, zi, base, shape), keys_fn, 20, pairs=3)
        parent_bitwise(parent, f"the PointOrder at {label}",
                       lambda: order_tensors(model.point_order(
                           grid, points, *setup)))
    # the permute kernel alone
    order = kernels.point_order(points, grid, rule, model.base_cell)
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
    return keys_line, perm_line


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
                           table, grid, pts, (ri, wxy, zi, wz), True, parent)
    k2_order_check("phase 2, cubic shape on random rows", kernels, tricubic,
                   tricubic, table, grid, None, (ri_c, wxy_c, zi_c, wz_c),
                   False, parent)
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
    b = torch.arange(1, N_GRID - 1, device=dev)
    take = take_pack(coef3, torch.stack([b - 1, b, b + 1,
                                         torch.full_like(b, -1)], -1))
    check(bool(torch.equal(take(), packed)),
          "K1's pack as one torch.take: bitwise the kernel's")
    lib_ms = device_ms(take, 20)
    b_ms, b_by = bound(nbytes(coef3, packed), 0)
    print(f"  K1's pack of the 128^3 table: kernel {p_ms:.4f} ms, plain "
          f"{p_plain:.4f} ms, one torch.take {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    results["pack_zp_taps"] = {"line": dict(
        max_abs_err=0.0, ms=p_ms, plain_ms=p_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)}


def take_pack(table2d, z):
    """One PyTorch call of a z-tap pack (K1's, K1c's): ``torch.take`` of
    the flat (rows, nz) table, a zero appended, at the pack's index
    (bases, rows, taps), made beforehand from ``z`` (bases, taps), the z
    of each tap at each base (−1: the zero)."""
    rows, nz = table2d.shape
    flat = torch.cat([table2d.reshape(-1), table2d.new_zeros(1)])
    r = torch.arange(rows, device=table2d.device)[None, :, None] * nz
    idx = torch.where(z[:, None, :] < 0, rows * nz, r + z[:, None, :])
    return lambda: torch.take(flat, idx)


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
          plain_reps=2, parent=None):
    """K6z or K6q at one shape: bitwise twice; against its plain version
    and against its twin in the kernel's order (1e-5·max|table| the value,
    over the smallest spacing the gradient); timed beside the plain
    version and its bound (the distinct values its points touch), K6q
    also in turns with its launch floor (the same grid with an empty
    body); with a parent, bitwise the parent's and timed in turns with it.
    Returns the shape's line."""
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
    line = dict(max_abs_err=errs[0], ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=pts.shape[0])
    if name == "quad_value_grad":
        k_turns, f_turns = floor_in_turns(lambda: kern(table, grid, pts),
                                          reps)
        print(f"  K6q at {label}: in turns with its launch floor "
              f"{', '.join(f'{x:.4f}' for x in k_turns)} vs "
              f"{', '.join(f'{x:.4f}' for x in f_turns)} ms")
        line.update(kernel_ms_in_turns=k_turns, floor_ms=f_turns)

    def call():       # the wrapper Parent.run puts in place
        return getattr(kernels, name)(table, grid, pts)

    if parent is not None:
        line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
            f"{name} at {label}", lambda: parent.run(call), call, reps,
            pairs=3)
    return line


def phase2_new_models(dev, tricubic, zpcubic, triquadratic, fermat,
                      kernels, Grid3D, chapman, results, sizes=(N_GRID, 256),
                      n_points=1 << 20, n_rays=8192, parent=None):
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
                k6_at(tag, kernels, model, name, table, grid, pts,
                      parent=parent)
            if interp == "zpc" and where == "edge-case":
                # K2 at (8, 4): zpc's value gather over its point order
                setup = zpcubic.row_setup(grid, pts)
                k2_order_check(f"phase 2, zpc (K=8, L=4), {tag}", kernels,
                               tricubic, zpcubic, table, grid, pts, setup,
                               True)
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
                parent, reps=5)
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
                            table, grid3, o, d, kw, N_STEPS, parent=parent)


def phase3_new_tracers(dev, fermat, kernels, Grid3D, chapman, results,
                       card, n_rays=262144, parent=None):
    """Phase 3 on the zpc and triquadratic models: K1z and K1q at the
    bench's configuration (262144 rays, leapfrog@64, 150 MHz) through
    ``trace_rays``, launches counted, bitwise the unpacked kernels (and,
    with a parent, the parent's, timed in turns with it), timed beside the
    plain tracer and the bound; the same, path on and off, one ray below
    each model's own threshold and at it; then K6q alone at the bench
    trace's points halfway (its launches: phase 14's rk4 trace on
    quadratic)."""
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
                            grid, o, d, kw, N_STEPS, paths=(False,),
                            parent=parent)
        tracer = getattr(kernels, name)

        def call():
            return tracer(table, grid, o, d, N_STEPS, False, **kw)

        ms = device_ms(call, 3)
        if parent is not None:
            results[name]["line"]["parent_ms"], \
                results[name]["line"]["new_ms_in_turns"] = compare_parent(
                    f"{name} at {n_rays} rays", lambda: parent.run(call),
                    call, 3, pairs=3)
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
        # one ray below the model's own threshold (the table as it is) and
        # at it (sorted and packed): bitwise the unpacked kernel in ray
        # order and the parent's call, path on and off, timed in turns
        at = kernels.SORT_AND_PACK[name][0] * \
            torch.cuda.get_device_properties(dev).multi_processor_count
        for n in (at - 1, at):
            on, dn = o[:n].contiguous(), d[:n].contiguous()
            side = "below" if n < at else "at"
            check_trace_bitwise(f"phase 3, {n} rays ({side} {name}'s "
                                f"threshold)", kernels, name, table, grid,
                                on, dn, kw, N_STEPS, parent=parent)
            if parent is not None:
                def call_n(on=on, dn=dn):
                    return tracer(table, grid, on, dn, N_STEPS, False, **kw)

                results[name]["line"].setdefault("in_turns_by_rays", {})[
                    n] = compare_parent(f"{name} at {n} rays ({side} its "
                                        f"threshold)",
                                        lambda: parent.run(call_n), call_n,
                                        3, pairs=2)
            del on, dn

    # K6q alone at the bench trace's points halfway along the rays
    table = triquadratic.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    mid = kernels.trace_leapfrog_quad(table, grid, o, d, N_STEPS, True,
                                      **kw)[2][:, N_STEPS // 2].contiguous()
    results["quad_value_grad"] = {
        "line": k6_at(f"the bench trace's {n_rays} points halfway",
                      kernels, triquadratic, "quad_value_grad", table, grid,
                      mid, reps=20, plain_reps=3,
                      parent=parent)}


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
    if plan.tasks is not None:
        print(f"  {name} task list: {k6zt_plan_shape(plan)}")


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
                   boxspline, table, grid, pts, (ri, wxy, zi, wz), True,
                   parent)
    k2_order_check(f"phase 5, cubic, {n} edge-case points", kernels,
                   tricubic, tricubic, table, grid, pts,
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
                           tricubic, boxspline, table, op.grid, op.points,
                           (op.ri, op.wxy, op.zi, op.wz), True, parent)
    check(bool(torch.equal(order.order, op.point_order().order)),
          "the geometry keeps the point order K2's wrapper makes")
    keys_line, perm_line = point_order_line(
        f"config 3b's {n_pts} zp points", kernels, boxspline, op.grid,
        op.points, (op.ri, op.wxy, op.zi, op.wz), parent)
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
    b = torch.arange(N_GRID - 1, device=dev)
    take = take_pack(table.reshape(N_GRID * N_GRID, N_GRID), torch.stack(
        [(b - 1).clamp_min(0), b, b + 1, (b + 2).clamp_max(N_GRID - 1)], -1))
    for name, kern, plain, library, n_bytes, n_ops in (
            ("pack_z_taps", lambda: kernels.pack_z_taps(table, grid),
             lambda: tricubic.pack_z_taps_ref(table), take,
             nbytes(table) + 16 * (N_GRID - 1) * N_GRID * N_GRID, 0),
            ("ray_order_keys", lambda: kernels.ray_order_keys(o2, d2, grid),
             lambda: kernels.ray_order_keys_ref(o2, d2, grid), None,
             nbytes(o2, d2) + 4 * n_rays, n_rays * OPS_RAY_KEY)):
        got, want = kern(), plain()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{name} at {n_rays} rays: bitwise "
                                      f"its plain version")
        if library is not None:
            check(torch.equal(library(), got),
                  f"{name} as one torch.take: bitwise the kernel's")
        k_ms, p_ms = device_ms(kern, 20), device_ms(plain, 5)
        lib_ms = device_ms(library, 20) if library is not None else None
        nb_ms, nb_by = bound(n_bytes, n_ops)
        print(f"  {name} at {n_rays} rays: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, one PyTorch call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{nb_ms:.4f} ms ({nb_by})")
        results[name] = {"line": dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=nb_ms,
            bound_by=nb_by, library_ms=lib_ms), "launches": launches[name]}
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
                 plain_full, results, profile=False, parent=None):
    """Config 4 with the zpc2 inner Jacobian (``interp="cubic",
    interp_inner="zpc2"``, the reference's mixed-fidelity 256³ route):
    K2 at zpc's (8, 4) shape over each bundle's point order, bitwise the
    generic kernel and within 1e-4·max of its plain version, K6z and K6zᵀ
    (adding into a K3 table) at the solve's endpoints, the kernels one Jᵀ
    on zpc launches; then the solve through the entry point twice,
    bitwise equal (the card's version of the reference's zpc determinism
    gate, bench/probe_zp256.py), its kernels launched, within 1 % of the
    plain-version solve in residual and held-out dTEC rms, and below the
    prior on held-out rays. With a parent: K6zᵀ bitwise the parent's and
    timed in turns with it, and the solve bitwise the solve on the
    parent's kernels. Returns the K2 lines by shape."""
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
                               tricubic, zpcubic, table, o_.grid, o_.points,
                               setup, True)
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
        "zpc_value_grad", table, grid, ends, reps=50, plain_reps=5,
        parent=parent)}
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
        parent, reps=50, plain_reps=5)}
    results["zpc_value_grad_bwd"]["plan"] = k6zt_plan_shape(eplan)
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
    if parent is not None:
        zp_, secs_pp = parent.run(lambda: solve(w))
        check(bool(torch.equal(zp_.m, za.m)),
              f"the config-4 zpc2-inner solve bitwise the solve on the "
              f"parent's kernels ({secs_pp:.4f} s)")
        del zp_
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
                               tricubic, tricubic, table, o_.grid, o_.points,
                               setup, False, parent)
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
                f"config 4's {n_pts} points", kernels, tricubic, o_.grid,
                o_.points, setup, parent)
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
    results["cubic_value_grad"] = {"line": check_k5(
        f"K5 at the solve's {n_ends} endpoints", tricubic, kernels, table,
        grid, ends)}
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
    del op, ops, o_, table

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
                                   kernels, plain_full, results, profile,
                                   parent))
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
                      xy_first, rng, parent=None, layout=False, b=B_MEMBERS):
    """K2b and K3b at one point set with B_MEMBERS members: against the
    plain versions (1e-4·max), member by member bitwise against K2 and
    K3, K3b bitwise twice; device ms of each call (its pack and fold
    included), the plain version, the one-call form, the bound, B x the
    unbatched kernel, and each call's time by kernel. With a parent: both
    bitwise the parent's and timed in turns with it. ``layout``: also the
    pack and the fold alone against their plain versions (their lines).
    ``b``: the members (B_MEMBERS unless given)."""
    ri, wxy, zi, wz = setup
    n = ri.shape[0]
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
                                         plan, zi, rng, parent))
    elif parent is not None:
        out["rows_value_bwd_batched"]["fold"] = fold_line(
            label, tricubic, kernels, plan, zi, b, nz, rng, parent)
    torch.cuda.empty_cache()
    return out


def pack_members_line(label, tricubic, kernels, tables):
    """The pack of B (R, nz) tables into member-innermost groups alone:
    bitwise its plain version, timed beside its bound (the tables read,
    whole groups written) and, where B is one whole group, the
    transposing copy. Returns its ``line``."""
    b = tables.shape[0]
    flat = tables.view(b, -1)

    def pack():
        return kernels.pack_members(flat)

    def plain_pack():
        return tricubic.pack_members_ref(flat)
    check(bool(torch.equal(pack(), plain_pack())),
          f"pack_members of {b} tables at {label}: bitwise its plain version")
    groups = -(-b // kernels.MEMBER_GROUP)
    return check_and_time(
        f"pack_members of {b} tables ({tuple(tables.shape)}) at {label}",
        pack, plain_pack,
        (lambda: flat.t().contiguous()) if b == kernels.MEMBER_GROUP
        else None,
        bound(nbytes(flat) + 4 * kernels.MEMBER_GROUP * groups * flat.shape[1],
              0), scatter=False)


def member_layout_kernels(label, tricubic, kernels, tables, plan, zi, rng,
                          parent=None):
    """The two kernels K2b's and K3b's calls launch beside the gather and
    the reduce, alone at the call's shapes: the pack of the tables
    (bitwise its plain version; one call: a transposing copy) and the fold
    (``fold_line``)."""
    b, _, nz = tables.shape
    return {"pack_members": pack_members_line(label, tricubic, kernels,
                                              tables),
            "fold_member_rows": fold_line(label, tricubic, kernels, plan, zi,
                                          b, nz, rng, parent)}


def fold_line(label, tricubic, kernels, plan, zi, b, nz, rng, parent=None):
    """K3b's fold alone over a point set's plan, ``b`` members: random
    partial rows inside the z spans K3b's reduce writes there
    (``segment_spans_ref`` of the plan and the points' taps zi), NaN
    outside (never read), bitwise its plain version; with a parent, the
    parent's fold of the same rows with +0.0 outside the spans (what the
    parent's reduce left there) bitwise the new one, timed in turns. Its
    bound: each member's spans read and its rows of several segments
    written once, 4 B (sum of spans + rows x nz) a member (the first
    design's, whole partial rows read, kept as ``full_row_bound_ms``). One
    PyTorch call of the same sum: ``index_add_`` along dim 1 of those
    segments' partial rows (+0.0 outside the spans, gathered beforehand)
    into a (B, rows, nz) buffer of those rows, and its ``zero_`` first;
    the scatter back into the table is not in it. Returns its line."""
    dev = zi.device
    spans = tricubic.segment_spans_ref(plan, zi, nz)
    nseg = plan.row_seg[1:] - plan.row_seg[:-1]
    multi = nseg > 1
    seg_row = plan.seg_row.long()
    in_multi = multi[seg_row.clamp(max=plan.n_rows - 1)] & (
        seg_row < plan.n_rows)
    z = torch.arange(nz, device=dev)
    covered = in_multi[:, None] & (spans[:, :1] <= z) & (z <= spans[:, 1:])
    parts = torch.from_numpy(rng.normal(size=(b, plan.n_seg_max, nz))
                             .astype(np.float32)).to(dev)
    zeros = torch.where(covered, parts, 0.0)
    nans = torch.where(covered, parts, float("nan"))
    del parts
    base = torch.zeros((b, plan.n_rows, nz), dtype=torch.float32,
                       device=dev)
    running = base.clone()

    def fold():
        return kernels.fold_member_rows(nans, plan, base.clone(), spans)

    def plain_fold():
        return tricubic.fold_member_rows_ref(nans, plan, base.clone(), spans)
    check(bool(torch.equal(fold(), plain_fold())),
          f"fold_member_rows at {label}: bitwise its plain version")
    n_multi = int(multi.sum())
    folded = int(nseg[multi].sum())
    segs = torch.nonzero(in_multi).squeeze(1)
    span_sum = int((spans[segs, 1] - spans[segs, 0] + 1).clamp_min(0).sum())
    print(f"  {n_multi} rows of several segments hold {folded} of the "
          f"{int(plan.row_seg[-1])} segments (busiest row "
          f"{int(nseg.max())}); their spans {span_sum} of "
          f"{folded * nz} z cells, {span_sum / max(folded, 1):.1f} a "
          f"segment; the fold's list {int(plan.n_multi[0])} of "
          f"{plan.multi_rows.shape[0]} listed")
    rank = torch.cumsum(multi, 0) - 1
    dest = rank[seg_row[segs]]
    src = zeros[:, segs].contiguous()
    rows = torch.empty((b, n_multi, nz), dtype=torch.float32, device=dev)
    line = check_and_time(
        f"fold_member_rows at {label} ({n_multi} rows, {folded} segments)",
        fold, plain_fold, lambda: rows.zero_().index_add_(1, dest, src),
        bound(4 * b * (span_sum + n_multi * nz), b * span_sum),
        scatter=False, plain_reps=2,
        timed=lambda: kernels.fold_member_rows(nans, plan, running, spans))
    line["full_row_bound_ms"] = bound(4 * b * nz * (folded + n_multi),
                                      b * nz * folded)[0]
    line.update(rows=n_multi, segments=folded, span_cells=span_sum)
    if parent is not None:
        def fold_zeros():
            return kernels.fold_member_rows(zeros, plan, base.clone(), spans)

        def fold_running():
            return kernels.fold_member_rows(zeros, plan, running, spans)

        line["parent_ms"], line["new_ms_in_turns"] = compare_parent(
            f"fold_member_rows at {label}", lambda: parent.run(fold_zeros),
            fold_zeros, 20, pairs=3, new_timed=fold_running,
            parent_timed=lambda: parent.run(fold_running))
    del zeros, nans, src, rows, base, running
    return line


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
    lanes = kernels.zp_batched_lanes(
        pts.shape[0] * -(-b // kernels.MEMBER_GROUP), kernels.sm_count(dev))
    print(f"  the batched K1e at {label} (B={b}, {lanes} lanes a point, "
          f"{kernels.ZP_BATCHED_THREADS} threads a block): kernel "
          f"{ms:.4f} ms, {b} x K1e {loop_ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")
    line = dict(max_abs_err=err_v, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, points=pts.shape[0],
                unbatched_ms=loop_ms / b, looped_ms=loop_ms, lanes=lanes)
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
            ("zp@1240", "1,240 of config 5's endpoints", world.grid,
             ends[:1240].contiguous()),
            (f"zp@{n_outer}", f"config 5's {ends.shape[0]} endpoints",
             world.grid, ends),
            ("zp@edge", f"the {pts.shape[0]} edge-case points", grid, pts)):
        at.setdefault(key, {})["zp_value_grad_batched"] = batched_k1e_at(
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
    # the adaptive spectral gain (spectrum_blend 0.5): finite, live, and
    # a chunked run bitwise one call
    t1 = time.perf_counter()
    (bl,), _ = run(n_steps=n_steps, spectrum_blend=0.5)
    bl_c, _ = run(n_steps=n_steps, chunk=n_steps // 2, spectrum_blend=0.5)
    upd = float(torch.linalg.norm(ra.mean_seq[-1] - w.m_bg))
    moved = float(torch.linalg.norm(bl.mean_seq[-1] - ra.mean_seq[-1])) / upd
    check(bool(torch.isfinite(bl.ensemble).all()
               and torch.isfinite(bl.mean_seq).all()),
          "spectrum_blend 0.5: the final ensemble and the means finite")
    check(not torch.equal(bl.mean_seq, ra.mean_seq) and moved > 0,
          f"spectrum_blend 0.5 changes the filter: the last mean moved by "
          f"{moved:.3e} of blend 0's update")
    check(bool(torch.equal(bl.ensemble, bl_c[-1].ensemble)
               and torch.equal(bl.mean_seq, torch.cat(
                   [r.mean_seq for r in bl_c]))),
          f"spectrum_blend 0.5: {n_steps} steps in one call bitwise "
          f"{n_steps // 2} + {n_steps // 2} chained")
    blend_s = time.perf_counter() - t1
    print(f"  [spectrum_blend 0.5, one call and chained: {blend_s:.1f} s]")
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
                               "sha256": sha, "blend_moved": moved,
                               "blend_seconds": blend_s}
    results["enkf_launches"] = launches


def wall_ms(fn, reps=1) -> float:
    """Host-clock ms of ``fn`` from a synchronised start to a synchronised
    end (what a caller waits for, the gaps between launches included),
    mean over ``reps`` calls; no warm-up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return Timing((time.perf_counter() - t0) * 1e3 / reps, "host_clock")


class Laps:
    """``lap(what)`` prints the host seconds since the previous lap (or
    since the object was made): the run's time budget, part by part."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str):
        now = time.perf_counter()
        print(f"  [{what}: {now - self.t:.1f} s]")
        self.t = now


def device_launches(fn):
    """(kernel launches, device µs) of one call of ``fn`` from a profiler
    trace of the card's activity alone (no host operators recorded, which
    over a call of ~40,000 operators cost seconds): every kernel on the
    card, counted or not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def check_against_plain(tag, got, want, tol_x=1e-3, tol_t=1e-5):
    """A kernel trace (RayBundle, tec) against the plain tracer's: same
    shape, finite, path or endpoints within ``tol_x`` km, TEC within
    ``tol_t`` relative, ds equal. Returns (max|dx|, max relative dTEC)."""
    (b_k, t_k), (b_p, t_p) = got, want
    torch.cuda.synchronize()
    check(b_k.points.shape == b_p.points.shape,
          f"{tag}: shape {tuple(b_k.points.shape)}")
    check(bool(torch.isfinite(b_k.points).all() and torch.isfinite(t_k).all()),
          f"{tag}: finite")
    err_x = float((b_k.points - b_p.points).abs().max())
    err_t = float(((t_k - t_p).abs() / t_p.abs()).max())
    check(err_x <= tol_x and err_t <= tol_t,
          f"{tag}: max|dx| {err_x:.3e} km <= {tol_x:g} km, tau max rel err "
          f"{err_t:.3e} <= {tol_t:g} against the plain tracer")
    check(bool(torch.equal(b_k.ds, b_p.ds)), f"{tag}: ds equal")
    return err_x, err_t


def check_paths_against_plain(tag, kernel, plain, origins):
    """``kernel(keep_path)`` with the path kept and without, against one
    plain run with it kept (``check_against_plain``): the plain loop's
    ``keep_path`` only stacks what it keeps, so its endpoints are those of
    the run without. Returns [(max|dx|, max relative dTEC)] of the two."""
    from ionotomo_tpu_torch.geometry.rays import RayBundle

    b_p, t_p = plain(True)
    ends = RayBundle(points=torch.stack([origins, b_p.points[:, -1]], 1),
                     ds=b_p.ds)
    return [check_against_plain(f"{tag}, keep_path={kp}", kernel(kp), want)
            for kp, want in ((False, (ends, t_p)), (True, (b_p, t_p)))]


def phase14_tracers(dev, fermat, rays, kernels, Grid3D, chapman, results,
                    card, lap, parent=None, n_rays=262144, n_check=8192):
    """The tracers the port took last, at ``bench.py``'s configuration
    (128³ Chapman + perturbation, 262,144 rays, 150 MHz, 1000 km, no
    path) and at serving's geometry: K1r (rk4@64) on zp, cubic, zpc and
    quadratic beside the per-stage route it replaces, K1s (the split
    tracer, leapfrog@32 and rk4@64), the beam noise of one serving epoch
    and ``calc_rays`` bent."""
    from ionotomo_tpu_torch.core import (boxspline, triquadratic, tricubic,
                                         zpcubic)
    from ionotomo_tpu_torch.core.field_models import field_model
    from ionotomo_tpu_torch.forward.tec import dtec_noise_from_beam

    mods = {"boxspline": boxspline, "tricubic": tricubic,
            "zpcubic": zpcubic, "triquadratic": triquadratic}
    print("phase 14: K1r (rk4) on the four models, K1s (split), the beam "
          "noise of a serving epoch, calc_rays bent")
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    grid = grid_cpu.to(dev)
    m = torch.from_numpy(perturbed_log_field(
        grid_cpu, np.random.default_rng(14), chapman)).to(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(n_rays))
    oc, dc = (torch.from_numpy(a).to(dev) for a in bench_rays(n_check, 1))
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    rk4 = dict(n_steps=N_STEPS, keep_path=False, method="rk4")
    stage = results.setdefault("rk4_per_stage", {})

    for interp, (name, pack, mod, live, fstep, evaluator) in \
            RK4_TRACERS.items():
        model = field_model(interp)
        table = model.table(m, grid).contiguous()

        def per_stage():       # the parent's trace_rays(method="rk4")
            vg = fermat.field_evaluator(m, grid, interp)
            return fermat._trace_impl(fermat.log_field_ne_vg(vg), o, d,
                                      FREQ_HZ, LENGTH_KM, N_STEPS, False,
                                      "rk4")

        def route():
            return parent.run(per_stage) if parent is not None \
                else per_stage()

        def through_entry():
            return fermat.trace_rays(m, grid, o, d, FREQ_HZ, LENGTH_KM,
                                     interp=interp, **rk4)

        kernels.reset_launches()
        k_out = through_entry()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        check(launches[name] == 1, f"trace_rays(method='rk4') on {interp} "
                                   f"launched {name} once")
        check(all(launches[e] == 0 for e in EVALUATORS),
              f"trace_rays(method='rk4') on {interp} launched no K1e, K5, "
              f"K6z or K6q")
        sorted_ = launches["ray_order_keys"] == 1
        print(f"  {name} at {n_rays} rays: pack {launches[pack]}, sort keys "
              f"{launches['ray_order_keys']} ({'sorted and packed' if sorted_ else 'as it is'})")
        plain = {}
        plain_ms = wall_ms(lambda: plain.setdefault(
            "out", fermat.trace_rays_ref(m, grid, o, d, FREQ_HZ, LENGTH_KM,
                                         interp=interp, **rk4)))
        errs = [check_against_plain(f"{name} at {n_rays} rays", k_out,
                                    plain.pop("out"))]
        del k_out
        lap(f"K1r on {interp}: the plain tracer at {n_rays} rays")
        errs += check_paths_against_plain(
            f"{name} at {n_check} rays",
            lambda kp: fermat.trace_rays(m, grid, oc, dc, FREQ_HZ, LENGTH_KM,
                                         n_steps=N_STEPS, keep_path=kp,
                                         method="rk4", interp=interp),
            lambda kp: fermat.trace_rays_ref(m, grid, oc, dc, FREQ_HZ,
                                             LENGTH_KM, n_steps=N_STEPS,
                                             keep_path=kp, method="rk4",
                                             interp=interp), oc)
        lap(f"K1r on {interp}: {n_check} rays")
        check_trace_bitwise(f"phase 14, {n_rays} rays", kernels, name,
                            table, grid, o, d, kw, N_STEPS, parent=parent)
        tracer = getattr(kernels, name)

        def call():
            return tracer(table, grid, o, d, N_STEPS, False, **kw)

        ms = device_ms(call, 3)
        turns_k1r = compare_parent(
            f"{name} at {n_rays} rays", lambda: parent.run(call), call, 3,
            pairs=3) if parent is not None else None
        by_name = kernel_ms_by_name(call, 3)
        b_ms, b_by = trace_bound(mods[mod], live, tracer, 4 * fstep, table,
                                 grid, o, d, N_STEPS, False, kw)
        lap(f"K1r on {interp}: bitwise, timed")
        # the per-stage route: its launches (counted and in all) and device
        # time from one profiled run, then its host-clock time in turns
        reset_all_launches()
        n_all, dev_us = device_launches(route)
        s_launches = {evaluator: launched(evaluator)}
        check(s_launches[evaluator] == 1 + 4 * N_STEPS,
              f"the per-stage rk4 route on {interp} launched {evaluator} "
              f"1 + 4 x {N_STEPS} times")
        check(n_all > s_launches[evaluator] and dev_us > 0,
              f"the per-stage route's trace on {interp}: {n_all} kernels, "
              f"{dev_us:.1f} us of device time")
        turns = {"per_stage": [], "k1r": []}
        for who in ("per_stage", "k1r", "k1r", "per_stage"):
            turns[who].append(wall_ms(route if who == "per_stage"
                                      else through_entry))
        print(f"  {name}: the call (pack, sort, trace) {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); by kernel: "
              + "; ".join(f"{v:.4f} ms {k[:48]}" for k, v in sorted(
                  by_name.items(), key=lambda kv: -kv[1])))
        print(f"  rk4@{N_STEPS} on {interp}, {n_rays} rays, in turns on the "
              f"host clock (synchronised, prefilter included): the per-stage "
              f"route{' on the parent' if parent is not None else ''} "
              f"{', '.join(f'{x:.3f}' for x in turns['per_stage'])} ms "
              f"({s_launches[evaluator]} launches of {evaluator}, {n_all} "
              f"kernels in all, {dev_us:.1f} us of device time); "
              f"trace_rays through {name} "
              f"{', '.join(f'{x:.3f}' for x in turns['k1r'])} ms on {card}")
        stage[interp] = dict(ms=turns["per_stage"], launches=n_all,
                             evaluator_launches=s_launches[evaluator],
                             device_us=dev_us, k1r_ms=turns["k1r"])
        results[name] = {"launches": launches[name], "line": dict(
            max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None),
            "tau_rel": max(e[1] for e in errs)}
        if turns_k1r is not None:
            results[name]["line"]["parent_ms"], \
                results[name]["line"]["new_ms_in_turns"] = turns_k1r
        if interp == "quadratic":
            # K6q on the main path: none since K1r; the route's count apart
            results["quad_value_grad"]["launches"] = \
                launches["quad_value_grad"]
            results["quad_value_grad"]["route_not_a_path"] = {
                "per_stage_rk4_quadratic": s_launches["quad_value_grad"]}
        lap(f"K1r on {interp}: the per-stage route")
        del table
        torch.cuda.empty_cache()

    # K1s: the split tracer, single-layer background, at the bench's batch
    bg = chapman.background_ne_fn()
    bg_multi = chapman.background_ne_fn(
        layers=chapman.DEFAULT_LAYERS, curved=True, cos_chi=0.6,
        plasmasphere_n0=1e10)
    params = bg.kernel_params(dev)
    pert = fermat.split_perturbation(m, grid, bg).contiguous()
    params_multi = bg_multi.kernel_params(dev)
    pert_multi = fermat.split_perturbation(m, grid, bg_multi).contiguous()
    check(kernels.split_form(params) == "layer"
          and kernels.split_form(params_multi) == "general",
          "K1s: the single layer takes the one-layer form, 3 layers + "
          "curved + plasmasphere the general one")
    split, split_launches = {}, {}
    for method, steps in (("leapfrog", 32), ("rk4", N_STEPS)):
        is_rk4 = method == "rk4"
        c = fermat._step_constants(FREQ_HZ, LENGTH_KM, steps)
        kws = dict(n_steps=steps, keep_path=False, method=method)
        kernels.reset_launches()
        b, t = fermat.trace_rays_split(m, grid, o, d, FREQ_HZ, bg, LENGTH_KM,
                                       **kws)
        torch.cuda.synchronize()
        launches = split_launches[method] = dict(kernels.launches)
        for key, k in (("trace_split", 1), ("pack_z_taps", 1),
                       ("ray_order_keys", 1), ("cubic_value_grad", 0)):
            check(launches[key] == k, f"trace_rays_split, {method}@{steps}: "
                                      f"{key} launched {k} times")
        want = kernels.trace_split_with(
            pert, grid, o, d, steps, False, packed=None, order=None,
            threads=128, rk4=is_rk4, background=params, form="general", **c)
        # the parent's: both backgrounds, sorted and packed at the bench's
        # batch, and below the sort's threshold (384 rays an SM: packed in
        # ray order; n_check rays: the leapfrog's table as it is)
        n_mid = 384 * torch.cuda.get_device_properties(
            dev).multi_processor_count
        for what, pt, pm in (("single layer", pert, params),
                             ("3 layers, curved, plasmasphere", pert_multi,
                              params_multi)):
            for oo, dd, kp in ((o, d, False), (o, d, True),
                               (o[:n_mid], d[:n_mid], True), (oc, dc, True)):
                parent_bitwise(
                    parent, f"K1s {method}@{steps}, {what}, {oo.shape[0]} "
                            f"rays, keep_path={kp}",
                    lambda: kernels.trace_split(pt, grid, oo, dd, steps, kp,
                                                rk4=is_rk4, background=pm,
                                                **c))
        check(bool(torch.equal(t, want[1])
                   and torch.equal(b.points[:, -1], want[0])),
              f"K1s {method}@{steps} at {n_rays} rays, one-layer form, "
              f"packed and sorted, bitwise the unpacked general form in ray "
              f"order")
        plain = {}
        plain_ms = wall_ms(lambda: plain.setdefault(
            "out", fermat.trace_rays_split_ref(m, grid, o, d, FREQ_HZ, bg,
                                               LENGTH_KM, **kws)))
        errs = [check_against_plain(f"K1s {method}@{steps} at {n_rays} rays",
                                    (b, t), plain.pop("out"))]
        del b, t, want
        lap(f"K1s {method}@{steps}: the plain tracer at {n_rays} rays")
        for what, bgx in (("single layer", bg),
                          ("3 layers, curved, plasmasphere", bg_multi)):
            errs += check_paths_against_plain(
                f"K1s {method}@{steps} at {n_check} rays, {what}",
                lambda kp: fermat.trace_rays_split(
                    m, grid, oc, dc, FREQ_HZ, bgx, LENGTH_KM, n_steps=steps,
                    keep_path=kp, method=method),
                lambda kp: fermat.trace_rays_split_ref(
                    m, grid, oc, dc, FREQ_HZ, bgx, LENGTH_KM, n_steps=steps,
                    keep_path=kp, method=method), oc)

        def call():
            return kernels.trace_split(pert, grid, o, d, steps, False,
                                       rk4=is_rk4, background=params, **c)

        def as_tracer(table, g, oo, dd, n, kp, **cc):
            return kernels.trace_split(table, g, oo, dd, n, kp, rk4=is_rk4,
                                       background=params, **cc)

        def call_multi():
            return kernels.trace_split(pert_multi, grid, o, d, steps, False,
                                       rk4=is_rk4, background=params_multi,
                                       **c)

        ms = device_ms(call, 3)
        turns_k1s = turns_multi = None
        if parent is not None:
            turns_k1s = compare_parent(
                f"K1s {method}@{steps} at {n_rays} rays",
                lambda: parent.run(call), call, 3, pairs=3)
            turns_multi = compare_parent(
                f"K1s {method}@{steps} at {n_rays} rays, 3 layers, curved, "
                f"plasmasphere", lambda: parent.run(call_multi), call_multi,
                3, pairs=3)
        by_name = kernel_ms_by_name(call, 3)
        entry_ms = wall_ms(lambda: fermat.trace_rays_split(
            m, grid, o, d, FREQ_HZ, bg, LENGTH_KM, **kws), 3)
        evals = 4 if is_rk4 else 1
        b_ms, b_by = trace_bound(tricubic, 16, as_tracer,
                                 evals * (FLOPS_K1C_STEP + FLOPS_BACKGROUND),
                                 pert, grid, o, d, steps, False, c)
        table = m.reshape(N_GRID * N_GRID, N_GRID)
        k1c = device_ms(lambda: (kernels.trace_rk4_cubic if is_rk4 else
                                 kernels.trace_leapfrog_cubic)(
            table, grid, o, d, steps, False, **c), 3)
        print(f"  K1s {method}@{steps} at {n_rays} rays: the call (pack, sort, "
              f"trace) {ms:.4f} ms beside the full-field cubic call "
              f"{k1c:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); by kernel: " + "; ".join(
                  f"{v:.4f} ms {k[:48]}" for k, v in sorted(
                      by_name.items(), key=lambda kv: -kv[1])))
        print(f"  trace_rays_split {method}@{steps} at {n_rays} rays end to "
              f"end (the perturbation grid formed, host clock, synchronised, "
              f"3 calls): {entry_ms:.3f} ms a call on {card}")
        split[method] = dict(max_abs_err=max(e[0] for e in errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, n_steps=steps, cubic_ms=k1c,
                             entry_ms=entry_ms,
                             tau_rel=max(e[1] for e in errs))
        if turns_k1s is not None:
            split[method]["parent_ms"], split[method]["new_ms_in_turns"] = \
                turns_k1s
            split[method]["general_form_in_turns"] = dict(
                zip(("parent_ms", "new_ms"), turns_multi))
        lap(f"K1s {method}@{steps}")
    results["trace_split"] = {
        "launches": split_launches["leapfrog"]["trace_split"],
        "line": split["leapfrog"], "at": {"rk4_64": split["rk4"]}}
    del pert
    torch.cuda.empty_cache()

    # the beam noise of phase 4's first epoch: 62 x 10 rays x 8 paths on zp
    r, ants, dirs = serving_epochs()[0]
    m_np = perturbed_log_field(grid_cpu, r, chapman)
    m_s, a, dd = (torch.from_numpy(x).to(dev) for x in (m_np, ants, dirs))
    n_paths = 8
    eps_np = np.random.default_rng(14).standard_normal(
        (n_paths - 1, a.shape[0] * dd.shape[0], 2)).astype(np.float32)
    eps = torch.from_numpy(eps_np).to(dev)
    kwb = dict(n_paths=n_paths, max_length_km=LENGTH_KM, n_steps=N_STEPS,
               method="leapfrog", interp="zp")

    def epoch():
        return fermat.beam_noise_for_epoch(m_s, grid, a, dd, FREQ_HZ, eps,
                                           **kwb)

    kernels.reset_launches()
    noise = epoch()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    n_beam = n_paths * a.shape[0] * dd.shape[0]
    check(launches["trace_leapfrog_zp"] == 1,
          f"the beam noise traced its {n_beam} rays in one launch of K1")
    print(f"  beam noise: {n_beam} rays in one K1 call, pack "
          f"{launches['pack_zp_taps']}, sort keys "
          f"{launches['ray_order_keys']} ("
          f"{n_beam / torch.cuda.get_device_properties(dev).multi_processor_count:.1f}"
          f" rays an SM, threshold {kernels.TRACE_ZP_RAYS_PER_SM})")
    check(tuple(noise.shape) == (a.shape[0], dd.shape[0])
          and bool(torch.isfinite(noise).all()) and bool((noise[0] == 0).all()),
          "beam noise: (62, 10), finite, the reference antenna's row 0")
    stoch = fermat.trace_rays_stochastic(
        m_s, grid, *rays.make_ray_batch(a, dd), FREQ_HZ, eps, **kwb)
    o_cpu, d_cpu = rays.make_ray_batch(torch.from_numpy(ants),
                                       torch.from_numpy(dirs))
    m_cpu, eps_cpu = torch.from_numpy(m_np), torch.from_numpy(eps_np)
    stoch_p = fermat.trace_rays_stochastic(m_cpu, grid_cpu, o_cpu, d_cpu,
                                           FREQ_HZ, eps_cpu, **kwb)
    # beam_noise_for_epoch's plain route: the plain beam trace's spread
    # mapped by dtec_noise_from_beam
    noise_p = dtec_noise_from_beam(stoch_p[1], dirs.shape[0], 0)
    mu, sd, end = (x.cpu() for x in stoch)
    mu_p, sd_p, end_p = stoch_p
    scale = float(mu_p.abs().max())
    e_mu = float(((mu - mu_p).abs() / mu_p.abs()).max())
    e_sd = float((sd - sd_p).abs().max())
    e_end = float((end - end_p).abs().max())
    e_noise = float((noise.cpu() - noise_p).abs().max())
    check(e_mu <= 1e-5 and e_sd <= 2e-5 * scale and e_end <= 2e-3
          and e_noise <= 4e-5 * scale,
          f"beam noise against the plain route (CPU tensors): tec_mean "
          f"{e_mu:.3e} <= 1e-5 relative, tec_std {e_sd:.3e} <= 2e-5 x "
          f"max|tec| ({2e-5 * scale:.3e}), endpoint rms {e_end:.3e} km <= "
          f"2e-3 km, dTEC noise {e_noise:.3e} <= 4e-5 x max|tec| (the "
          f"tracer's 1e-5 relative on each of the paths; largest spread "
          f"{float(sd_p.max()):.3e}, noise {float(noise_p.max()):.3e})")
    o_s, d_s = rays.make_ray_batch(a, dd)
    d_all = fermat.beam_directions(d_s, eps, n_paths,
                                   (299792.458 / FREQ_HZ / LENGTH_KM) ** 0.5)
    per_path = [fermat.trace_rays(m_s, grid, o_s, d_all[p], FREQ_HZ,
                                  LENGTH_KM, n_steps=N_STEPS, keep_path=False,
                                  method="leapfrog", interp="zp")
                for p in range(n_paths)]
    tec = torch.stack([t for _, t in per_path])
    ends = torch.stack([b.points[:, -1] for b, _ in per_path])
    check(bool(torch.equal(stoch[0], tec.mean(0))
               and torch.equal(stoch[1], tec.std(0, correction=0))
               and torch.equal(stoch[2], torch.sqrt(
                   ((ends - ends.mean(0)[None]) ** 2).sum(-1).mean(0)))),
          "the flattened beam trace bitwise a per-path loop of K1")
    beam_ms = cuda_ms(epoch, 20)
    print(f"  beam noise of one serving epoch: {beam_ms:.3f} ms (CUDA "
          f"events, 20 calls, prefilter included) beside phase 4's "
          f"{results['ms_per_epoch']:.3f} ms per epoch on {card}")
    results["beam_noise"] = dict(ms=beam_ms, errors=(e_mu, e_sd, e_end,
                                                     e_noise),
                                 launches=launches)
    lap("beam noise")

    # calc_rays bent at the same geometry: K1c with its path
    kernels.reset_launches()
    rb = rays.calc_rays(a, dd, m_s, grid, FREQ_HZ, straight_line_approx=False,
                        max_length_km=LENGTH_KM, n_samples=N_STEPS + 1)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["trace_leapfrog_cubic"] == 1
          and launches["pack_z_taps"] == 1,
          "calc_rays bent launched K1c and its pack once")
    o_s, d_s = rays.make_ray_batch(a, dd)
    ref = fermat.trace_rays_ref(m_s, grid, o_s, d_s, FREQ_HZ, LENGTH_KM,
                                n_steps=N_STEPS, keep_path=True,
                                method="leapfrog", interp="cubic")
    check(rb.points.shape == ref[0].points.shape == (o_s.shape[0],
                                                     N_STEPS + 1, 3),
          f"calc_rays bent: {tuple(rb.points.shape)}")
    err = float((rb.points - ref[0].points).abs().max())
    check(err <= 1e-3, f"calc_rays bent: path max|dx| {err:.3e} km <= 1e-3 "
                       f"km against the plain tracer")
    c_ms = device_ms(lambda: rays.calc_rays(
        a, dd, m_s, grid, FREQ_HZ, straight_line_approx=False,
        max_length_km=LENGTH_KM, n_samples=N_STEPS + 1), 20)
    print(f"  calc_rays bent, {tuple(rb.points.shape)}: {c_ms:.4f} ms of "
          f"device time, path max|dx| {err:.3e} km against the plain tracer")
    results["calc_rays"] = dict(ms=c_ms, max_abs_err=err)
    lap("calc_rays bent")


#: The service phase: epoch files in the watch stream, epochs left out of
#: the latency statistics as warm-up, and adaptive R's EMA weight (the
#: reference's adaptive test, tests/test_online.py:279).
SERVICE_EPOCHS = 110
SERVICE_WARMUP = 5
SERVICE_ADAPT_R = 0.3
#: The service on the card against the CPU service, one step from the
#: same state: the limit on the field's relative L2 difference (over the
#: plain service's departure from the prior), and on the held-out dTEC
#: rms's relative difference. On an H100 the first three epochs read
#: 0.43, 1.2 and 2.4 % and 0.12, 0.41 and 0.88 % (the same to four
#: digits in two runs: f32 CG's 40 iterations from the same state, in
#: another summation order), and a step with K2's or K3's output rounded
#: to bfloat16 reads 16 or 13 % of the field (held-out 0.52 and 1.6 %:
#: that metric does not tell them apart; the field's does).
SERVICE_FIELD_LIMIT = 5e-2
SERVICE_HELDOUT_LIMIT = 1e-2


def service_class():
    """``serving.EpochService`` over epoch files held in memory: the card's
    machine has no h5py, so the DataPacks are read from a dict by file
    name (the watch directory holds empty placeholders, so the service's
    own listing, ordering and exactly-once bookkeeping run as they are)
    and each Solution is kept as the SHA-256 of its arrays (and, for the
    first ``keep`` epochs, the field itself). The state file, the JSONL
    records and the sounding files are the service's own files."""
    from ionotomo_tpu_torch.serving import EpochService

    class MemoryService(EpochService):
        def __init__(self, packs, *args, keep=0, **kw):
            self.packs, self.keep = packs, keep
            self.digests, self.fields = {}, {}
            self.spent = {}          # host seconds by part, a call each
            super().__init__(*args, **kw)

        def _timed(self, part, fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.spent.setdefault(part, []).append(time.perf_counter() - t0)
            return out

        def _step(self, *args, **kw):
            return self._timed("filter step", super()._step, *args, **kw)

        def _normals(self, *args):
            return self._timed("draws", super()._normals, *args)

        def _save_state(self):
            return self._timed("state file", super()._save_state)

        def read_epoch(self, path):
            return self.packs[Path(path).name]

        def write_solution(self, sol, path):
            t0 = time.perf_counter()
            h = hashlib.sha256(np.ascontiguousarray(sol.m).tobytes())
            for k in sorted(sol.diagnostics):
                h.update(np.ascontiguousarray(sol.diagnostics[k]).tobytes())
            self.digests[Path(path).name] = h.hexdigest()
            if len(self.fields) < self.keep:
                self.fields[Path(path).name] = sol.m[0]
            self.spent.setdefault("Solution SHA-256", []).append(
                time.perf_counter() - t0)

    return MemoryService


def service_dir(name, under="service") -> Path:
    """An empty directory under the checkout's ``build/<under>``."""
    d = Path(__file__).resolve().parent / "build" / under / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def arrive(watch, names):
    """Epoch files appear in the watch directory (empty placeholders of
    ``service_class``'s in-memory packs)."""
    for name in names:
        (watch / name).touch()


def service_stream(dev, n_epochs, seed=0, **kw):
    """``data.synth`` at its defaults (62 antennas, 10 directions, 30 s
    cadence, 150 MHz, a 64³ drifting turbulent truth) over ``n_epochs``
    epochs, cut into one-epoch DataPacks {file name: pack}, and the truth
    with held-out rays: 62 antennas toward 2 other directions around the
    same phase centre, and their noise-free dTEC per epoch."""
    from ionotomo_tpu_torch.data import synth
    from ionotomo_tpu_torch.data.datapack import DataPack
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import rays

    dp, truth = synth.generate_example_datapack(n_times=n_epochs, seed=seed,
                                                device=dev, **kw)
    packs = {f"epoch_{t:04d}.h5": dp.select(times=[t])
             for t in range(n_epochs)}
    pc = synth.zenith_phase_center(dp.array, dp.times.mean())
    ho = DataPack(dp.array, synth.choose_directions(pc, 2, seed=seed + 99),
                  dp.times)
    ants = torch.as_tensor(dp.antennas_enu().astype(np.float32), device=dev)
    dirs = torch.as_tensor(ho.directions_enu().astype(np.float32),
                           device=dev)
    bundles, want = [], []
    for t in range(n_epochs):
        o, d = rays.make_ray_batch(ants, dirs[t])
        rb = rays.sample_straight_rays(o, d)
        bundles.append(rb)
        want.append(tec.dtec_paired(
            torch.as_tensor(truth["m"][t], device=dev), truth["grid"], rb,
            2, 0))
    truth["heldout"] = (bundles, want)
    return packs, truth


def heldout_rms(m, grid, truth, t, cfg) -> float:
    """rms of (the field's dTEC − the truth's) over epoch t's held-out
    rays, through the service's forward model."""
    from ionotomo_tpu_torch.forward import tec
    bundles, want = truth["heldout"]
    m = torch.as_tensor(m, device=grid.device)
    pred = tec.dtec_paired_q(m, grid, bundles[t], 2, 0, cfg.rays.quadrature,
                             cfg.rays.interp)
    return float(torch.sqrt(torch.mean((pred - want[t]) ** 2)))


def service_config(shape=None, **solver):
    """``EngineConfig``'s defaults (128³, cubic, Hermite, 129 samples, cg
    40, the point filter), with adaptive R and the given solver fields."""
    from ionotomo_tpu_torch.config import EngineConfig
    c = EngineConfig()
    solver = dict(dict(adapt_r=SERVICE_ADAPT_R), **solver)
    c = dataclasses.replace(c, solver=dataclasses.replace(c.solver,
                                                          **solver))
    if shape is not None:
        c = dataclasses.replace(c, grid=dataclasses.replace(
            c.grid, shape=tuple(shape)))
    return c


def jsonl(out):
    return [json.loads(line) for line in open(out / "epochs.jsonl")]


def quantiles(xs):
    xs = np.asarray(xs, np.float64)
    return (float(np.median(xs)), float(np.percentile(xs, 90)),
            float(xs.max()))


def geometry_build_ms(dev, svc, packs, names, tec, rays):
    """Host ms (synchronised) of the geometry an epoch's step builds for
    its new bundle: the point set-up, the two row plans and the point
    order, as ``kalman._Geometries`` builds them; median over ``names``,
    and the last name's geometry (``tec.DtecGeometry``)."""
    c = svc.config
    out = []
    for name in names:
        dp = packs[name]
        a = dp.to_device_arrays()
        o, d = rays.make_ray_batch(
            torch.as_tensor(a["antennas_enu"], device=dev),
            torch.as_tensor(a["directions_enu"][0], device=dev))
        rb = rays.sample_straight_rays(o, d, c.physics.max_length_km,
                                       c.rays.n_samples)
        sync(dev)
        t0 = time.perf_counter()
        geo = tec.DtecGeometry(svc.grid, rb, dp.shape[2], 0,
                               c.rays.quadrature, c.rays.interp,
                               dev.type == "cuda")
        if dev.type == "cuda":
            geo.point_order()
        sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), geo


def service_kernels_at(geo, field, tricubic, kernels, probes, rng,
                       parent=None):
    """Every kernel of the service's path, alone at the shapes an epoch
    gives it, against its plain version (``geo``: an epoch's geometry;
    ``field``: the service's state): K2 over the geometry's point order,
    the order's keys and permute, K3 of a random cotangent, K5 at the
    endpoints and K5ᵀ adding into a K3 table there, and K2b with its pack
    over the adaptive-R probes' member axis (``probes`` random tables);
    with a parent, the keys and the permute in turns with the parent's.
    Returns {kernel name: line}."""
    grid, (n_rows, nz) = geo.grid, geo.table_shape
    setup, xy = (geo.ri, geo.wxy, geo.zi, geo.wz), geo.model.xy_first
    n, n_ends, b = geo.ri.shape[0], geo.ends.shape[0], probes
    k, l = geo.ri.shape[1], geo.zi.shape[1]
    label = f"the service's {n} points"
    table = geo.model.table(field, grid).contiguous()

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(table.device)

    out = {}
    order = k2_order_check(label, kernels, tricubic, tricubic, table, grid,
                           geo.points, setup, xy)
    check(bool(torch.equal(order.order, geo.point_order().order)),
          "the service's geometry keeps the point order K2's wrapper makes")
    out["rows_value_fwd"] = check_and_time(
        f"K2 at {label} (K={k}, L={l})",
        lambda: tricubic.rows_value(table, *setup, xy, order=order),
        lambda: tricubic.rows_value_ref(table, *setup, xy), None,
        k2_bound(*setup, n_rows, nz, k, FLOPS_K2_CUBIC_POINT),
        scatter=False)
    out["point_order_keys"], out["permute_points"] = point_order_line(
        label, kernels, tricubic, grid, geo.points, setup, parent)
    ct, plan = randn(n), geo.row_plan

    def k3():
        return tricubic.rows_value_transpose(ct, *setup, geo.table_shape,
                                             plan)
    out["rows_value_bwd"] = check_and_time(
        f"K3 at {label} ({plan_stats(plan)['pairs']} pairs)", k3,
        lambda: tricubic.rows_value_transpose_ref(ct, *setup,
                                                  geo.table_shape),
        index_add_call(*tricubic.transpose_terms(ct, *setup,
                                                 geo.table_shape),
                       n_rows * nz),
        k3_bound(ct, *setup, plan, nz), scatter=True)
    ends = geo.ends
    out["cubic_value_grad"] = check_k5(
        f"K5 at the service's {n_ends} endpoints", tricubic, kernels, table,
        grid, ends)
    out["cubic_value_grad_bwd"] = check_k5t(
        f"K5T at the service's {n_ends} endpoints", tricubic, kernels, grid,
        ends, randn(n_ends), randn(n_ends, 3), geo.end_plan, k3(),
        reps=50, plain_reps=5)
    tables = randn(b, n_rows, nz)

    def k2b():
        return tricubic.rows_value(tables, *setup, xy)

    got = k2b()
    check(all(bool(torch.equal(got[m], kernels.rows_value_fwd(
        tables[m], *setup, xy))) for m in range(b)),
          f"K2b at {label}: every member bitwise equal to K2 on that member")
    del got
    out["rows_value_fwd_batched"] = check_and_time(
        f"K2b at {label} (B={b}, K={k}, L={l})", k2b,
        lambda: tricubic.rows_value_ref(tables, *setup, xy), None,
        bound(nbytes(*setup) + 4 * b * (touched_values(geo.ri, geo.zi,
                                                       n_rows, nz) + n),
              b * n * (2 * k * l + 2 * l)), scatter=False)
    out["pack_members"] = pack_members_line(label, tricubic, kernels, tables)
    check(not bool(plan.counters.any() or geo.end_plan.counters.any()),
          "the service geometry's plan counters back at zero")
    return out


@contextlib.contextmanager
def rounded_to_bf16(kernels, name):
    """A control: the wrapper ``kernels.<name>`` returns its output rounded
    to bfloat16 (8 bits of mantissa), as a kernel computing in a lower
    precision would."""
    wrapper = getattr(kernels, name)

    def rounded(*args, **kw):
        return wrapper(*args, **kw).to(torch.bfloat16).to(torch.float32)

    setattr(kernels, name, rounded)
    try:
        yield
    finally:
        setattr(kernels, name, wrapper)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_call(label, fn):
    """One call of ``fn`` under torch.profiler: host wall, device busy
    time, launches, busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms_ = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    n = sum(r[2] for r in rows)
    print(f"  profiled {label}: wall {wall_ms_:.3f} ms (profiler on),"
          f" device busy {busy_ms:.3f} ms in {n} launches, busy share "
          f"{busy_ms / wall_ms_:.3f}; top kernels:")
    for key, us, count in rows[:12]:
        print(f"    {us / 1e3:9.4f} ms {count:5d}x  {key[:90]}")
    return {"wall_ms": wall_ms_, "busy_ms": busy_ms, "launches": n,
            "busy_share": busy_ms / wall_ms_,
            "top": [[k[:90], us / 1e3, c] for k, us, c in rows[:12]]}


def profile_service_epoch(svc, watch, name):
    """One epoch of the service under torch.profiler (``profile_call``)."""
    def epoch():
        arrive(watch, [name])
        check(svc.process_available() == 1, "the profiled epoch assimilated")
    return profile_call(f"epoch ({name})", epoch)


def phase15_service(dev, kernels, results, n_epochs=SERVICE_EPOCHS,
                    warmup=SERVICE_WARMUP, shape=None, n_cpu=3,
                    enkf_epochs=6, solver=None, parent=None):
    """The streaming epoch service (``serving.EpochService``) at
    ``EngineConfig``'s defaults with adaptive R over ``n_epochs`` epochs of
    the synthetic stream, driven through ``process_available`` as a user
    runs it, epoch by epoch as the files arrive: its latency (the service's
    own seconds a step and the host clock around each poll), rays/s, the
    geometry an epoch builds, every kernel of the path alone at the shapes
    it gives them, one profiled epoch, the launches of its kernels,
    restart identity (the stream split at half), each of the first
    ``n_cpu`` epochs against the same service on the CPU (the plain
    versions) one step at a time with a control, an ensemble service with
    its restart identity, and one epoch each with beam noise, a sounding
    and the spectrum diagnostic, three with ``interp="zp"``. ``shape`` and
    ``solver`` (a dict of solver fields) shrink it for a rehearsal on the
    CPU."""
    from ionotomo_tpu_torch import serving
    from ionotomo_tpu_torch.core import tricubic
    from ionotomo_tpu_torch.data import ionosonde
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import rays
    from ionotomo_tpu_torch.testing import SERVICE_KERNELS

    print("phase 15: the streaming service (EpochService, 128^3 cubic "
          "defaults, adaptive R)")
    Service = service_class()
    t0 = time.perf_counter()
    packs, truth = service_stream(dev, n_epochs + 1)
    sync(dev)
    names = sorted(packs)
    stream, extra = names[:n_epochs], names[n_epochs]
    na, _, nd = packs[names[0]].shape
    print(f"  stream: {n_epochs} one-epoch files ({na} antennas x {nd} "
          f"directions, 30 s cadence, {packs[names[0]].frequency_hz / 1e6:g}"
          f" MHz) + 1 profiled, made in {time.perf_counter() - t0:.2f} s")
    solver = solver or {}
    cfg = service_config(shape, **solver)
    wind = dict(wind_kmps=tuple(float(v) for v in truth["wind_kmps"]))
    print(f"  config: grid {cfg.grid.shape}, interp {cfg.rays.interp}, "
          f"{cfg.rays.quadrature}, {cfg.rays.n_samples} samples, cg "
          f"{cfg.solver.cg_iters}, adapt_r {cfg.solver.adapt_r}; wind "
          f"{wind['wind_kmps']} km/s")
    watch, out = service_dir("watch"), service_dir("out")
    svc = Service(packs, watch, out, cfg, device=dev, **wind)
    half = n_epochs // 2
    out_b = service_dir("out_restart")
    host_ms, polled = [], []
    kernels.reset_launches()
    for e, name in enumerate(stream):
        sync(dev)
        t1 = time.perf_counter()
        arrive(watch, [name])
        polled.append(svc.process_available())
        sync(dev)
        host_ms.append((time.perf_counter() - t1) * 1e3)
        if e + 1 == half:          # what a crash here would leave
            shutil.copytree(out, out_b, dirs_exist_ok=True)
    launches = {k: v for k, v in kernels.launches.items() if v}
    check(polled == [1] * n_epochs and svc.filter.t == n_epochs
          and len(svc.digests) == n_epochs,
          f"{n_epochs} epochs assimilated one a poll, one Solution each")
    print(f"  launches on the service path ({n_epochs} epochs): {launches}")
    if dev.type == "cuda":
        for k in SERVICE_KERNELS:
            check(launches.get(k, 0) > 0, f"{k} launched on the service path "
                                          f"({launches.get(k, 0)} times)")
    recs = [r for r in jsonl(out) if "epoch" in r and "event" not in r]
    check([r["epoch"] for r in recs] == list(range(n_epochs)),
          "one JSONL record an epoch, in order")
    better = sum(r["post_residual"] < r["pre_residual"] for r in recs)
    check(better >= 0.9 * n_epochs, f"post-update residual below the "
                                    f"pre-update residual in {better} of "
                                    f"{n_epochs} epochs")
    check(all(np.isfinite(r["r_scale"]) for r in recs)
          and recs[-1]["r_scale"] != 1.0, f"adaptive R moved: r_scale "
          f"{recs[0]['r_scale']:.4f} -> {recs[-1]['r_scale']:.4f}")
    step_ms = [1e3 * r["seconds"] for r in recs][warmup:]
    host = host_ms[warmup:]
    sq, hq = quantiles(step_ms), quantiles(host)
    rays_per_s = na * nd / (hq[0] / 1e3)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"  epoch latency over {len(host)} epochs after {warmup} warm-up "
          f"({card}): the service's seconds (filter step, ms resolution) "
          f"median {sq[0]:.1f} ms, p90 {sq[1]:.1f}, max {sq[2]:.1f}; host "
          f"clock around each poll median {hq[0]:.3f} ms, p90 {hq[1]:.3f}, "
          f"max {hq[2]:.3f}; {rays_per_s:.1f} rays/s at the median")
    print(f"  warm-up epochs (host ms): "
          + ", ".join(f"{v:.1f}" for v in host_ms[:warmup]))
    parts = {k: 1e3 * float(np.median(v[warmup:]))
             for k, v in svc.spent.items() if len(v) > warmup}
    print("  host clock an epoch by part (median ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f"; the rest of the "
          f"poll {hq[0] - sum(v for k, v in parts.items() if k != 'draws'):.3f}"
          f" (the draws are inside the filter step; torch CPU threads "
          f"{torch.get_num_threads()})")
    geo_ms, geo = geometry_build_ms(dev, svc, packs, stream[:5], tec, rays)
    print(f"  an epoch's geometry (point set-up, two row plans, point "
          f"order): {geo_ms:.3f} ms (median of 5, host clock, synchronised)")
    at = (service_kernels_at(geo, svc.filter.m, tricubic, kernels,
                             serving.STATS_PROBES, np.random.default_rng(15),
                             parent)
          if dev.type == "cuda" else {})
    del geo
    h_prior = heldout_rms(svc.filter.m_clim, svc.grid, truth, n_epochs - 1,
                          cfg)
    h_last = heldout_rms(svc.filter.m, svc.grid, truth, n_epochs - 1, cfg)
    check(h_last < h_prior, f"held-out dTEC rms at epoch {n_epochs - 1}: "
                            f"{h_last:.3f} below the prior's {h_prior:.3f}")
    prof = (profile_service_epoch(svc, watch, extra) if dev.type == "cuda"
            else None)

    # restart identity: the stream split at half. The output directory as
    # the uninterrupted service left it after epoch half - 1 (its state
    # file and records), resumed by a new service over the whole stream
    watch_b = service_dir("watch_restart")
    arrive(watch_b, stream)
    second = Service(packs, watch_b, out_b, cfg, device=dev, **wind)
    check(second.filter.t == half and second.processed == stream[:half],
          f"the restarted service resumes at epoch {half}")
    check(second.process_available() == n_epochs - half,
          f"second half: {n_epochs - half} epochs")
    want = {k: v for k, v in svc.digests.items() if k in second.digests}

    def stable(recs):              # the records, host timings left out
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in recs if r.get("epoch", 0) < n_epochs]
    check(second.digests == want and len(want) == n_epochs - half
          and stable(jsonl(out_b)) == stable(jsonl(out)),
          f"restart at epoch {half}: the SHA-256 of the {n_epochs - half} "
          f"later Solutions and the JSONL records equal the uninterrupted "
          f"run's")

    # the kernel path against the plain path, one step at a time: before
    # each of the first n_cpu epochs a service on the card resumes from
    # the output directory the CPU service has left (as a restart does)
    # and runs that epoch, so each reading is one step's difference and
    # not the drift of carried states. The controls run one of those
    # steps with a kernel's output rounded to bfloat16.
    cpu = torch.device("cpu")
    watch_p, out_p = service_dir("watch_plain"), service_dir("out_plain")
    plain = Service(packs, watch_p, out_p, cfg, keep=n_cpu, device=cpu,
                    **wind)
    prior = svc.filter.m_clim.cpu().numpy()

    def card_step(e, tag):
        w_, o_ = service_dir(f"watch_{tag}_{e}"), service_dir(f"out_{tag}_{e}")
        shutil.copytree(out_p, o_, dirs_exist_ok=True)
        arrive(w_, stream[:e + 1])
        one = Service(packs, w_, o_, cfg, keep=1, device=dev, **wind)
        check(one.filter is None if e == 0 else one.filter.t == e,
              f"{tag}: the card service resumes the CPU service's state at "
              f"epoch {e}")
        check(one.process_available() == 1, f"{tag}: epoch {e} on the card")
        return one.fields[f"epoch_{e:06d}.h5"]

    def reading(got, ref, e):
        rel = float(np.linalg.norm((got - ref).astype(np.float64))
                    / np.linalg.norm((ref - prior).astype(np.float64)))
        hk = heldout_rms(got, svc.grid, truth, e, cfg)
        hp = heldout_rms(ref, svc.grid, truth, e, cfg)
        return rel, abs(hk - hp) / hp, hk, hp

    e_ctrl = min(1, n_cpu - 1)
    controls = ("rows_value_fwd", "rows_value_bwd") \
        if dev.type == "cuda" else ()
    steps, ctrl, plain_s = [], {}, []
    for e, name in enumerate(stream[:n_cpu]):
        got = card_step(e, "step")
        if e == e_ctrl:
            for kname in controls:
                with rounded_to_bf16(kernels, kname):
                    ctrl[kname] = card_step(e, f"control_{kname}")
        arrive(watch_p, [name])
        t1 = time.perf_counter()
        check(plain.process_available() == 1, f"epoch {e} on the CPU")
        plain_s.append(time.perf_counter() - t1)
        ref = plain.fields[f"epoch_{e:06d}.h5"]
        steps.append(reading(got, ref, e))
        if e == e_ctrl:
            ctrl = {k: reading(f, ref, e) for k, f in ctrl.items()}
    print("  one step on the card against the CPU service (relative L2 of "
          "the field over the update, held-out dTEC rms): " + "; ".join(
              f"epoch {e} {rel:.3e}, {dh:.3e}"
              for e, (rel, dh, _, _) in enumerate(steps)) + "; controls at "
          f"epoch {e_ctrl}: " + "; ".join(
              f"{k} in bfloat16 {rel:.3e}, {dh:.3e}"
              for k, (rel, dh, _, _) in ctrl.items()))
    for e, (rel, dh, hk, hp) in enumerate(steps):
        check(rel <= SERVICE_FIELD_LIMIT and dh <= SERVICE_HELDOUT_LIMIT,
              f"epoch {e}, one step from the CPU service's state: field "
              f"within {SERVICE_FIELD_LIMIT:.0e} of the plain service's "
              f"update (relative L2 {rel:.3e}), held-out dTEC rms {hk:.4f} "
              f"within {SERVICE_HELDOUT_LIMIT:.0e} of its {hp:.4f} "
              f"(relative {dh:.3e})")
    for kname, (rel, dh, hk, hp) in ctrl.items():
        check(rel > SERVICE_FIELD_LIMIT, f"control, {kname}'s output "
              f"rounded to bfloat16 at epoch {e_ctrl}: field's relative L2 "
              f"{rel:.3e} past the limit {SERVICE_FIELD_LIMIT:.0e} (held-out "
              f"dTEC rms {hk:.4f} against {hp:.4f}, relative {dh:.3e})")
    plain_s = float(np.median(plain_s))
    print(f"  the plain service on the CPU: {plain_s:.2f} s an epoch")
    # the ensemble service, 8 members, and its restart identity
    ecfg = service_config(shape, **dict(solver, solver="enkf",
                                        enkf_members=8, adapt_r=0.0))
    e_watch, e_out = service_dir("watch_enkf"), service_dir("out_enkf")
    ens = Service(packs, e_watch, e_out, ecfg, device=dev, **wind)
    kernels.reset_launches()
    arrive(e_watch, stream[:enkf_epochs])
    sync(dev)
    t1 = time.perf_counter()
    check(ens.process_available() == enkf_epochs, f"ensemble service: "
                                                  f"{enkf_epochs} epochs")
    sync(dev)
    ens_s = (time.perf_counter() - t1) / enkf_epochs
    e_launch = {k: v for k, v in kernels.launches.items() if v}
    sha = hashlib.sha256(ens.filter.ens.cpu().numpy().tobytes()).hexdigest()
    eb_watch, eb_out = service_dir("watch_enkf_b"), service_dir("out_enkf_b")
    arrive(eb_watch, stream[:enkf_epochs // 2])
    a = Service(packs, eb_watch, eb_out, ecfg, device=dev, **wind)
    a.process_available()
    dig = dict(a.digests)
    del a
    arrive(eb_watch, stream[enkf_epochs // 2:enkf_epochs])
    b = Service(packs, eb_watch, eb_out, ecfg, device=dev, **wind)
    b.process_available()
    dig.update(b.digests)
    check(dig == ens.digests and hashlib.sha256(
        b.filter.ens.cpu().numpy().tobytes()).hexdigest() == sha,
        f"ensemble service restarted at {enkf_epochs // 2}: the Solutions "
        f"(mean and spread) and the final ensemble bitwise (SHA-256 "
        f"{sha[:16]})")
    print(f"  ensemble service (8 members): {ens_s * 1e3:.1f} ms an epoch "
          f"(host clock); launches {e_launch}")

    # one epoch each: beam noise (K1c), the spectrum diagnostic, a sounding
    xcfg = dataclasses.replace(
        cfg, rays=dataclasses.replace(cfg.rays, beam_noise=8),
        solver=dataclasses.replace(cfg.solver, diag_spectrum_every=1))
    x_watch, x_out = service_dir("watch_extra"), service_dir("out_extra")
    x = Service(packs, x_watch, x_out, xcfg, device=dev, **wind)
    kernels.reset_launches()
    arrive(x_watch, stream[:1])
    sync(dev)
    t1 = time.perf_counter()
    check(x.process_available() == 1, "beam noise 8 + spectrum: one epoch")
    sync(dev)
    x_ms = (time.perf_counter() - t1) * 1e3
    x_launch = {k: v for k, v in kernels.launches.items() if v}
    grid = x.grid
    origin = grid.origin.cpu().numpy().astype(np.float64)
    span = grid.spacing.cpu().numpy() * (np.asarray(grid.shape) - 1)
    probes = ionosonde.bottomside_probes(
        torch.as_tensor(truth["m"][1], device=dev), truth["grid"],
        [[origin[0] + 0.5 * span[0], origin[1] + 0.5 * span[1]]],
        n_per_station=8, noise_log=0.05, seed=1)
    ionosonde.probes_to_npz(x_watch / "a.sounding.npz", probes)
    arrive(x_watch, stream[1:2])
    check(x.process_available() == 1, "a sounding and an epoch")
    xr = jsonl(x_out)
    beams = [r for r in xr if r.get("event") == "beam_noise"]
    spec = [r for r in xr if r.get("event") == "update_spectrum"]
    snd = [r for r in xr if r.get("event") == "sounding"]
    check(len(beams) == 2 and all(r["max"] >= r["mean"] > 0 for r in beams),
          f"beam noise logged every epoch: {beams[0]}")
    check(len(spec) == 2 and all(s["lam"][0] >= s["lam"][-1] >= 0.9
                                 for s in spec),
          f"update spectrum every epoch, kappa_bound "
          f"{spec[0]['kappa_bound']:.1f}, lam[-1] {spec[0]['lam'][-1]:.3f}")
    check(len(snd) == 1 and snd[0]["n_probes"] == 8
          and snd[0]["mean_abs_dlogne"] > 0, f"sounding assimilated: {snd}")
    if dev.type == "cuda":
        for k in ("trace_leapfrog_cubic", "rows_value_fwd_batched",
                  "rows_value_bwd_batched"):
            check(x_launch.get(k, 0) > 0, f"{k} launched by beam noise and "
                                          f"the spectrum")
    print(f"  beam noise 8 + spectrum epoch: {x_ms:.1f} ms (host); "
          f"launches {x_launch}")

    # three epochs on the zp model
    zcfg = dataclasses.replace(cfg, rays=dataclasses.replace(cfg.rays,
                                                             interp="zp"))
    z_watch, z_out = service_dir("watch_zp"), service_dir("out_zp")
    z = Service(packs, z_watch, z_out, zcfg, device=dev, **wind)
    kernels.reset_launches()
    arrive(z_watch, stream[:3])
    sync(dev)
    t1 = time.perf_counter()
    check(z.process_available() == 3, "zp service: 3 epochs")
    sync(dev)
    z_ms = (time.perf_counter() - t1) * 1e3 / 3
    z_launch = {k: v for k, v in kernels.launches.items() if v}
    zr = [r for r in jsonl(z_out) if "event" not in r]
    check(all(np.isfinite(r["post_residual"]) for r in zr)
          and z.filter.m.isfinite().all(), f"zp: finite fields, residuals "
          + ", ".join(f"{r['pre_residual']:.0f} -> {r['post_residual']:.0f}"
                      for r in zr))
    if dev.type == "cuda":
        for k in ("zp_value_grad", "zp_value_grad_bwd"):
            check(z_launch.get(k, 0) > 0, f"zp: {k} launched")
    print(f"  zp service: {z_ms:.1f} ms an epoch (host); launches {z_launch}")
    results["service"] = {
        "epochs": n_epochs, "warmup": warmup, "step_ms": sq,
        "host_ms": hq, "rays_per_s": rays_per_s, "geometry_ms": geo_ms,
        "heldout": [h_prior, h_last], "launches": launches, "at": at,
        "steps": steps, "controls": ctrl,
        "limits": [SERVICE_FIELD_LIMIT, SERVICE_HELDOUT_LIMIT],
        "profile": prof, "plain_s_per_epoch": plain_s,
        "enkf_ms_per_epoch": ens_s * 1e3, "enkf_sha256": sha,
        "extra_ms": x_ms, "zp_ms_per_epoch": z_ms, "card": card}


#: Phase 16, the batch inversion: timesteps of the default-mode run, and
#: the limits of one snapshot solve on the card against the same solve on
#: the CPU (relative L2 of the field over the update, relative held-out
#: dTEC rms), set from the readings on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md): sound 1.8e-3 and 2.7e-3; K2's output in bfloat16 3.2e-2 and
#: 1.1e-2, K3's 1.0e-1 and 2.8e-2. The field limit sits 5.7 x above the
#: sound reading and 3.2 x below the nearer control; the held-out limit
#: 3.7 x above the sound reading, with K2's control just past it (so the
#: field limit is the one that must fail a wrong kernel).
INVERT_TIMES = 8
INVERT_FIELD_LIMIT = 1e-2
INVERT_HELDOUT_LIMIT = 1e-2


def invert_world(dev):
    """``data.synth`` at its defaults (62 antennas x 10 directions, 150 MHz,
    30 s cadence, a 64^3 drifting turbulent truth) over ``INVERT_TIMES``
    timesteps, in memory, with the truth's wind on the DataPack; and the
    held-out rays: 20 of the array's antennas (drawn, seed 99) toward 50
    other directions around the phase centre (seed 99), with the truth's
    dTEC over them at each timestep (generalisation to new directions, as
    phase 15's held-out rays)."""
    from ionotomo_tpu_torch.data import synth
    from ionotomo_tpu_torch.data.datapack import DataPack
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import rays

    n_times = INVERT_TIMES
    dp, truth = synth.generate_example_datapack(n_times=n_times, seed=0,
                                                device=dev)
    dp.wind_kmps = truth["wind_kmps"]
    pick = np.sort(np.random.default_rng(99).choice(dp.shape[0], 20,
                                                    replace=False))
    ants = dp.antennas_enu()[pick].astype(np.float32)
    pc = synth.zenith_phase_center(dp.array, dp.times.mean())
    ho = DataPack(dp.array, synth.choose_directions(pc, 50, seed=99),
                  dp.times)
    dirs = torch.as_tensor(ho.directions_enu().astype(np.float32),
                           device=dev)
    bundles, want = [], []
    for t in range(n_times):
        o, d = rays.make_ray_batch(torch.as_tensor(ants, device=dev), dirs[t])
        rb = rays.sample_straight_rays(o, d)
        bundles.append(rb)
        want.append(tec.dtec_paired(torch.as_tensor(truth["m"][t], device=dev),
                                    truth["grid"], rb, 50, 0))
    truth["heldout"] = (bundles, want)
    return dp, truth


def invert_heldout(m, grid, truth, t, cfg) -> float:
    """rms of (the field's dTEC − the truth's) over timestep t's held-out
    rays, through the pipeline's forward model."""
    from ionotomo_tpu_torch.forward import tec
    bundles, want = truth["heldout"]
    m = torch.as_tensor(np.asarray(m), device=grid.device)
    pred = tec.dtec_paired_q(m, grid, bundles[t], 50, 0, cfg.rays.quadrature,
                             cfg.rays.interp)
    return float(torch.sqrt(torch.mean((pred - want[t]) ** 2)))


def invert_config(name, *argv, shape=None):
    """The config of ``python -m ionotomo_tpu_torch invert`` with ``argv``
    on the 128^3 grid of ``EngineConfig`` (``shape`` shrinks it for a CPU
    rehearsal), writing its checkpoints and metrics under
    ``build/invert/<name>``."""
    from ionotomo_tpu_torch import __main__ as cli
    root = service_dir(name, under="invert")
    grid = str((shape or (128,))[0])
    args = cli.parser().parse_args(
        ["invert", "in.h5", "--out", "out.h5", "--grid", grid,
         "--checkpoint-dir", str(root / "ckpt"),
         "--metrics", str(root / "metrics.jsonl"), *argv])
    return cli.invert_config(args)


def solution_digest(sol) -> str:
    """SHA-256 of a Solution's field and diagnostics."""
    h = hashlib.sha256(np.ascontiguousarray(sol.m).tobytes())
    for k in sorted(sol.diagnostics):
        h.update(np.ascontiguousarray(sol.diagnostics[k]).tobytes())
    return h.hexdigest()


#: Phase 16's modes beside the default: (name, CLI arguments, timesteps,
#: the kernels the mode must launch beside the default mode's, anchors).
INVERT_MODES = (
    ("robust_gn", ("--solver", "robust_gn"), 1, (), None),
    ("steepest", ("--solver", "steepest"), 1,
     ("rows_value_fwd_batched", "pack_members"), None),
    ("lsqr_smoothness", ("--solver", "lsqr_smoothness"), 1, (), None),
    ("batched_gn", ("--solver", "batched_gn"), 4, (), None),
    ("kalman", ("--solver", "kalman", "--kalman-chunk", "4"), 8, (), None),
    ("enkf", ("--solver", "enkf", "--kalman-chunk", "2"), 4,
     ("rows_value_fwd_batched", "rows_value_bwd_batched", "pack_members"),
     None),
    ("posterior_samples", ("--posterior-samples", "8"), 1,
     ("rows_value_fwd_batched", "rows_value_bwd_batched", "pack_members"),
     None),
    ("bent_retrace", ("--bent", "--retrace-every", "1"), 1,
     ("trace_leapfrog_cubic",), None),
    ("beam_noise", ("--beam-noise", "8"), 1, ("trace_leapfrog_cubic",), None),
    ("auto_prior_gcv", ("--auto-prior", "gcv"), 1,
     ("rows_value_fwd_batched", "rows_value_bwd_batched", "pack_members"),
     None),
    ("auto_prior_evidence", ("--auto-prior", "evidence"), 1,
     ("rows_value_fwd_batched", "rows_value_bwd_batched", "pack_members"),
     None),
    ("estimate_profile", ("--estimate-profile",), 1, (), "slant"),
)
INVERT_PATH_KERNELS = ("rows_value_fwd", "rows_value_bwd", "cubic_value_grad",
                       "cubic_value_grad_bwd", "point_order_keys",
                       "permute_points")


def slant_truth_anchors(dev, pipe, truth):
    """Slant absolute-TEC anchors of the truth at timestep 0
    (``anchors.anchors_from_field``): 3 receivers inside the array's
    footprint x 5 elevations (15-75 deg), random azimuths (seed 1), noise
    0.5 % of the mean TEC (drawn, seed 2)."""
    from ionotomo_tpu_torch.inversion import anchors

    rng = np.random.default_rng(1)
    xy = pipe.datapack.array.enu[:, :2]
    rec = rng.uniform(0.5 * xy.min(0), 0.5 * xy.max(0), (3, 2))
    el = np.tile(np.deg2rad([15.0, 25.0, 40.0, 60.0, 75.0]), 3)
    bundle = anchors.slant_bundle(pipe.grid, np.repeat(rec, 5, 0),
                                  rng.uniform(0, 2 * np.pi, 15), el)
    m = torch.as_tensor(truth["m"][0], device=dev)
    clean = anchors.anchors_from_field(m, truth["grid"], bundle, 0.0)
    noise = 0.005 * float(torch.mean(clean.values))
    draws = np.random.default_rng(2).normal(size=15).astype(np.float32)
    return anchors.anchors_from_field(m, truth["grid"], bundle, noise,
                                      noise=draws)


def phase16_invert(dev, kernels, results, profile, shape=None,
                   parent=None):
    """The batch inversion (``inversion.pipeline.InversionPipeline``) at
    full width: ``data.synth``'s defaults over ``INVERT_TIMES`` timesteps in
    memory (the card's machine has no h5py), the 128^3 grid and the
    ``invert`` CLI's defaults (map_gauss_newton, gn 2, cg 40, Hermite@129,
    cubic, von Karman 80 km). The default snapshot mode over every
    timestep (seconds a timestep, rays/s, residual, held-out dTEC rms
    against the prior's, the launches of its kernels), each other mode
    once, kill and resume in the snapshot and Kalman modes (the Solution's
    SHA-256), one snapshot solve on the card against the CPU from the same
    inputs with bfloat16 controls, and K2b, its pack, K3b and its fold at
    B = 8 over the snapshot geometry's points (``kernels_at_invert``;
    with a ``parent``, K3b, its fold and K2b bitwise the parent's and timed
    in turns, and with ``profile`` the snapshot solve profiled on the
    parent's kernels too). ``shape`` shrinks the grid for a rehearsal on
    the CPU."""
    from ionotomo_tpu_torch.core import tricubic
    from ionotomo_tpu_torch.device import host
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline

    cuda = dev.type == "cuda"
    print("phase 16: the batch inversion (InversionPipeline, 128^3 cubic, "
          "the invert CLI's defaults)")
    t0 = time.perf_counter()
    n_times = INVERT_TIMES
    dp, truth = invert_world(dev)
    na, _, nd = dp.shape
    print(f"  world: {na} antennas x {nd} directions x {n_times} timesteps "
          f"(30 s cadence, {dp.frequency_hz / 1e6:g} MHz), made in memory in "
          f"{time.perf_counter() - t0:.2f} s")

    def pack(k):
        sub = dp.select(times=list(range(k)))
        sub.wind_kmps = dp.wind_kmps
        return sub

    cfg = invert_config("default", shape=shape)
    print(f"  config: grid {cfg.grid.shape}, {cfg.rays.interp}, "
          f"{cfg.rays.quadrature}@{cfg.rays.n_samples}, gn "
          f"{cfg.solver.gn_iters}, cg {cfg.solver.cg_iters}, prior "
          f"{cfg.prior.kind} sigma {cfg.prior.sigma} L "
          f"{cfg.prior.length_scale_km} km")
    pipe = InversionPipeline(dp, cfg, device=dev)
    prior = pipe.m_prior
    kernels.reset_launches()
    sync(dev)
    t1 = time.perf_counter()
    sol = pipe.run(resume=False)
    sync(dev)
    run_s = time.perf_counter() - t1
    launches = {k: v for k, v in kernels.launches.items() if v}
    print(f"  launches in the default-mode run ({n_times} timesteps): "
          f"{launches}")
    if cuda:
        for k in INVERT_PATH_KERNELS:
            check(launches.get(k, 0) > 0, f"{k} launched on the invert path "
                                          f"({launches.get(k, 0)} times)")
    recs = [r for r in pipe.metrics.read_all() if "timestep" in r]
    check([r["timestep"] for r in recs] == list(range(n_times))
          and sol.m.shape[0] == n_times and np.isfinite(sol.m).all(),
          f"{n_times} finite timesteps, one metrics record each")
    secs = [r["seconds"] for r in recs]
    rays_s = [r["rays_per_sec"] for r in recs]
    h_post = [invert_heldout(sol.m[t], pipe.grid, truth, t, cfg)
              for t in range(n_times)]
    h_prior = [invert_heldout(host(prior), pipe.grid, truth, t, cfg)
               for t in range(n_times)]
    check(all(a < b for a, b in zip(h_post, h_prior)),
          "held-out dTEC rms below the prior's at every timestep: "
          + ", ".join(f"{a:.2f} < {b:.2f}" for a, b in zip(h_post, h_prior)))
    card = card_line() if cuda else "cpu"
    print(f"  snapshot mode ({card}): {run_s:.3f} s for {n_times} timesteps "
          f"(host clock, the run's set-up and checkpoints included); the "
          f"solve's seconds a timestep median {np.median(secs):.4f}, first "
          f"{secs[0]:.4f}, max {max(secs):.4f}; rays/s median "
          f"{np.median(rays_s):.1f}; residual "
          + ", ".join(f"{r['residual']:.1f}" for r in recs))
    out = {"timesteps": n_times, "run_s": run_s, "seconds": secs,
           "rays_per_s": float(np.median(rays_s)),
           "residual": [r["residual"] for r in recs],
           "heldout": h_post, "heldout_prior": h_prior,
           "launches": launches, "card": card, "modes": {}}

    # kill and resume: the default run's checkpoint after timestep 4 (of
    # 8) in a new directory, resumed by a new pipeline
    half = n_times // 2

    def resumed(name, argv, full_cfg, full_sol):
        c = invert_config(name, *argv, shape=shape)
        Path(c.runtime.checkpoint_dir).mkdir(parents=True)
        shutil.copy(Path(full_cfg.runtime.checkpoint_dir)
                    / f"ckpt_{half:08d}.npz", c.runtime.checkpoint_dir)
        again = InversionPipeline(dp, c, device=dev).run(resume=True)
        a, b = solution_digest(full_sol), solution_digest(again)
        check(a == b, f"{name}: stopped after timestep {half} and resumed, "
                      f"the Solution's SHA-256 equals the uninterrupted "
                      f"run's ({a[:16]})")
        return a

    out["resume_sha256"] = {"snapshot": resumed("snapshot_resumed", (), cfg,
                                                sol)}

    # every other mode once
    for name, argv, k, need, anchors in INVERT_MODES:
        c = invert_config(name, *argv, shape=shape)
        sub = pack(min(k, n_times))
        kernels.reset_launches()
        sync(dev)
        t1 = time.perf_counter()
        p = InversionPipeline(sub, c, device=dev)
        a = slant_truth_anchors(dev, p, truth) if anchors else None
        s = p.run(resume=False, anchors=a)
        sync(dev)
        secs_m = time.perf_counter() - t1
        got = {kk: v for kk, v in kernels.launches.items() if v}
        last = s.m.shape[0] - 1
        h = invert_heldout(s.m[last], p.grid, truth, last, c)
        hp = invert_heldout(host(p._m_prior0), p.grid, truth, last, c)
        check(np.isfinite(s.m).all() and h < hp,
              f"{name}: finite, held-out dTEC rms {h:.2f} below the prior's "
              f"{hp:.2f} at timestep {last}")
        if cuda:
            for kk in need:
                check(got.get(kk, 0) > 0, f"{name}: {kk} launched "
                                          f"({got.get(kk, 0)} times)")
        events = [r for r in p.metrics.read_all() if "event" in r
                  and r["event"] not in ("chunk",)]
        print(f"  {name} ({k} timestep(s)): {secs_m:.3f} s (host clock, "
              f"set-up included), held-out {h:.2f} (prior {hp:.2f}); "
              f"launches {got}" + ("; events " + json.dumps(
                  [{kk: v for kk, v in e.items() if kk != "t_wall"}
                   for e in events])[:600] if events else ""))
        out["modes"][name] = {"timesteps": k, "seconds": secs_m,
                              "heldout": h, "heldout_prior": hp,
                              "launches": got}
        if name == "kalman":
            out["resume_sha256"]["kalman"] = resumed(
                "kalman_resumed", argv, c, s) if k == n_times else None

    # the slice's kernels at its new shapes: K2b with its pack and K3b
    # with its fold at B = 8 over timestep 0's geometry
    geo = tec.DtecGeometry(pipe.grid, pipe.rays_for_time(0), nd, pipe.i0,
                           cfg.rays.quadrature, cfg.rays.interp)
    n_pts = geo.ri.shape[0]
    print(f"  the snapshot geometry: {n_pts} points, {geo.ends.shape[0]} "
          f"endpoints")
    out["at"] = (member_kernels_at(
        f"the snapshot's {n_pts} points", dev, tricubic, kernels,
        (geo.ri, geo.wxy, geo.zi, geo.wz), geo.row_plan,
        *geo.table_shape, geo.model.xy_first, np.random.default_rng(16),
        parent, layout=True) if cuda else {})
    del geo
    if profile and cuda:
        out["profile"] = profile_call("snapshot solve",
                                      lambda: pipe.solve_snapshot(0))
        if parent is not None:
            out["profile_parent"] = profile_call(
                "snapshot solve on the parent's kernels",
                lambda: parent.run(lambda: pipe.solve_snapshot(0)))

    # one snapshot solve on the card against the CPU from the same inputs,
    # with the controls: K2 or K3 rounded to bfloat16
    cpu = torch.device("cpu")
    t1 = time.perf_counter()
    m_cpu, _ = InversionPipeline(pack(1), invert_config(
        "cpu", shape=shape), device=cpu).solve_snapshot(0)
    cpu_s = time.perf_counter() - t1
    ref = m_cpu.numpy()
    # one timestep's grid and prior (the grid encloses the rays of
    # every timestep a DataPack holds)
    card_pipe = InversionPipeline(pack(1), invert_config(
        "card", shape=shape), device=dev)
    pri = host(card_pipe.m_prior)

    def reading(field):
        got = host(field)
        rel = float(np.linalg.norm((got - ref).astype(np.float64))
                    / np.linalg.norm((ref - pri).astype(np.float64)))
        hk = invert_heldout(got, card_pipe.grid, truth, 0, cfg)
        hc = invert_heldout(ref, card_pipe.grid, truth, 0, cfg)
        return rel, abs(hk - hc) / hc, hk, hc

    sound = reading(card_pipe.solve_snapshot(0)[0])
    ctrl = {}
    if cuda:
        for kname in ("rows_value_fwd", "rows_value_bwd"):
            with rounded_to_bf16(kernels, kname):
                ctrl[kname] = reading(card_pipe.solve_snapshot(0)[0])
    rel, dh, hk, hc = sound
    print(f"  one snapshot solve on the card against the CPU ({cpu_s:.1f}"
          f" s there): relative L2 of the field over the update "
          f"{rel:.3e}, held-out dTEC rms {hk:.4f} against {hc:.4f} "
          f"(relative {dh:.3e}); controls: " + "; ".join(
              f"{k} in bfloat16 {r:.3e}, {d:.3e}"
              for k, (r, d, _, _) in ctrl.items()))
    check(rel <= INVERT_FIELD_LIMIT and dh <= INVERT_HELDOUT_LIMIT,
          f"card against CPU: field within {INVERT_FIELD_LIMIT:.0e} "
          f"({rel:.3e}), held-out within {INVERT_HELDOUT_LIMIT:.0e} "
          f"({dh:.3e})")
    for kname, (r, d, _, _) in ctrl.items():
        check(r > INVERT_FIELD_LIMIT, f"control, {kname} in bfloat16: "
              f"field's relative L2 {r:.3e} past the limit "
              f"{INVERT_FIELD_LIMIT:.0e} (held-out {d:.3e})")
    out.update(card_vs_cpu=list(sound), controls=ctrl, cpu_s=cpu_s,
               limits=[INVERT_FIELD_LIMIT, INVERT_HELDOUT_LIMIT])
    results["invert"] = out


#: Phase 17 (``predict``): the timesteps held card against CPU, and the
#: limits: the straight prediction's residual rms against the observed
#: (``tests/test_cli.py:66``), bent against straight as a share of
#: max|dTEC| (``tests/test_cli.py:84``), the card against the CPU (dTEC
#: of max|dTEC|, RM per ray of max|RM|: dRM is a difference of nearly
#: equal numbers), the screens' held-out error against the per-antenna
#: mean's (``tests/test_screens.py:27``), their means card against CPU
#: (of max|dTEC|) and their fitted hyperparameters (relative). The dTEC
#: limit is 1e-4, not 1e-2: the card reads 2e-7 to 9e-7 of the CPU, and
#: K2 in bfloat16 moves the dTEC by 3.3e-3 (NVIDIA H100 80GB HBM3,
#: 700.00 W), which 1e-2 would let through.
PREDICT_CPU_TIMES = 2
PREDICT_RESIDUAL_LIMIT = 0.6
PREDICT_BENT_LIMIT = 0.05
PREDICT_DTEC_LIMIT = 1e-4
PREDICT_RM_LIMIT = 1e-4
SCREEN_HELDOUT_LIMIT = 0.8
SCREEN_MEAN_LIMIT = 1e-3
SCREEN_FIT_LIMIT = 1e-3
PREDICT_REPS = 3


def predict_rm_per_ray(cli, rm, sol, arrays, frequency_hz, b_fn, kw, t, dev):
    """RM per ray at timestep ``t`` over the bundle of a ``predict`` form
    (``kw``) on ``dev``: what ``predict``'s dRM differences."""
    from ionotomo_tpu_torch.device import host

    grid = sol.grid.to(dev)
    m_t = torch.as_tensor(sol.m[t], device=dev)
    rb = cli.predict_rays(
        m_t, grid, torch.as_tensor(arrays["antennas_enu"], device=dev),
        torch.as_tensor(arrays["directions_enu"][t], device=dev),
        frequency_hz, kw.get("bent", False), interp=kw.get("interp", "cubic"))
    return host(rm.rotation_measure(m_t, grid, rb, b_fn))


def predict_kernels_at(dev, sol, dp, kernels):
    """The kernels of ``predict``'s path alone at the shapes a timestep
    gives them (timestep 0 of phase 17's world), each against its plain
    version: K2 in ray order (``interp_rows``' one-shot gather) at the
    straight bundle's 62·10·129 points and at the bent bundle's 62·10·65,
    K5 at the straight bundle's 1,240 endpoints and K1c with its path at
    620 rays × 64 steps. Returns {kernel@shape: line}."""
    from ionotomo_tpu_torch.core import tricubic
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays

    arrays = dp.to_device_arrays()
    grid = sol.grid.to(dev)
    m = torch.as_tensor(sol.m[0], device=dev).contiguous()
    table = m.reshape(-1, grid.shape[2])
    o, d = rays.make_ray_batch(
        torch.as_tensor(arrays["antennas_enu"], device=dev),
        torch.as_tensor(arrays["directions_enu"][0], device=dev))
    c = fermat._step_constants(dp.frequency_hz, LENGTH_KM, N_STEPS)
    kw = dict(n_steps=N_STEPS, keep_path=True, method="leapfrog")
    bent = fermat.trace_rays(m, grid, o, d, dp.frequency_hz, LENGTH_KM, **kw)
    straight = rays.sample_straight_rays(o, d, LENGTH_KM)
    out = {}

    def k2_at(label, rb):
        setup = tricubic.row_setup(grid, rb.points.reshape(-1, 3))
        n = setup[0].shape[0]
        return check_and_time(
            f"K2 in ray order at the {label} bundle's {n} points",
            lambda: kernels.rows_value_fwd(table, *setup, False),
            lambda: tricubic.rows_value_ref(table, *setup, False), None,
            k2_bound(*setup, *table.shape, 16, FLOPS_K2_CUBIC_POINT),
            scatter=False) | {"points": n}

    out["rows_value_fwd@straight"] = k2_at("straight", straight)
    out["rows_value_fwd@bent"] = k2_at("bent", bent[0])
    ends = tec._endpoint_tangents(straight.points)[0].contiguous()
    out["cubic_value_grad"] = check_k5(
        f"K5 at the straight bundle's {ends.shape[0]} endpoints", tricubic,
        kernels, table, grid, ends)
    plain = fermat.trace_rays_ref(m, grid, o, d, dp.frequency_hz, LENGTH_KM,
                                  interp="cubic", **kw)
    err_x, err_t = check_against_plain(
        f"K1c with its path at {o.shape[0]} rays x {N_STEPS} steps", bent,
        plain)
    del plain

    def k1c():
        return kernels.trace_leapfrog_cubic(table, grid, o, d, N_STEPS, True,
                                            **c)

    ms = device_ms(k1c, 20)
    plain_ms = cuda_ms(lambda: fermat.trace_rays_ref(
        m, grid, o, d, dp.frequency_hz, LENGTH_KM, interp="cubic", **kw), 1)
    b_ms, b_by = trace_bound(tricubic, 16, kernels.trace_leapfrog_cubic,
                             FLOPS_K1C_STEP, table, grid, o, d, N_STEPS, True,
                             c)
    print(f"  K1c with its path at {o.shape[0]} rays x {N_STEPS} steps (the "
          f"call: pack and trace): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by})")
    out["trace_leapfrog_cubic"] = dict(
        max_abs_err=err_x, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, tau_rel=err_t, rays=o.shape[0])
    return out


def phase17_predict(dev, kernels, results, profile, shape=None):
    """``predict`` at full width (``__main__.predict``, what the CLI's
    ``predict`` runs between its file reads and writes): phase 16's world
    (``data.synth``'s defaults, 62 antennas × 10 directions × 8 timesteps,
    150 MHz) and the 128^3 Solution of a snapshot ``InversionPipeline``
    run over it at the ``invert`` CLI's defaults, in memory; ``predict``
    at its defaults in four forms (``testing.PREDICT_FORMS``: straight;
    straight with RM; bent at leapfrog@64 with RM; bent on zp with RM),
    each timed per timestep on the host clock after a warm-up, with its
    launches, finite, the dRM's reference row 0, twice bitwise; the
    straight residual and bent against straight within the reference's
    CLI bounds; the card against the CPU on 2 timesteps with a bfloat16
    control; the sky screens on a 62 × 40 synth DataPack on 64^3 (held
    out, hyperparameters, card against CPU); the structure function of
    the predicted phases; ``checked`` on the card; and the path's kernels
    alone at its shapes (``kernels_at_predict``). ``shape`` shrinks the
    Solution's grid for a rehearsal on the CPU."""
    from ionotomo_tpu_torch import __main__ as cli
    from ionotomo_tpu_torch.data import synth
    from ionotomo_tpu_torch.data.datapack import DataPack
    from ionotomo_tpu_torch.forward import rm
    from ionotomo_tpu_torch.inversion import screens
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
    from ionotomo_tpu_torch.inversion.solution import Solution
    from ionotomo_tpu_torch.models.geomagnetic import dipole_b_enu_fn
    from ionotomo_tpu_torch.testing import PREDICT_FORMS
    from ionotomo_tpu_torch.utils.debugging import checked
    from ionotomo_tpu_torch.utils.diagnostics import (fit_structure_exponent,
                                                      phase_structure_function)

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    print("phase 17: predict at its defaults (cubic, Hermite@129, 1000 km; "
          "bent leapfrog@64) on phase 16's world")
    t0 = time.perf_counter()
    dp, _ = invert_world(dev)
    sol = InversionPipeline(dp, invert_config("predict", shape=shape),
                            device=dev).run(resume=False)
    na, nt, nd = dp.shape
    n_rays = na * nd
    print(f"  the Solution: {nt} snapshot solves on {sol.grid.shape}, world "
          f"and solves {time.perf_counter() - t0:.2f} s")
    card = card_line() if cuda else "cpu"
    out = {"timesteps": nt, "rays": n_rays, "card": card, "forms": {}}
    preds = {}
    for form, (kw, need) in PREDICT_FORMS.items():
        first = cli.predict(dp, sol, device=dev, **kw)
        secs = []
        for rep in range(PREDICT_REPS):
            if rep == 0:
                kernels.reset_launches()
            sync(dev)
            t1 = time.perf_counter()
            p = cli.predict(dp, sol, device=dev, **kw)
            sync(dev)
            secs.append(time.perf_counter() - t1)
            if rep == 0:
                launches = {k: v for k, v in kernels.launches.items() if v}
        same = np.array_equal(first.dtec, p.dtec) and (
            p.drm is None or np.array_equal(first.drm, p.drm))
        check(same, f"{form}: two calls bitwise equal")
        check(bool(np.isfinite(p.dtec).all()) and (
            p.drm is None or (bool(np.isfinite(p.drm).all())
                              and bool((p.drm[dp.ref_antenna] == 0).all()))),
              f"{form}: finite" + (", the dRM's reference-antenna row "
                                   "exactly 0" if p.drm is not None else ""))
        if cuda:
            for k in need:
                check(launches.get(k, 0) > 0, f"{form}: {k} launched "
                                              f"({launches.get(k, 0)} times)")
        s = float(np.median(secs))
        per_t = {k: v / nt for k, v in launches.items()}
        print(f"  {form}: {s / nt * 1e3:.3f} ms a timestep (host clock, "
              f"median of {PREDICT_REPS} calls of {nt} timesteps after a "
              f"warm-up; least {min(secs) / nt * 1e3:.3f}), "
              f"{n_rays * nt / s:.1f} rays/s; observed rms "
              f"{p.observed_rms:.2f}, residual rms {p.residual_rms:.2f}; "
              f"launches a timestep {per_t}")
        preds[form] = p
        out["forms"][form] = {
            "ms_per_timestep": s / nt * 1e3, "seconds": secs,
            "rays_per_s": n_rays * nt / s, "launches": launches,
            "launches_per_timestep": per_t, "observed_rms": p.observed_rms,
            "residual_rms": p.residual_rms}
    st = preds["straight"]
    check(st.residual_rms < PREDICT_RESIDUAL_LIMIT * st.observed_rms,
          f"straight: residual rms {st.residual_rms:.2f} below "
          f"{PREDICT_RESIDUAL_LIMIT} x the observed {st.observed_rms:.2f}")
    scale = float(np.abs(st.dtec).max())
    bent_err = {f: float(np.abs(preds[f].dtec - st.dtec).max()) / scale
                for f in ("bent_rm", "bent_zp_rm")}
    check(bent_err["bent_rm"] < PREDICT_BENT_LIMIT,
          f"bent (cubic) against straight: max|diff| {bent_err['bent_rm']:.4f}"
          f" of max|dTEC| below {PREDICT_BENT_LIMIT} (bent on zp: "
          f"{bent_err['bent_zp_rm']:.4f})")
    out["bent_vs_straight"] = bent_err

    # the card against the CPU on the first timesteps, RM per ray and the
    # dTEC, with K2 rounded to bfloat16 as a control
    k = PREDICT_CPU_TIMES
    sub = dp.select(times=list(range(k)))
    sol_k = Solution(sol.grid, sol.m[:k])
    sol_cpu = Solution(sol.grid.to(cpu), sol.m[:k])
    arrays = sub.to_device_arrays()
    b_fns = {d.type: dipole_b_enu_fn(dp.array.enu_frame, device=d)
             for d in (dev, cpu)}

    def rms_per_ray(d, s, kw):
        return [predict_rm_per_ray(cli, rm, s, arrays, dp.frequency_hz,
                                   b_fns[d.type], kw, t, d)
                for t in range(k)] if kw.get("rm") else None

    t1 = time.perf_counter()
    ref = {form: (cli.predict(sub, sol_cpu, device=cpu, **kw),
                  rms_per_ray(cpu, sol_cpu, kw))
           for form, (kw, _) in PREDICT_FORMS.items()}
    cpu_s = time.perf_counter() - t1

    def reading(form):
        kw = PREDICT_FORMS[form][0]
        p_cpu, r_cpu = ref[form]
        p = cli.predict(sub, sol_k, device=dev, **kw)
        e_dtec = float(np.abs(p.dtec - p_cpu.dtec).max()
                       / np.abs(p_cpu.dtec).max())
        if r_cpu is None:
            return e_dtec, None
        r = rms_per_ray(dev, sol_k, kw)
        e_rm = float(max(np.abs(a - b).max() for a, b in zip(r, r_cpu))
                     / max(np.abs(b).max() for b in r_cpu))
        return e_dtec, e_rm

    sound = {form: reading(form) for form in PREDICT_FORMS}
    ctrl = None
    if cuda:
        with rounded_to_bf16(kernels, "rows_value_fwd"):
            ctrl = reading("straight_rm")
    print(f"  the card against the CPU on {k} timesteps ({cpu_s:.1f} s "
          f"there for the four forms): " + "; ".join(
              f"{f} dTEC {e:.3e}" + (f", RM {r:.3e}" if r is not None
                                     else "") for f, (e, r) in sound.items())
          + (f"; control, K2 in bfloat16 (straight_rm): dTEC {ctrl[0]:.3e}, "
             f"RM {ctrl[1]:.3e}" if ctrl else ""))
    for f, (e, r) in sound.items():
        check(e <= PREDICT_DTEC_LIMIT and (r is None or r <= PREDICT_RM_LIMIT),
              f"card against CPU, {f}: dTEC within {PREDICT_DTEC_LIMIT:g} of "
              f"max|dTEC| ({e:.3e})" + (f", RM per ray within "
                                        f"{PREDICT_RM_LIMIT:g} of max|RM| "
                                        f"({r:.3e})" if r is not None else ""))
    if ctrl:
        check(ctrl[0] > PREDICT_DTEC_LIMIT and ctrl[1] > PREDICT_RM_LIMIT,
              f"control, K2 in bfloat16: dTEC {ctrl[0]:.3e} and RM "
              f"{ctrl[1]:.3e} past their limits")
    out.update(card_vs_cpu=sound, control=ctrl, cpu_s=cpu_s,
               limits=[PREDICT_DTEC_LIMIT, PREDICT_RM_LIMIT])

    # the sky screens: 62 antennas x 40 directions x 1 timestep on 64^3;
    # 30 directions fitted, 10 held out. The kernel's hyperparameters are
    # fitted on the 30 (``fit_screen_hyperparameters``, 150 steps) and
    # passed to ``fit_screen``, the reference's workflow: its default
    # kernel (sigma the pooled std, zero mean) does worse on this world
    # than each antenna's mean, in either package (printed)
    sdp, _ = synth.generate_example_datapack(n_directions=40,
                                             grid_shape=(64, 64, 64),
                                             device=dev)
    train = sdp.select(directions=list(range(30)))
    held = sdp.directions[30:]

    def screen_run(d, data=train):
        sync(d)
        t = time.perf_counter()
        fitted = screens.fit_screen_hyperparameters(data, 0, device=d)
        params = {k: float(v) for k, v in fitted.params().items()}
        fit_s = time.perf_counter()
        mean, var = screens.predict_screen(
            screens.fit_screen(data, 0, kernel=fitted, device=d), held)
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        end = time.perf_counter()
        return mean, var, params, fit_s - t, end - fit_s

    scr, scr2, scr_cpu = screen_run(dev), screen_run(dev), screen_run(cpu)
    default = screens.predict_screen(screens.fit_screen(train, 0, device=dev),
                                     held)[0].cpu().numpy()
    truth = sdp.dtec[:, 0, 30:]

    def heldout(mean):
        return float(np.abs(mean - truth).mean())

    err_gp, err_default = heldout(scr[0]), heldout(default)
    err_mean = heldout(train.dtec[:, 0, :].mean(axis=1, keepdims=True))
    sscale = float(np.abs(sdp.dtec).max())
    e_mean = float(np.abs(scr[0] - scr_cpu[0]).max()) / sscale
    e_fit = max(abs(scr[2][p] - scr_cpu[2][p]) / abs(scr_cpu[2][p])
                for p in scr[2])
    # how far the CPU's own fit moves when its input moves by one f32
    # rounding (3 draws): the conditioning the comparison sits on
    rng = np.random.default_rng(17)
    spread = 0.0
    for _ in range(3):
        moved = sdp.select(directions=list(range(30)))
        moved.dtec = moved.dtec.astype(np.float32).astype(np.float64) * (
            1 + 6e-8 * rng.choice([-1.0, 1.0], moved.dtec.shape))
        spread = max(spread, max(abs(v - scr_cpu[2][p]) / abs(scr_cpu[2][p])
                                 for p, v in screen_run(cpu, moved)[2].items()))
    print(f"  screens (62 x 40 on 64^3, 30 fitted, 10 held out): "
          f"hyperparameters (150 steps) {scr[3]:.2f} s, fit and held-out "
          f"prediction {scr[4] * 1e3:.1f} ms on the card (CPU "
          f"{scr_cpu[3]:.2f} s, {scr_cpu[4] * 1e3:.1f} ms); held-out error "
          f"{err_gp:.3f} against the per-antenna mean's {err_mean:.3f} (the "
          f"default kernel's {err_default:.3f}); fitted {scr[2]} (CPU "
          f"{scr_cpu[2]}); the CPU fit's own spread under one f32 rounding "
          f"of its input {spread:.3e}")
    check(err_gp < SCREEN_HELDOUT_LIMIT * err_mean,
          f"screens: held-out error {err_gp:.3f} below "
          f"{SCREEN_HELDOUT_LIMIT} x the per-antenna mean's {err_mean:.3f}")
    check(np.array_equal(scr[0], scr2[0]) and np.array_equal(scr[1], scr2[1])
          and scr[2] == scr2[2], "screens: two runs on the card bitwise "
                                 "equal")
    check(e_mean <= SCREEN_MEAN_LIMIT and e_fit <= SCREEN_FIT_LIMIT,
          f"screens, card against CPU: means within {SCREEN_MEAN_LIMIT:g} "
          f"of max|dTEC| ({e_mean:.3e}), hyperparameters within "
          f"{SCREEN_FIT_LIMIT:g} relative ({e_fit:.3e})")
    out["screens"] = {"heldout": err_gp, "heldout_mean_predictor": err_mean,
                      "heldout_default_kernel": err_default,
                      "card_vs_cpu": [e_mean, e_fit], "cpu_fit_spread": spread,
                      "fitted": scr[2], "fitted_cpu": scr_cpu[2],
                      "hyper_s": scr[3], "fit_predict_ms": scr[4] * 1e3}

    # the structure function of the straight prediction's phases
    pdp = DataPack(dp.array, dp.directions, dp.times, dtec=st.dtec,
                   flags=dp.flags, noise_std=dp.noise_std,
                   ref_antenna=dp.ref_antenna, frequency_hz=dp.frequency_hz,
                   frame_model=dp.frame_model)
    b, dd, n = phase_structure_function(pdp)
    beta, c_amp, r_diff = fit_structure_exponent(b, dd)
    check(bool(np.isfinite(dd[n > 0]).all()) and beta > 0,
          f"structure function of the predicted phases: finite, beta "
          f"{beta:.3f} > 0 (C {c_amp:.3e}, r_diff {r_diff:.1f} km)")
    out["structure"] = {"beta": beta, "c": c_amp, "r_diff_km": r_diff}

    # the NaN-check mode: a NaN made on the device raises; a checked
    # predict of one timestep is bitwise the unchecked one
    try:
        checked(torch.log)(torch.tensor([1.0, -1.0], device=dev))
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None and "primitive: log" in raised,
          f"checked on {dev.type}: a NaN made there raises ({raised!r})")
    one = dp.select(times=[0])
    sol1 = Solution(sol.grid, sol.m[:1])
    kw = PREDICT_FORMS["straight_rm"][0]
    plain = cli.predict(one, sol1, device=dev, **kw)
    t1 = time.perf_counter()
    got = checked(cli.predict)(one, sol1, device=dev, **kw)
    checked_s = time.perf_counter() - t1
    check(np.array_equal(got.dtec, plain.dtec)
          and np.array_equal(got.drm, plain.drm),
          f"checked predict (straight, RM, one timestep): bitwise the "
          f"unchecked call ({checked_s:.2f} s checked)")
    out["checked_s"] = checked_s

    if profile and cuda:
        out["profile"] = {
            form: profile_call(f"predict {form}, one timestep",
                               lambda kw=kw: cli.predict(one, sol1, device=dev,
                                                         **kw))
            for form, (kw, _) in PREDICT_FORMS.items()}
    out["at"] = predict_kernels_at(dev, sol, dp, kernels) if cuda else {}
    results["predict"] = out


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
        pts = rb.points.reshape(-1, 3)
        shapes.append((model, grid, pts, model.row_setup(grid, pts)))
    rng = np.random.default_rng(21)
    for model, grid, pts, setup in shapes:
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
        sort_ms = device_ms(lambda: kernels.point_order(
            pts, grid, model.POINT_RULE, model.base_cell), 10)
        build_ms = device_ms(lambda: model.point_order(grid, pts, *setup),
                             10)
        po = model.point_order(grid, pts, *setup)
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
        pts = rb.points.reshape(-1, 3)
        setup = model.row_setup(grid, pts)
        n = setup[0].shape[0]
        po = kernels.point_order(pts, grid, model.POINT_RULE,
                                 model.base_cell)
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


def k6zt_study(reps=50) -> int:
    """``--k6zt-study``: what binds K6zᵀ, at config 4's 20,000 endpoints
    (the zpc2-inner solve's: 10,000 start points on 100 antennas, 10,000
    far endpoints) and at the 917,504 edge-case points of a 128³ grid.
    For each: the plan's shape (occupied rows, used segments, the longest
    row, the rows that need a fold, the task list); then, each into one
    running table, timed in two passes in turns: the first design (one
    warp a used segment, 4 blocks an SM: ``-DK6ZT_SEGMENT_CHAIN=1``), a
    task a segment (the plan's task list with ``task_pairs=0``: one
    16-byte load for a segment's bounds, no rows shared), the task list
    (the default: whole short rows a warp, a long row's segment a warp),
    rows cut into segments of 32 (another summation order, held to the
    plain version), and ``index_add_`` of the contributions into a
    running table. Each variant that computes the same sums bitwise the
    default build's table + K6zᵀ. Prints ptxas's registers for each
    build."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import zpcubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.testing import edge_case_points

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    builds = {"default": (), "first design": ("K6ZT_SEGMENT_CHAIN=1",)}
    libs = {}
    for label, defines in builds.items():
        info = build.build(defines=defines)
        libs[label] = build.open_library(info["path"])
        for kern, regs in ptxas_lines(info["log"], ["zpc_value_grad_bwd"]):
            print(f"  ptxas, {label}: {kern}: {regs}")
    default = build.load()

    def with_lib(label, fn):
        build._loaded["lib"] = libs[label]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    rng = np.random.default_rng(13)
    w = configs.config4_world(device=dev)
    geo = tec.DtecGeometry(w.grid, w.rays, w.n_dirs, 0, "hermite", "zpc2")
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    g128 = Grid3D.create(origin, spacing, (N_GRID,) * 3, device=dev)
    edge = torch.from_numpy(edge_case_points((N_GRID,) * 3, origin, spacing,
                                             1 << 20, rng)).to(dev)
    cases = [("config 4's endpoints", w.grid, geo.ends),
             (f"{edge.shape[0]} edge-case points of 128^3", g128, edge)]
    del geo
    for label, grid, pts in cases:
        n = pts.shape[0]
        cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)
                              ).to(dev)
        cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)
                              ).to(dev)
        plan = zpcubic.endpoint_plan(grid, pts)
        per_seg = zpcubic.endpoint_plan(grid, pts, task_pairs=0)
        batches = zpcubic.endpoint_plan(grid, pts, chunk=32)
        print(f"  K6zT at {label}: {n} points, plan "
              f"{k6zt_plan_shape(plan)}; in segments of 32 "
              f"{k6zt_plan_shape(batches)}")
        n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
        table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                                 .astype(np.float32)).to(dev)
        want = kernels.zpc_value_grad_bwd(table.clone(), grid, pts, cv, cg,
                                          plan)
        running = table.clone()

        def add(p):
            return kernels.zpc_value_grad_bwd(running, grid, pts, cv, cg, p)

        variants = [("first design, one warp a used segment", "first design",
                     plan),
                    ("a task a segment (one load for its bounds)",
                     "default", per_seg),
                    ("the task list (default)", "default", plan)]
        for what, lib, p in variants:
            got = with_lib(lib, lambda: kernels.zpc_value_grad_bwd(
                table.clone(), grid, pts, cv, cg, p))
            torch.cuda.synchronize()
            check(bool(torch.equal(got, want)),
                  f"K6zT at {label}, {what}: bitwise the default build")
            del got
        # rows cut into segments of one batch: another summation order
        got = kernels.zpc_value_grad_bwd(table.clone(), grid, pts, cv, cg,
                                         batches)
        ref = table + zpcubic.interp_rows_with_grad_transpose_ref(grid, pts,
                                                                  cv, cg)
        err = float((got - ref).abs().max())
        check(err <= 1e-4 * float(ref.abs().max()),
              f"K6zT at {label}, segments of 32: max|err| {err:.3e} against "
              f"table + the plain version (1e-4 x max)")
        del got, ref
        variants.append(("segments of 32 (a batch each; another order)",
                         "default", batches))
        terms = zpcubic.value_grad_transpose_terms(grid, pts, cv, cg)
        lib_call = index_add_call(*terms, n_rows * nz)
        times = {what: [] for what, _, _ in variants}
        times["index_add_"] = []
        for pass_ in range(2):
            order = variants if pass_ == 0 else variants[::-1]
            for what, lib, p in order:
                times[what].append(with_lib(
                    lib, lambda: device_ms(lambda: add(p), reps)))
            times["index_add_"].append(device_ms(lib_call, reps))
        for what, ms in times.items():
            print(f"  K6zT at {label}, {what}: "
                  f"{', '.join(f'{x:.4f}' for x in ms)} ms")
        check(not bool(plan.counters.any()), f"K6zT at {label}: counters "
                                             f"back at zero")
        del plan, per_seg, batches, table, running, want, terms, lib_call
        torch.cuda.empty_cache()
    return 0


def rk4_study(reps=3) -> int:
    """``--rk4-study``: what binds K1r at the bench's batch (262,144 rays,
    128³, 150 MHz, rk4@64) on zp, cubic, zpc and quadratic. First, from
    the plain loop over the model's evaluator, how often a stage's cell
    (its rows and z base) is the previous evaluation's: stage 2 against
    1, 3 against 2, 4 against 3, and a step's stage 1 against the previous
    step's stage 4. Then K1r's kernel (packed, sorted) at 64, 128 and 256
    rays a block, built with register budgets of 1-4 blocks of 256 an SM
    (``-DK1R_MIN_BLOCKS=n``), each bitwise the default build's output,
    timed; and K1s's rk4@64 call beside it. Prints ptxas's registers,
    stack and spills of K1r in every build. The parent's launch (the
    leapfrog tracer's block, no budget) is timed against it by
    ``--parent``."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core import (boxspline, triquadratic, tricubic,
                                         zpcubic)
    from ionotomo_tpu_torch.core.field_models import field_model
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.geometry import fermat
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    mods = {"boxspline": boxspline, "tricubic": tricubic,
            "zpcubic": zpcubic, "triquadratic": triquadratic}
    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    grid = grid_cpu.to(dev)
    m = torch.from_numpy(perturbed_log_field(
        grid_cpu, np.random.default_rng(14), chapman)).to(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(262144))
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)

    for interp in RK4_TRACERS:
        rate = rk4_cell_reuse(fermat, mods, interp, m, grid, o, d)
        print(f"  rk4@{N_STEPS} on {interp}, the plain loop: a stage's cell "
              f"the previous evaluation's: stage 1 (the last step's stage "
              f"4) {rate[0]:.4f}, stage 2 (stage 1) {rate[1]:.4f}, stage 3 "
              f"(stage 2) {rate[2]:.4f}, stage 4 (stage 3) {rate[3]:.4f}; "
              f"gathers a step with a cache of one cell "
              f"{4 - sum(rate):.3f} of 4")
        torch.cuda.empty_cache()

    builds = {"default": ()}
    for budget in range(1, 5):
        builds[f"budget {budget}"] = (f"K1R_MIN_BLOCKS={budget}",)
    libs = {}
    for label, defines in builds.items():
        info = build.build(defines=defines)
        libs[label] = build.open_library(info["path"])
        for kern, line in rk4_ptxas(info["log"]):
            print(f"  ptxas, {label}: {kern}: {line}")
    default = build.load()

    def with_lib(label, fn):
        build._loaded["lib"] = libs[label]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    for interp, (name, pack, *_rest) in RK4_TRACERS.items():
        table = field_model(interp).table(m, grid).contiguous()
        packed = getattr(kernels, pack)(table, grid)
        order = kernels.ray_order(o, d, grid)
        with_ = getattr(kernels, name + "_with")

        def run(threads):
            return with_(table, grid, o, d, N_STEPS, False, packed=packed,
                         order=order, threads=threads, **kw)

        want = run(kernels.TRACE_RK4_THREADS)
        for label in builds:
            for threads in (64, 128, 256):
                got = with_lib(label, lambda: run(threads))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)
                          if b is not None),
                      f"{name}, {label}, {threads} a block: bitwise the "
                      f"default build")
        del got
        times = {}
        for pass_ in range(2):
            labels = list(builds) if pass_ == 0 else list(builds)[::-1]
            for label in labels:
                for threads in (64, 128, 256):
                    times.setdefault((label, threads), []).append(with_lib(
                        label, lambda: device_ms(lambda: run(threads),
                                                 reps)))
        for (label, threads), ms in times.items():
            print(f"  {name} (packed, sorted; the tracer alone), {label}, "
                  f"{threads} a block: {', '.join(f'{x:.4f}' for x in ms)} "
                  f"ms")
        call_ms = device_ms(lambda: getattr(kernels, name)(
            table, grid, o, d, N_STEPS, False, **kw), reps)
        print(f"  {name}'s call (pack, sort, trace) on the default build: "
              f"{call_ms:.4f} ms")
        del table, packed, want
        torch.cuda.empty_cache()
    # K1s's rk4, which takes the study build's budget (cubic's in the
    # default build)
    bg = chapman.background_ne_fn()
    pert = fermat.split_perturbation(m, grid, bg).contiguous()
    params = bg.kernel_params(dev)

    def k1s():
        return kernels.trace_split(pert, grid, o, d, N_STEPS, False, rk4=True,
                                   background=params, **kw)

    want = k1s()
    times = {}
    for pass_ in range(2):
        for label in (list(builds) if pass_ == 0 else list(builds)[::-1]):
            if pass_ == 0:
                got = with_lib(label, k1s)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)
                          if b is not None),
                      f"K1s rk4@{N_STEPS}, {label}: bitwise the default "
                      f"build")
            times.setdefault(label, []).append(
                with_lib(label, lambda: device_ms(k1s, reps)))
    for label, ms in times.items():
        print(f"  K1s rk4@{N_STEPS} at {o.shape[0]} rays (its call, 256 a "
              f"block), {label}: {', '.join(f'{x:.4f}' for x in ms)} ms")
    return 0


def rk4_cell_reuse(fermat, mods, interp, m, grid, o, d, n_steps=N_STEPS):
    """The share of rays, by rk4 stage (1-4), whose evaluation falls in the
    cell (the model's rows and z taps) of the one before it (stage 1: the
    last step's stage 4, or the origin's), over the plain loop with the
    model's evaluator."""
    _, _, mod, live, *_ = RK4_TRACERS[interp]
    calls, prev = [0], [None]
    hits = torch.zeros(4, dtype=torch.int64, device=o.device)
    vg = fermat.field_evaluator(m, grid, interp)

    def counted(x):
        ri, _, zi, _ = mods[mod].row_setup(grid, x)
        key = torch.cat([ri[:, :live], zi], 1)
        if prev[0] is not None:
            hits[(calls[0] - 1) % 4] += (key == prev[0]).all(1).sum()
        prev[0], calls[0] = key, calls[0] + 1
        return vg(x)

    fermat._trace_impl(fermat.log_field_ne_vg(counted), o, d, FREQ_HZ,
                       LENGTH_KM, n_steps, False, "rk4")
    return (hits.double() / (o.shape[0] * n_steps)).tolist()


def rk4_ptxas(log):
    """(K1r kernel: its evaluator and budget, "N bytes stack frame, ...
    Used R registers") of each rk4 kernel in an nvcc -Xptxas -v log."""
    import re

    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = None
            if "trace_ordered_kernelILb1E" in mangled:
                ev = re.search(r"(LogNe|SplitNe)I(\d+)", mangled)
                if ev is None:
                    ev = "?"
                elif ev.group(1) == "SplitNe":
                    rest = mangled[ev.end() + int(ev.group(2)):]
                    n = re.match(r"(\d+)", rest)
                    bg = (rest[len(n.group(1)):len(n.group(1))
                               + int(n.group(1))] if n else "?")
                    ev = (f"K1s {mangled[ev.end():ev.end() + int(ev.group(2))]}"
                          f" over {bg}")
                else:
                    ev = mangled[ev.end():ev.end() + int(ev.group(2))]
                budget = re.findall(r"Li(\d+)E", mangled)
                name = f"{ev} (budget {budget[-1] if budget else '?'})"
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, f"{frame}; {line.split(':', 1)[1].strip()}"))
            name, frame = None, ""
    return out


# The tracers whose loop the issue-slot bound counts: label -> (rk4, else
# leapfrog; evaluator type). The evaluator fragments are the mangled type
# names' own (length prefix included), so zp's never matches zpc's.
TRACER_SASS = {
    "K1 (zp)": (False, "5LogNeI17ZpValueGradPacked"),
    "K1c (cubic)": (False, "5LogNeI20CubicValueGradPacked"),
    "K1z (zpc)": (False, "5LogNeI18ZpcValueGradPacked"),
    "K1q (quadratic)": (False, "5LogNeI19QuadValueGradPacked"),
    "K1r zp": (True, "5LogNeI17ZpValueGradPacked"),
    "K1r cubic": (True, "5LogNeI20CubicValueGradPacked"),
    "K1r zpc": (True, "5LogNeI18ZpcValueGradPacked"),
    "K1r quadratic": (True, "5LogNeI19QuadValueGradPacked"),
    "K1s leapfrog": (False, "7SplitNeI19PertValueGradPacked12ChapmanLayerE"),
    "K1s rk4": (True, "7SplitNeI19PertValueGradPacked12ChapmanLayerE"),
    "K1s leapfrog, general": (
        False, "7SplitNeI19PertValueGradPacked17ChapmanBackgroundE"),
    "K1s rk4, general": (
        True, "7SplitNeI19PertValueGradPacked17ChapmanBackgroundE"),
}
#: the tracers whose register budget --k1zq-study sweeps
BUDGET_STUDIED = ("K1z (zpc)", "K1q (quadratic)", "K1s leapfrog", "K1s rk4")


def tracer_kernels(funcs, rk4, ev):
    """The mangled names in ``funcs`` of the tracer kernel that integrates
    with rk4 (else leapfrog) over evaluator ``ev``:
    ``trace_ordered_kernel<kRk4, kMinBlocks, NeField>``, or in a parent
    tree whose launches were separate templates, ``trace_rk4_kernel``,
    ``trace_leapfrog_budget_kernel`` or ``trace_ordered_kernel<NeField>``."""
    marks = ((f"trace_ordered_kernelILb{int(rk4)}E",)
             + (("trace_rk4_kernelI",) if rk4 else
                ("trace_leapfrog_budget_kernelI",
                 "trace_ordered_kernelI" + ev)))
    return [k for k in funcs if ev in k and any(m in k for m in marks)]


# SASS opcodes by the unit that executes them, for the counts the study
# prints beside the issue-slot bound (every instruction takes an issue slot)
SASS_CLASSES = {
    "fp32": ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FRND", "FCHK",
             "FSET", "FSWZADD"),
    "int": ("IMAD", "IADD3", "IADD", "LEA", "LOP3", "SHF", "ISETP", "IMNMX",
            "SEL", "IABS", "PRMT", "VIADD", "VIMNMX", "IMUL", "POPC", "FLO",
            "BREV", "SGXT", "BMSK"),
    "mufu": ("MUFU",),
    "convert": ("F2I", "I2F", "F2F", "I2FP", "F2IP", "FRND"),
    "load/store": ("LDG", "STG", "LD", "ST", "LDC", "LDS", "STS", "LDL", "STL",
                   "ATOM", "ATOMG", "RED"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BAR", "YIELD", "JMP", "BREAK", "NOP"),
}


def ptxas_by_kernel(log):
    """{mangled kernel: (registers, stack bytes, spill store bytes, spill
    load bytes)} from an nvcc -Xptxas -v log."""
    import re

    out, name, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "stack frame" in line:
            frame = tuple(int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = (regs, *frame)
            name, frame = None, (0, 0, 0)
    return out


def sass_functions(lib_path):
    """{mangled kernel: [(address, instruction)]} of a built library, from
    ``cuobjdump -sass``; a label stands for the address of the instruction
    after it and a branch's target is kept as an address."""
    import re
    import shutil as _shutil

    tool = _shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name, body, labels, pending = {}, None, [], {}, []
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")

    def close():
        if name is not None:
            resolved = []
            for addr, text_ in body:
                m = re.search(r"`?\((\.L_x_\d+)\)", text_)
                if m and m.group(1) in labels:
                    text_ = text_.replace(m.group(0),
                                          f"0x{labels[m.group(1)]:x}")
                resolved.append((addr, text_))
            funcs[name] = resolved

    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            close()
            name, body, labels, pending = s.split(":", 1)[1].strip(), [], {}, []
        elif re.match(r"^\.L_x_\d+:", s):
            pending.append(s[:-1])
        else:
            m = ins.search(line)
            if m and name is not None:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                body.append((addr, m.group(2)))
    close()
    return funcs


def loop_body(instrs):
    """The instructions of a kernel's outermost loop: from the target of
    its longest backward branch to that branch."""
    import re

    best = None
    for addr, text in instrs:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        return []
    return [(a, t) for a, t in instrs if best[0] <= a <= best[1]]


def executed(body):
    """The instructions of a loop body that a step runs when no IEEE
    division or square root takes its slow path: the stubs that a
    predicated forward branch skips (at most 8 instructions around a call
    of the slow path's subroutine) are left out. The path's stores are
    predicated, and counted."""
    import re

    skipped = set()
    for addr, text in body:
        m = re.match(r"@!?U?P\d\s+BRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            span = [(a, t) for a, t in body
                    if addr < a < int(m.group(1), 16)]
            if len(span) <= 8 and any(t.startswith("CALL") for _, t in span):
                skipped.update(a for a, _ in span)
    return [(a, t) for a, t in body if a not in skipped]


def sass_counts(body):
    """Instructions of a loop body (NOPs left out), by class and, for MUFU,
    by function."""
    counts = {"all": 0, "other": 0, **{k: 0 for k in SASS_CLASSES}}
    mufu = {}
    for _, text in body:
        op = text.split()
        op = op[1] if op[0].startswith("@") else op[0]
        base = op.split(".")[0]
        if base == "NOP":
            continue
        counts["all"] += 1
        cls = next((k for k, v in SASS_CLASSES.items() if base in v
                    or (base.startswith("U") and base[1:] in v)), "other")
        counts[cls] += 1
        if base == "MUFU":
            fn = op.split(".")[1] if "." in op else "?"
            mufu[fn] = mufu.get(fn, 0) + 1
    counts["mufu_by_function"] = mufu
    return counts


def theoretical_occupancy(regs, threads):
    """Warps an SM can hold over its 64 at ``regs`` registers a thread and
    ``threads`` a block (registers allocated 256 a warp; at most 32 blocks
    and 2048 threads an SM)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * warps), 32, 2048 // threads)
    return blocks * warps / 64


def issue_bound_ms(instructions, rays, steps, clock_mhz, sms):
    """The least time for rays × steps executions of a loop body of
    ``instructions`` instructions a thread, at one warp instruction a clock
    on each of an SM's 4 schedulers (32 thread instructions each)."""
    return rays * steps * instructions / (sms * 4 * 32 * clock_mhz * 1e6) \
        * 1e3


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def clocks_under(fn, seconds=2.0):
    """(SM clock MHz, power W) samples of nvidia-smi every 100 ms while
    ``fn`` runs back to back for ``seconds``; the sampler is stopped before
    returning."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100", "--id=0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    samples = []
    for line in out.splitlines():
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((mhz, watts))
    return samples[2:] or samples


def call_pieces(name, kernels, grid, o, d, pack, tracer_label, tracer,
                call, reps):
    """A sorting and packing call's pieces at one batch, each by its own
    device time (the ray order's keys, their sort and its cast to int32,
    the pack, the tracer), and the whole call by device time and on the
    stream (CUDA events, the gaps between kernels included)."""
    keys = kernels.ray_order_keys(o, d, grid)
    idx = torch.sort(keys).indices
    pieces = {"keys": lambda: kernels.ray_order_keys(o, d, grid),
              "sort": lambda: torch.sort(keys),
              "cast": lambda: idx.to(torch.int32),
              "pack": pack, tracer_label: tracer}
    ms = {k: device_ms(f, reps * 5) for k, f in pieces.items()}
    whole = device_ms(call, reps * 5)
    wall = cuda_ms(call, 20)
    print(f"  {name}'s call at {o.shape[0]} rays: " + "; ".join(
        f"{k} {v:.4f}" for k, v in ms.items())
          + f" ms; their sum {sum(ms.values()):.4f}; the call "
          f"{whole:.4f} ms of device time, {wall:.4f} ms on the stream "
          f"(CUDA events, gaps included)")
    return ms, whole


def k1s_sweep(builds, with_lib, loops, regs, bound_of, grid, mp, o_all,
              d_all, order, sms, card, reps):
    """--k1zq-study's K1s: the split tracer on the single-layer background
    (``background_ne_fn()``, the one-layer form) over the perturbation of
    phase 14's world at the bench's 262,144 rays, leapfrog@32 and rk4@64:
    the tracer alone (packed, sorted) in each build (register budgets 0-4
    of both integrators) × 64/128/256 a block, and the general form in the
    default build, each bitwise the unpacked general form in ray order,
    two passes in opposite orders; then, in the fastest leapfrog build, the
    call's pieces and where sorting and packing pays: sorted and packed,
    packed in ray order, or the table as it is, at 10,000-262,144 rays."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.geometry import fermat
    from ionotomo_tpu_torch.models import chapman

    bg = chapman.background_ne_fn()
    pert = fermat.split_perturbation(mp, grid, bg).contiguous()
    params = bg.kernel_params(grid.origin.device)
    packed = kernels.pack_z_taps(pert, grid)
    n_rays = o_all.shape[0]
    fastest = {}
    for method, steps in (("leapfrog", 32), ("rk4", N_STEPS)):
        rk4 = method == "rk4"
        kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, steps)
        tracer = f"K1s {method}"

        def run(threads, form=None, pk=packed, od=order, o=o_all, d=d_all):
            return kernels.trace_split_with(
                pert, grid, o, d, steps, False, packed=pk, order=od,
                threads=threads, rk4=rk4, background=params, form=form, **kw)

        want = run(128, "general", None, None)
        variants = [(label, t, "layer") for label in builds
                    for t in (64, 128, 256)]
        variants += [("default", t, "general") for t in (64, 128, 256)]
        for label, t, form in variants:
            got = with_lib(label, lambda: run(t, form))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)
                      if b is not None),
                  f"K1s {method}@{steps}, {label}, {t} a block, {form} "
                  f"form, packed and sorted: bitwise the unpacked general "
                  f"form in ray order")
        del got
        times = {}
        for pass_ in range(2):
            for label, t, form in (variants if pass_ == 0
                                   else variants[::-1]):
                times.setdefault((label, t, form), []).append(with_lib(
                    label, lambda: device_ms(lambda: run(t, form), reps)))
        print(f"  K1s {method}@{steps}, the tracer alone (packed, sorted) at "
              f"{n_rays} rays on {card}:")
        for (label, t, form), ms in times.items():
            key = (label, tracer + (", general" if form == "general" else ""))
            extra = ""
            if key in loops:
                instr, b_ms = bound_of(*key, steps, n_rays)
                r = regs[key][0]
                extra = (f"; {r} registers, occupancy "
                         f"{theoretical_occupancy(r, t):.3f}, spills "
                         f"{regs[key][2]}/{regs[key][3]} B; issue-slot bound "
                         f"{b_ms:.4f} ms ({instr:.0f} instructions a step), "
                         f"{b_ms / min(ms):.3f} of it")
            print(f"    {label}, {t} a block, {form} form: "
                  f"{', '.join(f'{x:.4f}' for x in ms)} ms{extra}")
        best = min(times.items(), key=lambda kv: min(kv[1]))
        fastest[method] = best[0]
        print(f"  K1s {method}@{steps}: fastest {best[0]} {min(best[1]):.4f} "
              f"ms")

    # leapfrog@32 in its fastest build: the call's pieces, and where
    # sorting and packing pays
    label, threads, _ = fastest["leapfrog"]
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, 32)

    def trace(o, d, pk, od, t):
        return kernels.trace_split_with(
            pert, grid, o, d, 32, False, packed=pk, order=od, threads=t,
            rk4=False, background=params, **kw)

    print(f"  K1s leapfrog@32 in the build '{label}':")
    with_lib(label, lambda: call_pieces(
        "trace_split (leapfrog@32)", kernels, grid, o_all, d_all,
        lambda: kernels.pack_z_taps(pert, grid),
        f"tracer ({threads} a block)",
        lambda: trace(o_all, d_all, packed, order, threads),
        lambda: kernels.trace_split(pert, grid, o_all, d_all, 32, False,
                                    rk4=False, background=params, **kw),
        reps))
    for n in (10000, 64 * sms, 128 * sms, 192 * sms, 256 * sms, 320 * sms,
              384 * sms, 448 * sms, 512 * sms, 640 * sms, 768 * sms,
              1024 * sms, n_rays):
        on, dn = o_all[:n].contiguous(), d_all[:n].contiguous()
        ways = {f"as it is, {t}": (lambda t=t: trace(on, dn, None, None, t))
                for t in (32, 64)}
        ways.update({f"packed in ray order, {t}": (
            lambda t=t: trace(on, dn, kernels.pack_z_taps(pert, grid), None,
                              t)) for t in (32, 64, 128)})
        ways.update({f"sorted and packed, {t}": (
            lambda t=t: trace(on, dn, kernels.pack_z_taps(pert, grid),
                              kernels.ray_order(on, dn, grid), t))
            for t in (64, 128, 256)})
        print(f"  K1s leapfrog@32 at {n} rays ({n / sms:.0f} an SM), the "
              f"call: " + "; ".join(
                  f"{k} {with_lib(label, lambda: device_ms(f, reps)):.4f}"
                  for k, f in ways.items()) + " ms")


def k1zq_study(parent_dir=None, reps=3) -> int:
    """``--k1zq-study``: what binds K1z and K1q at the bench's batch
    (262,144 rays × 64 steps, the 128³ Chapman cube, 150 MHz, 1000 km):
    (a) ptxas's registers, stack and spills of every tracer kernel in every
    build; (b) the issue-slot bound of every tracer's leapfrog (or rk4)
    step: the SASS instructions a step of its loop runs (``cuobjdump
    -sass``, the span of the loop's backward branch less the slow paths'
    stubs, ``executed``; the loop bodies written under
    ``build/k1zq_sass/``) × rays × steps over 132 SMs × 4 schedulers
    × 32 lanes × the card's maximum SM clock, beside the tracer alone and
    its theoretical occupancy; (c) the tracer alone (packed, sorted) at
    register budgets of 0-4 blocks of 256 an SM (libraries built with
    ``-DK1_MIN_BLOCKS=n``, 0 the compiler's registers) × 64/128/256 rays a
    block, two passes in opposite orders, and with ``--parent DIR`` the
    parent's launch; (d) the call's pieces (keys, sort, cast, pack,
    tracer) and the whole call, the SM clock under the tracer, and the call
    sorted and packed against the table as it is at 10,000 to 262,144
    rays. Every variant is bitwise the unpacked evaluator in ray order."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core.field_models import field_model
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.geometry import fermat
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.models import chapman

    dev = torch.device("cuda", 0)
    card = card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(nvidia_smi("clocks.max.sm"))
    print(f"card: {card}; {sms} SMs, max SM clock {clock:.0f} MHz")
    out_dir = Path(__file__).resolve().parent / "build" / "k1zq_sass"
    out_dir.mkdir(parents=True, exist_ok=True)

    builds = {"default": ()}
    for b in range(0, 5):    # 0: no budget, the compiler's registers
        builds[f"budget {b}"] = (f"K1_MIN_BLOCKS={b}", f"K1R_MIN_BLOCKS={b}")
    libs, regs, loops = {}, {}, {}
    parent = Parent(parent_dir) if parent_dir else None
    infos = {label: build.build(defines=defines)
             for label, defines in builds.items()}
    if parent is not None:
        infos["parent"] = parent.info
    for label, info in infos.items():
        if label != "parent":
            libs[label] = build.open_library(info["path"])
        by_kernel = ptxas_by_kernel(info["log"])
        funcs = sass_functions(info["path"])
        for tracer, (rk4, ev) in TRACER_SASS.items():
            if label != "default" and tracer not in BUDGET_STUDIED:
                continue
            hits = tracer_kernels(funcs, rk4, ev)
            if len(hits) != 1:
                print(f"  {label}: {tracer}: {len(hits)} kernels match; "
                      f"skipped")
                continue
            body = loop_body(funcs[hits[0]])
            counts = sass_counts(executed(body))
            regs[label, tracer] = by_kernel.get(hits[0], (0, 0, 0, 0))
            loops[label, tracer] = counts
            (out_dir / f"{label}_{tracer}.sass".replace(" ", "_").replace(
                ",", "").replace("'", "").replace("(", "").replace(
                ")", "")).write_text("\n".join(f"/*{a:05x}*/ {t}"
                                               for a, t in body))
            r, stack, st, ld = regs[label, tracer]
            print(f"  {label}: {tracer}: {r} registers, {stack} B stack, "
                  f"{st}/{ld} B spill stores/loads; loop {len(body)} "
                  f"instructions, {counts['all']} run a step ("
                  + ", ".join(f"{k} {v}" for k, v in counts.items()
                              if k not in ("all", "mufu_by_function") and v)
                  + f"; MUFU {counts['mufu_by_function']})")
    default = build.load()

    def with_lib(label, fn):
        if label == "parent":
            return parent.run(fn)
        build._loaded["lib"] = libs[label]
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    def bound_of(label, tracer, steps, rays):
        instr = loops[label, tracer]["all"]
        return instr, issue_bound_ms(instr, rays, steps, clock, sms)

    grid = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    o_all, d_all = (torch.from_numpy(a).to(dev) for a in bench_rays(262144))
    o, d = o_all, d_all
    n_rays = o.shape[0]
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    order = kernels.ray_order(o, d, grid)
    thread_choices = (64, 128, 256)

    for interp, (_, _, _, _, name, pack, _) in NEW_MODELS.items():
        tracer = "K1z (zpc)" if interp == "zpc" else "K1q (quadratic)"
        table = field_model(interp).table(m, grid).contiguous()
        packed = getattr(kernels, pack)(table, grid)
        with_ = getattr(kernels, name + "_with")

        def run(threads, pk=packed, od=order):
            return with_(table, grid, o, d, N_STEPS, False, packed=pk,
                         order=od, threads=threads, **kw)

        want = run(128, None, None)
        variants = [(label, t) for label in builds for t in thread_choices]
        if parent is not None:
            variants += [("parent", t) for t in thread_choices]
        for label, t in variants:
            got = with_lib(label, lambda: run(t))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)
                      if b is not None),
                  f"{name}, {label}, {t} a block, packed and sorted: bitwise "
                  f"the unpacked evaluator in ray order")
        del got
        times = {}
        for pass_ in range(2):
            for label, t in (variants if pass_ == 0 else variants[::-1]):
                times.setdefault((label, t), []).append(with_lib(
                    label, lambda: device_ms(lambda: run(t), reps)))
        print(f"  {name}, the tracer alone (packed, sorted) at {n_rays} rays "
              f"x {N_STEPS} steps on {card}:")
        for (label, t), ms in times.items():
            key = (label, tracer)
            extra = ""
            if key in loops:
                instr, b_ms = bound_of(*key, N_STEPS, n_rays)
                r = regs[key][0]
                extra = (f"; {r} registers, occupancy "
                         f"{theoretical_occupancy(r, t):.3f}, spills "
                         f"{regs[key][2]}/{regs[key][3]} B; issue-slot bound "
                         f"{b_ms:.4f} ms ({instr:.0f} instructions a step), "
                         f"{b_ms / min(ms):.3f} of it")
            print(f"    {label}, {t} a block: "
                  f"{', '.join(f'{x:.4f}' for x in ms)} ms{extra}")
        best = min(times.items(), key=lambda kv: min(kv[1]))
        print(f"  {name}: fastest {best[0]} {min(best[1]):.4f} ms")

        # (d) the call's pieces, and the call whole, at the bench's batch
        threads = kernels.sort_and_pack(name, n_rays, sms)[1]
        call_pieces(name, kernels, grid, o, d,
                    lambda: getattr(kernels, pack)(table, grid),
                    f"tracer ({threads} a block)", lambda: run(threads),
                    lambda: getattr(kernels, name)(table, grid, o, d, N_STEPS,
                                                   False, **kw), reps)
        samples = clocks_under(lambda: run(threads))
        if samples:
            mhz = sorted(s[0] for s in samples)
            print(f"  {name}: SM clock under the tracer {mhz[0]:.0f}-"
                  f"{mhz[-1]:.0f} MHz (median {mhz[len(mhz) // 2]:.0f}), "
                  f"power {max(s[1] for s in samples):.1f} W at most, "
                  f"{len(samples)} samples")

        # where sorting and packing pays: the whole call at batches of the
        # bench's rays, as it is (32 or 64 a block) or sorted and packed
        for n in (10000, 128 * sms, 192 * sms, 256 * sms, 320 * sms,
                  384 * sms, 448 * sms, 512 * sms, 640 * sms, 768 * sms,
                  1024 * sms, n_rays):
            on, dn = o_all[:n].contiguous(), d_all[:n].contiguous()

            def as_is(t, on=on, dn=dn):
                return with_(table, grid, on, dn, N_STEPS, False,
                             packed=None, order=None, threads=t, **kw)

            def sorted_packed(t, on=on, dn=dn):
                return with_(table, grid, on, dn, N_STEPS, False,
                             packed=getattr(kernels, pack)(table, grid),
                             order=kernels.ray_order(on, dn, grid),
                             threads=t, **kw)

            ways = {f"as it is, {t}": (lambda t=t: as_is(t)) for t in (32, 64)}
            ways.update({f"sorted and packed, {t}":
                         (lambda t=t: sorted_packed(t))
                         for t in thread_choices})
            print(f"  {name} at {n} rays ({n / sms:.0f} an SM), the call: "
                  + "; ".join(f"{k} {device_ms(f, reps):.4f}"
                              for k, f in ways.items()) + " ms")
        del table, packed, want
        torch.cuda.empty_cache()

    grid_cpu = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device="cpu")
    mp = torch.from_numpy(perturbed_log_field(
        grid_cpu, np.random.default_rng(14), chapman)).to(dev)
    k1s_sweep(builds, with_lib, loops, regs, bound_of, grid, mp, o_all,
              d_all, order, sms, card, reps)

    # (b) for the other tracers: the tracer alone at its launch beside its
    # issue-slot bound
    others = []
    for label, interp, world, with_name, pack, threads, steps in (
            ("K1 (zp)", "zp", m, "trace_leapfrog_zp", "pack_zp_taps", 64,
             N_STEPS),
            ("K1c (cubic)", "cubic", m, "trace_leapfrog_cubic",
             "pack_z_taps", 256, N_STEPS),
            ("K1r zp", "zp", mp, "trace_rk4_zp", "pack_zp_taps", 256,
             N_STEPS),
            ("K1r cubic", "cubic", mp, "trace_rk4_cubic", "pack_z_taps", 256,
             N_STEPS),
            ("K1r zpc", "zpc", mp, "trace_rk4_zpc", "pack_z_taps", 256,
             N_STEPS),
            ("K1r quadratic", "quadratic", mp, "trace_rk4_quad",
             "pack_zp_taps", 256, N_STEPS)):
        table = field_model(interp).table(world, grid).contiguous()
        packed = getattr(kernels, pack)(table, grid)
        fn = (lambda w=getattr(kernels, with_name + "_with"), tb=table,
              pk=packed, t=threads, s=steps: w(
                  tb, grid, o, d, s, False, packed=pk, order=order,
                  threads=t, **kw))
        others.append((label, steps, threads, fn))
    bg = chapman.background_ne_fn()
    pert = fermat.split_perturbation(mp, grid, bg).contiguous()
    params = bg.kernel_params(dev)
    packed_pert = kernels.pack_z_taps(pert, grid)
    for label, steps, rk4, form in (
            ("K1s leapfrog", 32, False, "layer"),
            ("K1s rk4", N_STEPS, True, "layer"),
            ("K1s leapfrog, general", 32, False, "general"),
            ("K1s rk4, general", N_STEPS, True, "general")):
        threads = kernels.TRACE_RK4_THREADS if rk4 else \
            kernels.SORT_AND_PACK["trace_split"][1]
        others.append((label, steps, threads, lambda s=steps, r=rk4, f=form,
                       t=threads: kernels.trace_split_with(
                           pert, grid, o, d, s, False, packed=packed_pert,
                           order=order, threads=t, rk4=r, background=params,
                           form=f, **fermat._step_constants(
                               FREQ_HZ, LENGTH_KM, s))))
    print(f"  the issue-slot bound of every tracer's step at {n_rays} rays "
          f"(max SM clock {clock:.0f} MHz), beside the tracer alone (packed, "
          f"sorted) on {card}:")
    for label, steps, threads, fn in others:
        ms = min(device_ms(fn, reps) for _ in range(2))
        if ("default", label) not in loops:
            print(f"    {label}: {ms:.4f} ms (no loop found)")
            continue
        instr, b_ms = bound_of("default", label, steps, n_rays)
        counts = loops["default", label]
        r = regs["default", label][0]
        print(f"    {label} ({steps} steps, {threads} a block): {ms:.4f} ms; "
              f"{instr:.0f} instructions a step, issue-slot bound "
              f"{b_ms:.4f} ms, {b_ms / ms:.3f} of it; {r} registers, "
              f"occupancy {theoretical_occupancy(r, threads):.3f}; MUFU "
              f"{counts['mufu_by_function']}")
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


def e_study(parent_dir=None, reps=50) -> int:
    """``--e-study``: what binds E, the endpoint value + gradient kernels,
    at the main paths' endpoints: K1e at serving's 1,240 (phase 4's first
    epoch) and at config 3b's and config 5's 20,000; K5 at config 4's
    20,000; E over 8 members at config 5's 20,000, eight launches of K1e
    against one of the batched K1e (over a pack made beforehand, as the
    operator shares K2b's). Each kernel at 32, 64, 128 and 256 threads a
    block (the library built again for each through ``build.build(defines=
    ...)``; the batched K1e at its own rule's, which ``--member-study``
    sweeps), in ray order and in endpoint order (the endpoints sorted by
    their stencil's base cell, ``kernels.point_order``: the kernels read
    them permuted and leave their outputs in that
    order, so the order's reads are timed without the scattered writes an
    ordered kernel would add), every variant bitwise the default build in
    ray order (permuted alike), timed in two passes of opposite order.
    Each shape's bound: the distinct table values its endpoints touch (all
    members for the batched shape), the points read and the outputs
    written once. Prints ptxas's registers of each build. Then K6z
    against its launch floor (``k6z_floor``) and K6q at four shapes
    (``k6q_shapes``; with DIR, in turns with the parent's)."""
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
    names = ("ZP_VALUE_GRAD_THREADS", "CUBIC_VALUE_GRAD_THREADS")
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
        return kernels.point_order(pts, grid, model.POINT_RULE,
                                   model.base_cell).long()

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
    k6z_floor(dev, configs, chapman, tec, zpcubic, kernels, reps)
    k6q_shapes(dev, kernels, triquadratic, fermat, Grid3D, chapman, reps,
               Parent(parent_dir) if parent_dir else None)
    return 0


def same_sass_as_parent(parent):
    """With a parent: every kernel that this checkout's library and the
    parent's both hold (a kernel that this checkout changed took another
    name: the keys' arguments, K6q's kernel) is the same SASS, instruction
    for instruction; K1q and K1r on quadratic (the kernels over
    ``QuadValueGrad``, whose ``quad_contract`` this checkout cut into
    ``quad_plane``, ``quad_add_plane`` and ``quad_finish``) among them.
    A kernel in an anonymous namespace is named with a hash of its build;
    the names are compared without it."""
    import re

    from ionotomo_tpu_torch.kernels import build

    def by_name(path):
        funcs = sass_functions(path)
        out = {re.sub(r"_[0-9a-f]{8}(?=_)", "_#", k): v
               for k, v in funcs.items()}
        check(len(out) == len(funcs), f"{path}: the kernels' names without "
              f"their build's hash are distinct")
        return out

    new = by_name(build.build()["path"])
    old = by_name(parent.info["path"])
    common = sorted(set(new) & set(old))
    differ = [k for k in common
              if [t for _, t in new[k]] != [t for _, t in old[k]]]
    quad = [k for k in common if "QuadValueGrad" in k]
    print(f"  SASS against the parent's: {len(common)} kernels in both, "
          f"{len(differ)} differ ({', '.join(k[:60] for k in differ)}); "
          f"only the parent's: {sorted(set(old) - set(new))}, only this "
          f"checkout's: {sorted(set(new) - set(old))}")
    check(len(quad) >= 2 and not differ,
          f"the SASS of the {len(common)} kernels in both libraries the "
          f"parent's, the {len(quad)} K1q and K1r kernels on quadratic "
          f"among them")


def k6q_shapes(dev, kernels, triquadratic, fermat, Grid3D, chapman, reps,
               parent=None):
    """--e-study's K6q (``k6_at``: bitwise, against its plain version, in
    turns with its launch floor, beside its bound; with a parent, bitwise
    the parent's and in turns with it) at the bench trace's 262,144 points
    halfway along the rays of the 128³ Chapman world, their first 1,240,
    the 917,504 edge-case points of a random 128³ table and 2²⁰ random
    points of a random 256³ one. With a parent, first
    ``same_sass_as_parent``."""
    from ionotomo_tpu_torch.testing import edge_case_points

    print("K6q (--e-study)")
    if parent is not None:
        same_sass_as_parent(parent)
    rng = np.random.default_rng(16)
    grid3 = Grid3D.from_bounds(*BOUNDS, (N_GRID,) * 3, device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid3)).contiguous()
    table3 = triquadratic.prefilter(m).reshape(N_GRID * N_GRID, N_GRID)
    o, d = (torch.from_numpy(a).to(dev) for a in bench_rays(262144))
    kw = fermat._step_constants(FREQ_HZ, LENGTH_KM, N_STEPS)
    mid = kernels.trace_leapfrog_quad(table3, grid3, o, d, N_STEPS, True,
                                      **kw)[2][:, N_STEPS // 2].contiguous()
    del o, d
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)

    def rand_table(n_grid):
        return torch.from_numpy(rng.normal(size=(n_grid * n_grid, n_grid))
                                .astype(np.float32)).to(dev)

    grid_e = Grid3D.create(origin, spacing, (N_GRID,) * 3, device=dev)
    pts_e = torch.from_numpy(edge_case_points(
        (N_GRID,) * 3, origin, spacing, 1 << 20, rng)).to(dev)
    grid_r = Grid3D.create(origin, spacing, (256,) * 3, device=dev)
    hi = np.asarray(spacing) * 255
    pts_r = torch.from_numpy((np.asarray(origin) + rng.uniform(
        0, 1, (1 << 20, 3)) * hi).astype(np.float32)).to(dev)
    shapes = [("the bench trace's 262,144 points halfway", table3, grid3,
               mid),
              ("1,240 of them", table3, grid3, mid[:1240].contiguous()),
              ("917,504 edge-case points, 128^3", rand_table(N_GRID), grid_e,
               pts_e),
              ("2^20 random points, 256^3", rand_table(256), grid_r, pts_r)]
    for label, table, grid, pts in shapes:
        k6_at(label, kernels, triquadratic, "quad_value_grad", table, grid,
              pts, reps, plain_reps=2, parent=parent)


def k6z_floor(dev, configs, chapman, tec, zpcubic, kernels, reps):
    """--e-study's K6z: its kernel against its launch floor, the same
    launch built with an empty body (a library built with
    ``-DK6Z_LAUNCH_FLOOR=1``), at 1, 1,240 and 20,000 of config 4's
    endpoints, the 917,504 edge-case points of a 128³ table and 2²⁰ random
    points of a 256³ table; in two passes of opposite order, beside the
    bound."""
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.testing import edge_case_points

    floor = build.open_library(build.build(
        defines=("K6Z_LAUNCH_FLOOR=1",))["path"])
    default = build.load()

    def with_lib(lib, fn):
        build._loaded["lib"] = lib
        try:
            return fn()
        finally:
            build._loaded["lib"] = default

    rng = np.random.default_rng(15)
    grid4, ends4 = straight_endpoints(configs, chapman, tec, dev, 256)
    table4 = torch.from_numpy(rng.normal(size=(256 * 256, 256)).astype(
        np.float32)).to(dev)
    origin, spacing = (-64.0, -32.0, 0.0), (1.0, 0.5, 8.0)
    grid_e = Grid3D.create(origin, spacing, (N_GRID,) * 3, device=dev)
    table_e = torch.from_numpy(rng.normal(size=(N_GRID * N_GRID, N_GRID))
                               .astype(np.float32)).to(dev)
    pts_e = torch.from_numpy(edge_case_points(
        (N_GRID,) * 3, origin, spacing, 1 << 20, rng).astype(np.float32)
    ).to(dev)
    grid_r = Grid3D.create(origin, spacing, (256,) * 3, device=dev)
    hi = np.asarray(spacing) * 255
    pts_r = torch.from_numpy((np.asarray(origin) + rng.uniform(
        0, 1, (1 << 20, 3)) * hi).astype(np.float32)).to(dev)
    for label, table, grid, pts in (
            ("1 of config 4's endpoints", table4, grid4, ends4[:1]),
            ("1,240 of config 4's endpoints", table4, grid4, ends4[:1240]),
            ("config 4's 20,000 endpoints", table4, grid4, ends4),
            ("917,504 edge-case points, 128^3", table_e, grid_e, pts_e),
            ("2^20 random points, 256^3", table4, grid_r, pts_r)):
        def fn():
            return kernels.zpc_value_grad(table, grid, pts)

        times = {"kernel": [], "floor": []}
        for turn in (("kernel", "floor"), ("floor", "kernel")):
            for who in turn:
                times[who].append(with_lib(default if who == "kernel"
                                           else floor,
                                           lambda: device_ms(fn, reps)))
        b_ms, b_by = k6_bound(zpcubic, 7, FLOPS_K6Z_POINT, grid, pts)
        print(f"  K6z at {label} ({pts.shape[0]} points): kernel "
              f"{', '.join(f'{x:.4f}' for x in times['kernel'])} ms, its "
              f"launch floor {', '.join(f'{x:.4f}' for x in times['floor'])}"
              f" ms, bound {b_ms:.6f} ms ({b_by})")


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


#: ``--member-study``'s sweep of the fold's grid: blocks an SM.
FOLD_STUDY_BLOCKS = (4, 8, 16, 64)
#: ... and of the batched K1e: lanes a point and threads a block, and
#: the uniform points of config 5's grid that place the lanes' crossovers.
K1EB_STUDY_LANES = (4, 8)
K1EB_STUDY_THREADS = (32, 64, 128, 256)
K1EB_STUDY_POINTS = (2500, 5000, 10000, 20000, 40000, 80000, 160000,
                     320000, 640000)


def member_study(parent_dir=None, reps=10) -> int:
    """``--member-study [--parent DIR]``: what K2b's, K3b's and the
    batched K1e's calls spend, kernel by kernel. (1) K2b and K3b at config
    5's two bundles and the zp edge-case points (8 members), by kernel,
    and both built three more ways through ``build.build(defines=...)``:
    K3b's scan without its cut-off at the longest run (``K3B_FULL_SCAN``:
    all five steps, as K3 takes them), its reduce's registers set for 4
    blocks an SM (``K3B_MIN_BLOCKS``), K2b's gather's for 3
    (``K2B_MIN_BLOCKS``; the defaults leave the compiler its choice); each
    build's K2b and K3b bitwise the default build's. (2) K3b's fold alone
    over each bundle's spans (``fold_line``; with DIR bitwise the parent's
    and in turns with it) and at ``FOLD_STUDY_BLOCKS`` blocks an SM
    (``kernels.FOLD_BLOCKS_PER_SM``), in two passes of opposite order. (3) The batched K1e at 1,240 and 20,000 of
    config 5's endpoints and the 917,504 edge-case points: every lanes a
    point and threads a block of ``K1EB_STUDY_LANES`` x
    ``K1EB_STUDY_THREADS`` (the rule's threshold forced), the rule's launch
    with an empty body (``K1EB_LAUNCH_FLOOR=1``: the launch floor) and,
    with DIR, the parent's kernel; then each lanes at the rule's threads
    at ``K1EB_STUDY_POINTS`` uniform points of config 5's grid, which
    place the rule's crossovers; all bitwise the rule's, in two passes of
    opposite order, beside the bound. Prints ptxas's registers of the
    member kernels."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core import boxspline, tricubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.kernels import build
    from ionotomo_tpu_torch.testing import edge_case_points

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    parent = Parent(parent_dir) if parent_dir else None
    variants = {"default": (), "full scan": ("K3B_FULL_SCAN=1",),
                "reduce 4 blocks": ("K3B_MIN_BLOCKS=4",),
                "gather 3 blocks": ("K2B_MIN_BLOCKS=3",),
                "K1e launch floor": ("K1EB_LAUNCH_FLOOR=1",)}
    libs = {}
    for label, defines in variants.items():
        info = build.build(defines=defines)
        libs[label] = build.open_library(info["path"])
        for name, used in ptxas_lines(info["log"], (
                "rows_value_bwd_batched_kernel", "fold_member_rows_kernel",
                "rows_value_fwd_batched_kernel", "pack_members_kernel",
                "zp_value_grad_batched_kernel")):
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
    ends = tec._endpoint_tangents(w.rays.points)[0]
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
    k3b_variants = ("default", "full scan", "reduce 4 blocks",
                    "gather 3 blocks")
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
            for variant in k3b_variants:
                got = with_lib(variant, fn)
                torch.cuda.synchronize()
                check(bool(torch.equal(got, want)),
                      f"{name} at {label}, {variant}: bitwise the default "
                      f"build")
                ms = with_lib(variant, lambda: device_ms(fn, reps))
                print(f"  {name} at {label}, {variant}: {ms:.4f} ms")
            del want, got
        fold_line(label, tricubic, kernels, plan, zi, b, nz_, rng, parent)
        spans = tricubic.segment_spans_ref(plan, zi, nz_)
        parts = torch.from_numpy(rng.normal(size=(b, plan.n_seg_max, nz_))
                                 .astype(np.float32)).to(dev)
        out = torch.zeros((b, n_rows, nz_), dtype=torch.float32, device=dev)

        def fold():
            return kernels.fold_member_rows(parts, plan, out, spans)
        want = fold().clone()
        times = {}
        for pass_ in (FOLD_STUDY_BLOCKS, FOLD_STUDY_BLOCKS[::-1]):
            for blocks in pass_:
                def at(fn):
                    return with_attr(kernels, "FOLD_BLOCKS_PER_SM", blocks,
                                     fn)
                check(bool(torch.equal(at(fold), want)),
                      f"the fold at {label}, {blocks} blocks an SM: bitwise")
                times.setdefault(blocks, []).append(
                    at(lambda: device_ms(fold, reps)))
        for blocks, t in times.items():
            print(f"  the fold at {label}, a grid of {blocks} blocks an SM: "
                  f"{', '.join(f'{x:.4f}' for x in t)} ms")
        del tables, ct, parts, out, want
        torch.cuda.empty_cache()

    tables5 = torch.from_numpy(rng.normal(size=(b, nx * ny, nz))
                               .astype(np.float32)).to(dev)
    packed5 = kernels.pack_members(tables5.view(b, -1))
    table_e = torch.from_numpy(rng.normal(size=(b, N_GRID * N_GRID, N_GRID))
                               .astype(np.float32)).to(dev)
    packed_e = kernels.pack_members(table_e.view(b, -1))
    sms = kernels.sm_count(dev)
    lo = w.grid.origin.cpu().numpy()
    hi = lo + w.grid.spacing.cpu().numpy() * (np.asarray(w.grid.shape) - 1)
    uniform = torch.from_numpy((lo + rng.uniform(0, 1, (K1EB_STUDY_POINTS[
        -1], 3)) * (hi - lo)).astype(np.float32)).to(dev)
    shapes = [("1,240 of config 5's endpoints", tables5, packed5, w.grid,
               ends[:1240].contiguous()),
              ("config 5's 20,000 endpoints", tables5, packed5, w.grid, ends),
              ("the 917,504 edge-case points", table_e, packed_e, grid, pts)]
    shapes += [(f"{n} uniform points of config 5's grid", tables5, packed5,
                w.grid, uniform[:n]) for n in K1EB_STUDY_POINTS]
    for label, tables, packed, g, p_ in shapes:
        def k1e():
            return kernels.zp_value_grad_batched(tables, g, p_, packed)

        def forced(lanes, threads, lib="default"):
            return lambda: with_lib(lib, lambda: with_attr(
                kernels, "ZP_BATCHED_EIGHT_LANES_PER_SM",
                1 << 30 if lanes == 8 else 0,
                lambda: with_attr(kernels, "ZP_BATCHED_THREADS", threads,
                                  k1e)))
        rule = kernels.zp_batched_lanes(p_.shape[0], sms)
        sweep = "uniform" not in label
        forms = {f"{lanes} lanes, {threads} threads": forced(lanes, threads)
                 for lanes in K1EB_STUDY_LANES
                 for threads in (K1EB_STUDY_THREADS if sweep
                                 else (kernels.ZP_BATCHED_THREADS,))}
        if parent is not None and sweep:
            forms["the parent's"] = lambda: parent.run(k1e)
        want = [t.clone() for t in k1e()]
        torch.cuda.synchronize()
        for form, fn in forms.items():
            got = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(got, want)),
                  f"the batched K1e at {label}, {form}: bitwise the rule's")
        if sweep:
            forms["the launch floor (the rule's grid, an empty body)"] = \
                forced(rule, kernels.ZP_BATCHED_THREADS, "K1e launch floor")
        b_ms, b_by = k1e_bound(boxspline, g, p_, members=b)
        print(f"  the batched K1e at {label}: the rule's {rule} lanes, "
              f"{kernels.ZP_BATCHED_THREADS} threads; bound {b_ms:.6f} ms "
              f"({b_by})")
        times = {}
        names = list(forms)
        for pass_ in (names, names[::-1]):
            for form in pass_:
                times.setdefault(form, []).append(device_ms(forms[form],
                                                            50))
        for form, t in times.items():
            print(f"  the batched K1e at {label}, {form}: "
                  f"{', '.join(f'{x:.4f}' for x in t)} ms")
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



# --- phase 18: the multi-device layer, S shards on one card -----------------

#: Phase 18's shard counts: the x-sharded grid and the member groups (8),
#: the ray mesh (4: 62 antennas pad to 64), the pipeline's mesh (2: no
#: padding, so its runs and the meshless ones solve the same problem).
GRID_SHARDS = 8
RAY_SHARDS = 4
PIPE_SHARDS = 2
#: parent/new pairs of the sharded-grid LSQR timed in turns on the host
#: clock (it is host-bound: its spread is the host's)
LSQR_PAIRS = 10
#: the sharded solves against the unsharded ones: the reference's dry-run
#: parity bound (``__graft_entry__.py``), of max|m|, which holds at its
#: schedule (gn 1, cg 8; a 2-step filter at cg 4) only
SHARDED_SOLVE_LIMIT = 3e-5
#: at the production schedules, each limit set between the sound run's
#: reading and a planted fault's (``planted_fault``; both readings are
#: checked in every run and written down in PERF.md): config 5's filter
#: chunk on the ray mesh, of the unsharded filter's update (the snapshot
#: solve is held to phase 16's INVERT_FIELD_LIMIT and
#: INVERT_HELDOUT_LIMIT); the pipeline on a 2-device mesh, of the meshless
#: run's departure from the prior
SHARDED_FILTER_LIMIT = 1e-3
SHARDED_PIPE_LIMIT = 1e-2
#: the pipeline's other ray-mesh call sites (§6b) on the 4-shard mesh
#: against the meshless pipeline on the same padded rays: each mode's
#: scores (GCV's, the evidence tables over their spread across the
#: candidates, θ̂ and the profile's residual each, the spectrum, the
#: noise-adaptation tables), relative (the fields, the posterior std and
#: the batched fields are held to SHARDED_PIPE_LIMIT, as §6 holds the
#: pipeline's)
SHARDED_SCORE_LIMIT = 1e-2
#: the profile estimate, which §6b holds at cg 3 (past that, f32
#: roundoff, which the shard order changes, decides where its undamped
#: Gauss-Newton goes on this world): θ̂ and the field, relative as above
#: (set from the readings on an NVIDIA H100 80GB HBM3 at 700 W: sound
#: 1.3e-6 and 2.9e-6, the planted faults' 7.5e-2 and 5.2e-4 and past)
SHARDED_DRY_LIMIT = 1e-4
#: the faults planted in the controls: the first shard left out of every
#: ``psum`` (a dropped Jᵀ table, a lost member group, a lost x-shard; the
#: last ray shard may hold only padding, which weighs nothing),
#: and the first two ray shards' values swapped where the per-shard values
#: are gathered in ray order
FAULTS = ("dropped_shard", "swapped_gather")
#: The names of K7 and K7ᵀ's wrappers, and the reference lines they replace.
K7_KERNELS = {
    "cubic_sharded_value": ("cubic_sharded.cu",
                            "ionotomo_tpu/parallel/grid_sharding.py:138"),
    "cubic_sharded_value_grad": ("cubic_sharded.cu",
                                 "ionotomo_tpu/parallel/grid_sharding.py:164"),
    "cubic_sharded_value_bwd": ("cubic_sharded_bwd.cu",
                                "ionotomo_tpu/parallel/grid_sharding.py:138"),
    "cubic_sharded_value_grad_bwd": (
        "cubic_sharded_bwd.cu", "ionotomo_tpu/parallel/grid_sharding.py:164"),
}


def k7_bound(tricubic, grid, pts, owners, grad, ordered=True):
    """K7 over all shards: every shard writes every output (4 B, 16 with
    the gradient) and reads each distinct value its owned points' taps
    touch once; over the shards' orders (the main path's form) each owned
    point (12 B) and its index (4 B) are read once and each shard's mask
    (a bit a point), one-shot every shard reads every point (12 B); an
    evaluation an owned point."""
    n = pts.shape[0]
    s_n = len(owners)
    touched = sum(distinct_taps(tricubic, grid, pts[own]) for own in owners)
    reads = (16 * n + s_n * 4 * -(-n // 32)) if ordered else s_n * 12 * n
    return bound(reads + s_n * (16 if grad else 4) * n + 4 * touched,
                 n * FLOPS_K5_POINT)


def k7t_bound(tricubic, grid, pts, owners, grad):
    """K7ᵀ over all shards: each owned point's position and cotangents read
    once (12 + 4 B, 12 + 16 with the gradient), each distinct cell its taps
    touch read and written once (the plan is not counted); a set-up an
    owned point and 16 pairs' contributions."""
    n_own = sum(int(own.sum()) for own in owners)
    touched = sum(distinct_taps(tricubic, grid, pts[own]) for own in owners)
    return bound((12 + (16 if grad else 4)) * n_own + 8 * touched,
                 n_own * (FLOPS_K5T_POINT + 16 * FLOPS_K5T_PAIR))


def owners_of(gs, sf, grid, pts):
    """Each shard's ownership mask of the points (host side of the
    bound)."""
    from ionotomo_tpu_torch.core import tricubic
    base = tricubic._neighborhood(grid, pts)[0][:, 0, 1]
    return [(base >= sf.x0(s)) & (base < sf.x0(s) + sf.loc)
            for s in range(sf.n_shards)]


def k7_at(label, gs, kernels, tricubic, sf, grid, table, pts, gen,
          reps=10, plain_reps=2, full=True, parent=None):
    """K7 and K7ᵀ at one point set over the shards of ``sf``: the shards'
    K7 (value, and value + gradient) summed in shard order bitwise equal
    to K5 on the whole table, one-shot and over a ``ShardedPoints``'
    orders (the main path's form), each shard within 1e-6·max|table| of
    its plain version; K7ᵀ of both entries into a random slab bitwise its
    plain version and the same twice; device ms summed over the shards
    (and per shard by CUDA events), the one-shot K7's, the plain
    versions', the bound (K7's over the orders, and the one-shot form's
    apart); K7ᵀ beside ``index_add_`` of its owned entries' contributions
    into the slab. ``full``: time the value entries too (else the
    gradient ones only). ``parent``: K7 and K7ᵀ of the parent's package
    (its wrappers and plans on its library) bitwise equal and timed in
    turns. Returns the lines by wrapper name."""
    cuda = pts.is_cuda
    n = pts.shape[0]
    s_n = sf.n_shards
    kept = gs.ShardedPoints(sf.mesh, grid, pts)
    v, g = gs._eval_shards(sf, grid, pts, True)
    vv = gs._eval_shards(sf, grid, pts, False)
    ov, og = kept.eval(sf, True)
    ovv = kept.eval(sf, False)
    owners = owners_of(gs, sf, grid, pts)
    check(bool((sum(o.long() for o in owners) == 1).all()),
          f"{label}: every one of {n} points has exactly one owner")
    if cuda:
        v5, g5 = kernels.cubic_value_grad(table, grid, pts)
        check(all(torch.equal(a, v5) for a in (v, vv, ov, ovv))
              and torch.equal(g, g5) and torch.equal(og, g5),
              f"{label}: K7 (value; value + gradient; one-shot and over "
              f"the shards' orders) summed over {s_n} shards bitwise equal "
              f"to K5 on the whole table")
    del v, g, vv, ov, og, ovv
    orders = kept.orders()
    scale = float(table.abs().max())
    errs = {"cubic_sharded_value": 0.0, "cubic_sharded_value_grad": 0.0}
    for s in range(s_n):
        rv, rg = gs.sharded_value_grad_ref(sf.slab2d(s), grid, sf.x0(s),
                                           sf.loc, pts)
        kv, kg = gs._shard_eval(sf.slab2d(s), grid, sf.x0(s), sf.loc, pts,
                                True, orders[s])
        kvv = gs._shard_eval(sf.slab2d(s), grid, sf.x0(s), sf.loc, pts,
                             False, orders[s])
        errs["cubic_sharded_value"] = max(errs["cubic_sharded_value"],
                                          float((kvv - rv).abs().max()))
        errs["cubic_sharded_value_grad"] = max(
            errs["cubic_sharded_value_grad"], float((kv - rv).abs().max()),
            float((kg - rg).abs().max()) * float(grid.spacing.min()))
        del rv, rg, kv, kg, kvv
    for name, e in errs.items():
        check(e <= 1e-6 * scale, f"{label}: {name} per shard within "
                                 f"1e-6*max|table| of its plain version "
                                 f"({e:.3e})")
    plans = kept.plans()
    n_entries = sum(p.order.shape[0] for p in plans)
    n_tasks = sum(p.n_tasks for p in plans)
    print(f"  {label}: K7ᵀ's {n_entries} entries (by shard "
          f"{[p.order.shape[0] for p in plans]}) in {n_tasks} tasks (lanes "
          f"filled {n_entries / max(32 * n_tasks, 1):.3f}), "
          f"{sum(p.big_cell.shape[0] for p in plans)} cells of more than "
          f"32 entries in {sum(p.n_sub for p in plans)} subtrees, most "
          f"{max(int((p.starts[1:] - p.starts[:-1]).max()) if p.n_cells else 0 for p in plans)} "
          f"entries a cell")
    cv = torch.randn(n, generator=gen, device=pts.device)
    cg = torch.randn((n, 3), generator=gen, device=pts.device)
    slabs = [torch.randn(p.slab_cells, generator=gen, device=pts.device)
             for p in plans]
    for grad, name in ((False, "cubic_sharded_value_bwd"),
                       (True, "cubic_sharded_value_grad_bwd")):
        c = cg if grad else None
        same = True
        for p, base in zip(plans, slabs):
            a = gs._shard_transpose_add_(base.clone(), p, grid, cv, c)
            b = gs._shard_transpose_add_(base.clone(), p, grid, cv, c)
            want = gs.sharded_transpose_ref(base.clone(), p, grid, cv, c)
            same &= bool(torch.equal(a, want) and torch.equal(a, b))
        check(same, f"{label}: {name} into a random slab bitwise its plain "
                    f"version at all {s_n} shards, and twice alike")
    lines = {}
    if not cuda:
        return lines
    pgs = pplans = None
    if parent is not None:
        pgs = importlib.import_module(parent.package().__name__
                                      + ".parallel.grid_sharding")
        pplans = [pgs.sharded_plan(grid, pts, sf.x0(s), sf.loc)
                  for s in range(s_n)]
        same = {}
        for grad in (False, True):
            c = cg if grad else None
            same[grad] = all(
                all(torch.equal(a, b) for a, b in zip(
                    _outputs(gs._shard_eval(sf.slab2d(s), grid, sf.x0(s),
                                            sf.loc, pts, grad, orders[s])),
                    _outputs(pgs._shard_eval(sf.slab2d(s), grid, sf.x0(s),
                                             sf.loc, pts, grad))))
                and torch.equal(
                    gs._shard_transpose_add_(slabs[s].clone(), plans[s],
                                             grid, cv, c),
                    pgs._shard_transpose_add_(slabs[s].clone(), pplans[s],
                                              grid, cv, c))
                for s in range(s_n))
        check(same[False] and same[True],
              f"{label}: K7 and K7ᵀ (value; value + gradient) at all {s_n} "
              f"shards bitwise the parent's")
    cells = [torch.repeat_interleave(p.cells.long(),
                                     (p.starts[1:] - p.starts[:-1]).long())
             for p in plans]
    running = [s.clone() for s in slabs]
    kinds = [("cubic_sharded_value_grad", True, False),
             ("cubic_sharded_value_grad_bwd", True, True)]
    if full:
        kinds = [("cubic_sharded_value", False, False),
                 ("cubic_sharded_value_bwd", False, True)] + kinds
    with card_clocks(f"{label}'s timings"):
        _k7_times(lines, kinds, label, gs, kernels, tricubic, sf, grid, pts,
                  owners, orders, plans, slabs, running, cells, cv, cg, errs,
                  reps, plain_reps, pgs, pplans)
    return lines


def _k7_times(lines, kinds, label, gs, kernels, tricubic, sf, grid, pts,
              owners, orders, plans, slabs, running, cells, cv, cg, errs,
              reps, plain_reps, pgs, pplans):
    """``k7_at``'s timings, into ``lines``."""
    n, s_n = pts.shape[0], sf.n_shards
    for name, grad, bwd in kinds:
        one_shot = parent_one = None
        if not bwd:
            fn = getattr(kernels, name)

            def one(s, fn=fn):
                return fn(sf.slab2d(s), grid, sf.x0(s), sf.loc, pts,
                          orders[s])

            def one_shot(s, fn=fn):
                return fn(sf.slab2d(s), grid, sf.x0(s), sf.loc, pts)

            def plain_one(s, grad=grad):
                ref = (gs.sharded_value_grad_ref if grad
                       else gs.sharded_value_ref)
                return ref(sf.slab2d(s), grid, sf.x0(s), sf.loc, pts)
            if pgs is not None:
                def parent_one(s, grad=grad):
                    return pgs._shard_eval(sf.slab2d(s), grid, sf.x0(s),
                                           sf.loc, pts, grad)
            library = None
            bnd = k7_bound(tricubic, grid, pts, owners, grad)
        else:
            c = cg if grad else None

            def one(s, c=c):
                return gs._shard_transpose_add_(running[s], plans[s], grid,
                                                cv, c)

            def plain_one(s, c=c):
                return gs.sharded_transpose_ref(running[s].clone(), plans[s],
                                                grid, cv, c)
            if pgs is not None:
                def parent_one(s, c=c):
                    return pgs._shard_transpose_add_(running[s], pplans[s],
                                                     grid, cv, c)
            terms = [gs._entry_terms(p, grid, cv, c) for p in plans]
            bufs = [torch.zeros(p.slab_cells, device=pts.device)
                    for p in plans]

            def library(terms=terms, bufs=bufs):
                for b, f, t in zip(bufs, cells, terms):
                    b.index_add_(0, f, t)
            bnd = k7t_bound(tricubic, grid, pts, owners, grad)

        def call(one=one):
            return [one(s) for s in range(s_n)]
        ms = device_ms(call, reps)
        per_shard = [cuda_ms(lambda s=s: one(s), reps) for s in range(s_n)]
        plain_ms = device_ms(lambda: [plain_one(s) for s in range(s_n)],
                             plain_reps)
        lib_ms = device_ms(library, reps) if library is not None else None
        b_ms, b_by = bnd
        print(f"  {label}: {name} over {s_n} shards {ms:.4f} ms (per shard, "
              f"CUDA events: " + ", ".join(f"{x:.4f}" for x in per_shard)
              + f"), plain {plain_ms:.4f} ms, "
              + (f"index_add_ {lib_ms:.4f} ms, " if lib_ms is not None
                 else "")
              + f"bound {b_ms:.4f} ms ({b_by})")
        lines[name] = dict(max_abs_err=errs.get(name, 0.0), ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, ms_per_shard=per_shard,
                           points=n, shards=s_n)
        if one_shot is not None:
            lines[name]["one_shot_ms"] = device_ms(
                lambda: [one_shot(s) for s in range(s_n)], reps)
            lines[name]["one_shot_bound_ms"] = k7_bound(
                tricubic, grid, pts, owners, grad, ordered=False)[0]
            print(f"  {label}: {name} one-shot (the points' order) "
                  f"{lines[name]['one_shot_ms']:.4f} ms, bound "
                  f"{lines[name]['one_shot_bound_ms']:.4f} ms")
        base = slabs if bwd else None

        def fresh(fn):
            """Every shard's output of fn, flat; a transpose into a copy
            of its random slab."""
            outs = [fn(s) if base is None else fn_into(fn, s)
                    for s in range(s_n)]
            return [t for o in outs for t in _outputs(o)]

        def fn_into(fn, s):
            saved = running[s]
            running[s] = base[s].clone()
            try:
                return fn(s)
            finally:
                running[s] = saved
        if parent_one is not None:
            p_ms, n_ms = compare_parent(
                f"{label}: {name} over {s_n} shards",
                lambda: fresh(parent_one), lambda: fresh(one), reps,
                new_timed=call,
                parent_timed=lambda: [parent_one(s) for s in range(s_n)])
            lines[name]["parent_ms"], lines[name]["new_ms_in_turns"] = (
                p_ms, n_ms)
    return lines


def with_attr(module, attr, value, fn):
    """fn() with module.attr set to value."""
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        return fn()
    finally:
        setattr(module, attr, saved)


#: ``--k7-study``'s sweep: uniform random points over the 8 shards of a
#: 256³ field, from 8 to 1,024 points a shard an SM of an H100 (132)
K7_STUDY_POINTS = tuple(8 * 132 * k for k in (8, 16, 32, 64, 128, 256, 512,
                                              1024))
#: the thresholds set to force a path: K7's four lanes or one, K7ᵀ's one
#: task a warp or two
FORCE_FOUR, FORCE_ONE = 1 << 30, -1
FORCE_SINGLE, FORCE_PAIR = 1 << 30, 0
#: the thresholds (K7_QUAD_POINTS_PER_SM, K7T_PAIR_TASKS_PER_SM) before
#: the sweep placed them, held against the module's at config 4's shapes
K7_RULES_BEFORE = (64, 256)


def k7_rules_in_turns(label, sf, grid, pts, gen, quad, pair, reps=10):
    """At points over the shards of ``sf``: K7's value over the shards'
    orders built with ``kernels.K7_QUAD_POINTS_PER_SM`` at quad[0] against
    quad[1], and K7ᵀ (value; value + gradient) over plans built with
    ``K7T_PAIR_TASKS_PER_SM`` at pair[0] against pair[1]; each pair
    bitwise equal and timed in turns (device ms summed over the shards,
    the first setting in the parent's place). Returns the readings and
    each shard's owned points and tasks an SM."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.parallel import grid_sharding as gs

    dev = pts.device
    n = pts.shape[0]
    shards = range(sf.n_shards)
    sms = kernels.sm_count(dev)
    cv = torch.randn(n, generator=gen, device=dev)
    cg = torch.randn((n, 3), generator=gen, device=dev)

    def orders(quad):
        return with_attr(kernels, "K7_QUAD_POINTS_PER_SM", quad, lambda: [
            gs.shard_order(grid, pts, sf.x0(s), sf.loc) for s in shards])

    def k7(orders):
        return lambda: [kernels.cubic_sharded_value(
            sf.slab2d(s), grid, sf.x0(s), sf.loc, pts, orders[s])
            for s in shards]

    def plans(pair):
        return with_attr(kernels, "K7T_PAIR_TASKS_PER_SM", pair, lambda: [
            gs.sharded_plan(grid, pts, sf.x0(s), sf.loc) for s in shards])

    def k7t(plans, c, into=None):
        return [gs._shard_transpose_add_(
            torch.zeros(p.slab_cells, device=dev) if into is None
            else into[s], p, grid, cv, c) for s, p in enumerate(plans)]

    a, b = orders(quad[0]), orders(quad[1])
    row = {"owned_per_sm": [o.index.shape[0] / sms for o in a],
           "lanes": [[o.lanes for o in a], [o.lanes for o in b]]}
    row["k7_value_ms"] = compare_parent(
        f"{label}: K7 value, lanes {row['lanes'][0]} (as parent) against "
        f"{row['lanes'][1]}", k7(a), k7(b), reps)
    del a, b
    a, b = plans(pair[0]), plans(pair[1])
    row["tasks_per_sm"] = [p.n_tasks / sms for p in a]
    row["tasks_per_warp"] = [[p.tasks_per_warp for p in a],
                             [p.tasks_per_warp for p in b]]
    running = [torch.zeros(p.slab_cells, device=dev) for p in a]
    for c, key in ((None, "k7t_value_ms"), (cg, "k7t_value_grad_ms")):
        row[key] = compare_parent(
            f"{label}: K7ᵀ {key[4:-3]}, tasks a warp "
            f"{row['tasks_per_warp'][0]} (as parent) against "
            f"{row['tasks_per_warp'][1]}",
            lambda c=c: k7t(a, c), lambda c=c: k7t(b, c), reps,
            new_timed=lambda c=c: k7t(b, c, running),
            parent_timed=lambda c=c: k7t(a, c, running))
    print(f"  {label}: owned points a shard an SM "
          + ", ".join(f"{x:.0f}" for x in row["owned_per_sm"])
          + "; tasks a shard an SM "
          + ", ".join(f"{x:.0f}" for x in row["tasks_per_sm"]))
    return row


def k7_study(dev, rules=None):
    """``--k7-study``: where K7's lanes a point and K7ᵀ's tasks a warp
    cross over, by ``k7_rules_in_turns``: over the 8 shards of a random
    256³ field at uniform random points of each size in
    ``K7_STUDY_POINTS``, four lanes against one and one task a warp
    against two; then at config 4's bundle points and endpoints over its
    8 shards, the thresholds ``rules`` ((K7_QUAD_POINTS_PER_SM,
    K7T_PAIR_TASKS_PER_SM), another setting) against the module's.
    Returns the readings by point set."""
    from ionotomo_tpu_torch import configs, kernels
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.parallel import grid_sharding as gs

    shape = (256, 256, 256)
    grid = Grid3D.from_bounds((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0),
                              shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    mesh = gs.grid_mesh([dev] * GRID_SHARDS)
    sf = gs.shard_field(mesh, torch.randn(shape, generator=gen, device=dev))
    out = {}
    for n in K7_STUDY_POINTS:
        pts = grid.origin + (grid.upper() - grid.origin) * torch.rand(
            (n, 3), generator=gen, device=dev)
        out[n] = k7_rules_in_turns(
            f"K7 study, {n} uniform points", sf, grid, pts, gen,
            (FORCE_FOUR, FORCE_ONE), (FORCE_SINGLE, FORCE_PAIR))
    del sf
    if rules is not None:
        w4 = configs.config4_world(shape=shape, device=dev)
        sf4 = gs.shard_field(mesh, w4.m_prior)
        ends, _ = tec._endpoint_tangents(w4.rays.points)
        now = (kernels.K7_QUAD_POINTS_PER_SM, kernels.K7T_PAIR_TASKS_PER_SM)
        for key, pts in (("config4_points", w4.rays.points.reshape(-1, 3)),
                         ("config4_ends", ends)):
            out[key] = k7_rules_in_turns(
                f"K7 study, config 4's {pts.shape[0]} {key[8:]}, the "
                f"thresholds {rules} against {now}", sf4, w4.grid, pts, gen,
                (rules[0], now[0]), (rules[1], now[1]))
    return out


def profile_by_kernel(label, fn, top=12):
    """One call of fn under torch.profiler, after the caller's warm-up:
    its device time by kernel ({name: [launches, us]}, the total under
    "all"), the largest printed, and its host time by op printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {e.key: [e.count, e.self_device_time_total]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}
    total = sum(us for _, us in rows.values())
    print(f"  profiled {label}: {total:.1f} us of device time in "
          f"{sum(n for n, _ in rows.values())} launches")
    for key, (count, us) in sorted(rows.items(), key=lambda r: -r[1][1])[
            :top]:
        print(f"    {us:10.1f} us {count:5d}x  {key[:100]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    print(f"  its host time by op (profiler on, "
          f"{sum(r[1] for r in host):.1f} us in all):")
    for key, us, count in host[:8]:
        print(f"    {us:10.1f} us {count:5d}x  {key[:100]}")
    rows["all"] = [sum(n for n, _ in rows.values()), total]
    return rows


@contextlib.contextmanager
def planted_fault(kind):
    """A control: the multi-device layer with one fault planted (one of
    ``FAULTS``), so that a comparison's limit can be shown to fail a wrong
    shard."""
    from ionotomo_tpu_torch.parallel import grid_sharding as gs
    from ionotomo_tpu_torch.parallel import sharding as sm

    saved = {(sm, "psum"): sm.psum, (gs, "psum"): gs.psum,
             (sm, "_cat_rays"): sm._cat_rays}
    if kind == "dropped_shard":
        def psum(tensors, device=None, orig=sm.psum):
            tensors = list(tensors)
            return orig(tensors[1:] or tensors, device)
        sm.psum = gs.psum = psum
    elif kind == "swapped_gather":
        def cat(xs, device, orig=sm._cat_rays):
            xs = list(xs)
            xs[0], xs[1] = xs[1], xs[0]
            return orig(xs, device)
        sm._cat_rays = cat
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def control(out, label, sound, limit, reading, kinds=FAULTS):
    """The two readings of one limit: the sound run's (``sound``, checked
    by the caller) and, for each planted fault, ``reading()`` under it,
    which must exceed the limit. Records both in ``out["controls"]``."""
    faults = {}
    for kind in kinds:
        with planted_fault(kind):
            try:
                faults[kind] = float(reading())
            except Exception as exc:    # a fault may also break the solve
                print(f"  {label} under {kind}: {type(exc).__name__}: {exc}")
                faults[kind] = float("inf")
    # a NaN fails the limit as it fails the sound run's check
    check(sound <= limit and not any(v <= limit for v in faults.values()),
          f"{label}: the limit {limit:g} lies between the sound run's "
          f"reading {sound:.3e} and the planted faults' ("
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items()) + ")")
    out.setdefault("controls", {})[label] = dict(sound=sound, limit=limit,
                                                 faults=faults)


def sharded_reading(got, want, prior, heldout):
    """A sharded solve against the unsharded one as phase 16 holds the
    card to the CPU: the relative L2 of the difference over the unsharded
    update, and (with ``heldout``, a field's held-out dTEC rms) the
    relative difference of the held-out rms."""
    from ionotomo_tpu_torch.device import host

    g, w, p = host(got), host(want), host(prior)
    rel = float(np.linalg.norm((g - w).astype(np.float64))
                / np.linalg.norm((w - p).astype(np.float64)))
    if heldout is None:
        return rel, 0.0
    hg, hw = heldout(got), heldout(want)
    return rel, abs(hg - hw) / hw if hw else 0.0


@contextlib.contextmanager
def recorded_calls(entries):
    """Each solver entry (module, name) wrapped to record its calls: the
    yielded list gets (name, the bundle handed in, args, kwargs, result)
    of every call, in order; ``replay(call)`` calls the original entry
    again with the recorded arguments."""
    calls, saved = [], []
    for mod, name in entries:
        fn = getattr(mod, name)

        def wrapped(grid, rays, *args, _fn=fn, _name=name, **kwargs):
            res = _fn(grid, rays, *args, **kwargs)
            calls.append((_name, rays, (grid,) + args, kwargs, res))
            return res
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def replay(entries, call, **changes):
    """The original of ``call``'s entry on its recorded arguments, with
    ``changes`` to its keyword arguments."""
    fn = {name: getattr(mod, name) for mod, name in entries}[call[0]]
    grid, *args = call[2]
    return fn(grid, call[1], *args, **{**call[3], **changes})


#: where each kernel of a ray-sharded operator's path takes its point
#: count: the index of the wrapper's argument whose axis 0 counts points
#: (K2, K2b: ri; K3, K3b: wxy; K5, K5ᵀ: the points)
SHARD_KERNELS = {"rows_value_fwd": 1, "rows_value_bwd": 2,
                 "cubic_value_grad": 2, "cubic_value_grad_bwd": 2,
                 "rows_value_fwd_batched": 1, "rows_value_bwd_batched": 2}


@contextlib.contextmanager
def launch_sizes(kernels):
    """Each wrapper of ``SHARD_KERNELS`` wrapped to count its launches by
    the point count of the call: yields {name: {points: launches}}."""
    sizes = {k: {} for k in SHARD_KERNELS}
    saved = {k: getattr(kernels, k) for k in SHARD_KERNELS}
    for k, i in SHARD_KERNELS.items():
        def wrapped(*args, _fn=saved[k], _k=k, _i=i, **kwargs):
            n = int(args[_i].shape[0])
            sizes[_k][n] = sizes[_k].get(n, 0) + 1
            return _fn(*args, **kwargs)
        setattr(kernels, k, wrapped)
    try:
        yield sizes
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)


def rel_max(got, want) -> float:
    """max|got − want| / max|want| (numpy or tensors)."""
    from ionotomo_tpu_torch.device import host
    g = np.asarray(host(got) if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(host(want) if torch.is_tensor(want) else want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def rel_each(got, want) -> float:
    """max over elements of |got − want| / |want|."""
    g, w = (np.asarray(x, np.float64).ravel() for x in (got, want))
    return float(np.max(np.abs(g - w) / np.abs(w)))


def rel_spread(got, want) -> float:
    """max|got − want| over the spread of ``want`` (max − min): a
    log-evidence table's differences against those that pick its
    winner."""
    g, w = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.abs(g - w).max() / (w.max() - w.min()))


def field_reading(got, want, prior) -> float:
    """max|got − want| over want's largest departure from the prior, as
    §6 holds the pipeline's fields."""
    from ionotomo_tpu_torch.device import host
    g, w, p = (np.asarray(host(x) if torch.is_tensor(x) else x)
               for x in (got, want, prior))
    return float(np.abs(g - w).max() / np.abs(w - p).max())


def profile_theta(res):
    """θ̂ of a ``ProfileResult`` as a flat array, then its residual."""
    from ionotomo_tpu_torch.device import host
    t = res.theta
    flat = ([t.log_n_peak, t.h_peak_km, t.scale_km]
            if hasattr(t, "log_n_peak") else list(t))
    return np.array([float(x) for x in flat] + [float(res.residual_norm)])


def evidence_table(fit):
    """The log-evidence table of a ``fit_hyperparameters`` result."""
    return fit[3] if len(fit) == 5 else fit[2]


def padded_pipeline(shards):
    """``InversionPipeline`` without a mesh whose antennas are padded to
    a multiple of ``shards``, as a run on a mesh of ``shards`` pads them,
    so that both solve the same problem (GCV's row count and the
    evidence's noise determinant count the padded rows)."""
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
    from ionotomo_tpu_torch.parallel.sharding import pad_to_multiple

    class Padded(InversionPipeline):
        def _padded_na(self, na: int) -> int:
            return pad_to_multiple(na, shards)
    return Padded


def pipeline_mesh_modes(dev, kernels, dp, truth, mesh, small, clock, out,
                        depth_study=False):
    """§6b of phase 18: the pipeline's call sites beyond the snapshot
    solve and the filters' chunks on the ray mesh (``mesh``, 62 antennas
    padded to 64), each mode run by the invert CLI's arguments at full
    width, against the meshless pipeline on the same padded rays. Every
    call of the mode's solver entries is recorded (``recorded_calls``):
    the meshed run's must take a ``ShardedRayBundle``; its scores and
    fields are held to the meshless run's; each limit's control replays
    the meshed run's first recorded call under each planted fault. The
    launches of K2, K3, K5, K5ᵀ (and K2b, K3b with a member axis) are
    counted by their calls' point counts: a shard's, a multiple of the
    shard count, and never the whole bundle's."""
    from ionotomo_tpu_torch.inversion import (empirical_bayes, kalman,
                                              model_selection, profile,
                                              solvers)
    from ionotomo_tpu_torch.inversion import pipeline as pipeline_mod
    from ionotomo_tpu_torch.parallel import sharding as sm

    cuda = dev.type == "cuda"
    shards = mesh.size
    Padded = padded_pipeline(shards)
    snapshot = (solvers, "map_gauss_newton")
    dry = (SHARDED_DRY_LIMIT, SHARDED_DRY_LIMIT)
    held = (SHARDED_SCORE_LIMIT, SHARDED_PIPE_LIMIT)
    # name: (CLI arguments, timesteps, the score's entry, the field's
    # entry, member axis, slant anchors, the score's and the field's
    # limits). The profile estimate runs at cg 3, the depth of its CPU
    # parity tests: its undamped Gauss-Newton diverges on this world at
    # cg 10 and 20 (PERF.md §7), and at cg 40 data moved by 1e-7 part θ̂
    # as far as the shard order does (1e-2 to 1e-1). GCV runs at the
    # reference dry run's cg 8: at cg 40 moved data move its scores as far
    # as the shard order does (~8e-2). Both readings: ``--sharded
    # --depth-study`` (``depth_finding``). A CPU rehearsal (``small``) runs
    # every mode at cg 3, the parity tests' depth: its 32 data rows put
    # GCV's tr S near n, where even cg 8 parts the scores by 5 %.
    modes = {
        "estimate_profile": (("--estimate-profile", "--cg-iters", "3"), 1,
                             (profile, "map_gauss_newton_profile"), snapshot,
                             False, True, dry),
        "auto_prior_gcv": (("--auto-prior", "gcv", "--cg-iters", "8"), 1,
                           (model_selection, "select_prior"), snapshot,
                           True, False, held),
        "auto_prior_evidence": (("--auto-prior", "evidence"), 1,
                                (empirical_bayes, "fit_hyperparameters"),
                                snapshot, True, False, held),
        "posterior_samples": (("--posterior-samples", "8"), 1,
                              (solvers, "posterior_samples"), snapshot, True,
                              False, (SHARDED_PIPE_LIMIT,) * 2),
        "kalman_events": (("--solver", "kalman", "--kalman-chunk", "1",
                           "--noise-adapt", "1", "--diag-spectrum", "1"), 2,
                          (empirical_bayes, "log_marginal_family"),
                          (pipeline_mod, "kalman_filter"), True, False, held),
        "batched_gn": (("--solver", "batched_gn"), 2,
                       (solvers, "map_gauss_newton_batched"), None, False,
                       False, held),
    }
    spectrum = (kalman, "update_operator_eigs")
    res_out = {}
    for name, (argv, nt, score_at, field_at, members, anchored,
               (score_limit, field_limit)) in modes.items():
        t0 = time.perf_counter()
        sub = dp.select(times=list(range(nt)))
        sub.wind_kmps = dp.wind_kmps
        entries = [score_at] + ([field_at] if field_at else []) + (
            [spectrum] if name == "kalman_events" else [])

        def run(cls, tag, mesh_arg, sizes=None):
            c = invert_config(f"mesh_{name}_{tag}", *argv, *(
                ("--cg-iters", "3") if small else ()),
                shape=(16,) * 3 if small else None)
            with recorded_calls(entries) as calls:
                def go():
                    p = cls(sub, c, device=dev, mesh=mesh_arg)
                    a = (slant_truth_anchors(dev, p, truth) if anchored
                         else None)
                    return p, p.run(resume=False, anchors=a)
                (p, sol), secs = clock(go)
            return p, sol, calls, secs

        p_u, sol_u, calls_u, s_u = run(Padded, "none", None)
        before = dict(kernels.launches)
        with launch_sizes(kernels) as sizes:
            p_m, sol_m, calls_m, s_m = run(
                pipeline_mod.InversionPipeline, "mesh", mesh)
        counted = {k: kernels.launches[k] - before[k] for k in sizes}
        prior = p_u._m_prior0
        # every call on the mesh took a sharded bundle
        sharded = all(isinstance(c[1], sm.ShardedRayBundle)
                      and len(c[1].shards) == shards for c in calls_m)
        check(sharded and [c[0] for c in calls_m] == [c[0] for c in calls_u]
              and calls_m,
              f"{name}: each of its {len(calls_m)} solver calls on the mesh "
              f"took a ShardedRayBundle of {shards} shards ("
              + ", ".join(sorted({c[0] for c in calls_m})) + ")")
        # a shard's rays and samples (the batched mode's bundle is (Nt,
        # R, N, 3)); K5 and K5ᵀ run at the rays' two endpoints
        r_s, n_s = calls_m[0][1].shards[0].points.shape[-3:-1]
        launched = {}
        if cuda:
            want = ["rows_value_fwd", "rows_value_bwd", "cubic_value_grad",
                    "cubic_value_grad_bwd"] + (
                ["rows_value_fwd_batched", "rows_value_bwd_batched"]
                if members else [])
            for k in want:
                at = sizes[k]
                per = 2 * r_s if k.startswith("cubic") else r_s * n_s
                n, whole = at.get(per, 0), at.get(per * shards, 0)
                launched[k] = dict(shard=n, whole=whole, counter=counted[k])
                check(n > 0 and n % shards == 0 and whole == 0
                      and sum(at.values()) == counted[k],
                      f"{name}: {k} launched {n} times at a shard's points "
                      f"(a multiple of {shards}) and never at the whole "
                      f"bundle's ({dict(sorted(at.items()))}; its counter "
                      f"{counted[k]})")
        # the readings and their controls
        readings = {}

        def hold(label, sound, limit, reading):
            readings[label] = sound
            check(sound <= limit, f"{name}: {label} {sound:.3e} within "
                                  f"{limit:g} of the meshless pipeline")
            control(out, f"mesh_{name}_{label}", sound, limit, reading)

        first_m = [c for c in calls_m if c[0] == score_at[1]]
        first_u = [c for c in calls_u if c[0] == score_at[1]]
        if name == "estimate_profile":
            hold("theta", rel_each(profile_theta(first_m[0][4]),
                                   profile_theta(first_u[0][4])),
                 score_limit,
                 lambda: rel_each(profile_theta(replay(entries, first_m[0])),
                                  profile_theta(first_u[0][4])))
        elif name == "auto_prior_gcv":
            (_, params, sc_m), (_, params_u, sc_u) = (first_m[0][4],
                                                      first_u[0][4])
            check(params == params_u and int(np.argmin(sc_m))
                  == int(np.argmin(sc_u)),
                  f"{name}: the same candidate chosen ({params})")
            grid, d0, noise0, m0, cands = first_m[0][2]
            hold("scores", rel_max(sc_m, sc_u), score_limit,
                 lambda: rel_max(model_selection.select_prior(
                     grid, first_m[0][1], d0, noise0, m0, cands[:2],
                     **first_m[0][3])[2], sc_u[:2]))
        elif name == "auto_prior_evidence":
            for fm, fu in zip(first_m, first_u):
                check(fm[4][:2] == fu[4][:2], f"{name}: the kind "
                      f"{fm[3]['kind']} picks the same (σ*, L*) "
                      f"{fm[4][:2]}")
            ev_m, ev_u = (next(r for r in p.metrics.read_all()
                               if r.get("event") == "prior_auto_selected")
                          for p in (p_m, p_u))
            check(ev_m["chosen"] == ev_u["chosen"],
                  f"{name}: the same candidate chosen ({ev_m['chosen']})")
            hold("tables", max(rel_spread(evidence_table(fm[4]),
                                          evidence_table(fu[4]))
                               for fm, fu in zip(first_m, first_u)),
                 score_limit,
                 lambda: rel_spread(evidence_table(replay(
                     entries, first_m[0],
                     length_scales=first_m[0][3]["length_scales"][:1])),
                     evidence_table(first_u[0][4])[:1]))
        elif name == "posterior_samples":
            hold("std", rel_max(first_m[0][4][2], first_u[0][4][2]),
                 score_limit,
                 lambda: rel_max(replay(entries, first_m[0])[2],
                                 first_u[0][4][2]))
        elif name == "kalman_events":
            rho_m, rho_u = ([r["rho"] for r in p.metrics.read_all()
                             if r.get("event") == "noise_adapted"]
                            for p in (p_m, p_u))
            check(rho_m == rho_u and rho_m,
                  f"{name}: the same noise-scale corrections {rho_m}")
            hold("noise_tables", max(rel_spread(fm[4][0], fu[4][0])
                                     for fm, fu in zip(first_m, first_u)),
                 score_limit,
                 lambda: rel_spread(replay(entries, first_m[0])[0],
                                    first_u[0][4][0]))
            eig_m = [c for c in calls_m if c[0] == spectrum[1]]
            eig_u = [c for c in calls_u if c[0] == spectrum[1]]
            check(len(eig_m) == len(eig_u) == nt,
                  f"{name}: a spectrum event a chunk ({len(eig_m)})")
            hold("spectrum", max(rel_max(em[4][1], eu[4][1])
                                 for em, eu in zip(eig_m, eig_u)),
                 score_limit,
                 lambda: rel_max(replay(entries, eig_m[0])[1], eig_u[0][4][1]))
        # the fields: the mode's solution, its field entry's first call
        field_m = first_m if field_at is None else [
            c for c in calls_m if c[0] == field_at[1]]
        field_u = first_u if field_at is None else [
            c for c in calls_u if c[0] == field_at[1]]

        def field_of(res):
            return res.m_seq if hasattr(res, "m_seq") else res.m
        hold("field", field_reading(sol_m.m, sol_u.m, prior)
             if np.isfinite(sol_m.m).all() else float("inf"),
             field_limit,
             lambda: field_reading(field_of(replay(entries, field_m[0])),
                                   field_of(field_u[0][4]), prior))
        secs = time.perf_counter() - t0
        res_out[name] = dict(readings=readings, seconds=secs,
                             seconds_mesh=s_m, seconds_none=s_u,
                             launches=launched, calls=len(calls_m))
        print(f"  {name} on {shards} ray shards: " + ", ".join(
            f"{k} {v:.3e}" for k, v in readings.items())
            + f"; the meshed run {s_m:.2f} s, the meshless {s_u:.2f} s "
            f"(host clock); [{name}: {secs:.1f} s]")
        if depth_study and name in DEPTH_STUDY:
            res_out[f"{name}_depth"] = depth_finding(
                name, entries, first_m[0], first_u[0], clock)
        del p_u, p_m, calls_u, calls_m
        torch.cuda.empty_cache() if cuda else None
    return res_out


#: ``--depth-study``'s modes: (the CG depths, the one §6b holds the mode
#: at first, then deeper to the invert CLI's 40; the reading that parts
#: a result from the meshless one; the candidate a result picks)
DEPTH_STUDY = {
    "estimate_profile": ((3, 5, 10, 20, 40),
                         lambda a, b: rel_each(profile_theta(a),
                                               profile_theta(b)), None),
    "auto_prior_gcv": ((8, 40), lambda a, b: rel_max(a[2], b[2]),
                       lambda r: int(np.argmin(r[2]))),
}
#: ``depth_finding``'s draws of moved data
DEPTH_DRAWS = 5


def depth_finding(name, entries, call_m, call_u, clock):
    """``--depth-study`` (printed, not held): why §6b holds ``name`` at a
    reduced CG depth. At each of its ``DEPTH_STUDY`` depths the meshed
    run's first call of the mode's entry and the meshless run's are
    replayed, and the meshless one again on data moved by 1e-7 relative
    (a few f32 ulps; ``DEPTH_DRAWS`` draws, seeds 23, 24, ...), each
    result read against the meshless one by the mode's reading. Where
    the moved data part the results as far as the mesh does, the
    truncated f32 CG's roundoff decides them at that depth, and neither
    reading is a fault."""
    depths, reading, pick = DEPTH_STUDY[name]
    fn = {n: getattr(mod, n) for mod, n in entries}[call_u[0]]
    grid, d0, *rest = call_u[2]
    moved = []
    for seed in range(23, 23 + DEPTH_DRAWS):
        g = torch.Generator(device=d0.device).manual_seed(seed)
        moved.append(d0 * (1.0 + 1e-7 * torch.randn(
            d0.shape, generator=g, device=d0.device)))
    rows = []
    for cg in depths:
        r_m, s_m = clock(lambda: replay(entries, call_m, cg_iters=cg))
        r_u, s_u = clock(lambda: replay(entries, call_u, cg_iters=cg))
        r_p = [fn(grid, call_u[1], d, *rest,
                  **{**call_u[3], "cg_iters": cg}) for d in moved]
        row = dict(cg=cg, mesh=reading(r_m, r_u),
                   moved=[reading(r, r_u) for r in r_p],
                   seconds_mesh=s_m, seconds_none=s_u)
        if pick is not None:
            row["picks"] = [pick(r) for r in [r_u, r_m] + r_p]
        rows.append(row)
        print(f"  {name} at cg {cg} (a finding, not held): the mesh "
              f"{row['mesh']:.3e} from the meshless result, data moved by "
              f"1e-7 relative (each draw) "
              + ", ".join(f"{x:.3e}" for x in row["moved"])
              + (f"; candidates picked (meshless, mesh, moved) "
                 f"{row['picks']}" if pick else "")
              + f"; {s_m:.2f} s on the mesh, {s_u:.2f} s without (host "
              f"clock)")
    return rows


def phase18_sharded(dev, kernels, results, small=False, profile=False,
                    parent=None, depth_study=False):
    """The multi-device layer (``parallel/``) at full width with its S
    shards in turn on one card (an arithmetic check, not a multi-card
    speed; ``small``: a CPU rehearsal at toy sizes, the kernels' checks
    left out; ``parent``: K7, K7ᵀ and the LSQR held bitwise to the
    parent's package and timed in turns with it; ``profile``: the LSQR's
    device time by kernel, the parent's beside it; ``depth_study``: §6b's
    ``depth_finding`` after the profile estimate and GCV):

    1. K7 and K7ᵀ at config 4's 256³ world over 8 shards (its 650,000
       bundle points, its 20,000 endpoints), at 917,504 edge-case points
       (shard seams, the x edges, outside) and at 2²⁰ random points of a
       512³ field: K7 summed over the shards bitwise K5, K7ᵀ bitwise its
       plain version, the halo exchange exact against slices of the field;
       times per shard and summed, the bound, the plain versions',
       ``index_add_``'s; the exchange's and ``psum``'s times;
    2. the Hermite dTEC J and Jᵀ on the x-sharded grid
       (``ShardedGridDtecLinear``) at config 4's bundle against the
       unsharded ``PairedDtecLinear``, then 20 LSQR iterations of the
       absolute Hermite TEC on each (the main path of K7 and K7ᵀ, its
       launches counted);
    3. ``trace_rays_sharded`` (cubic leapfrog) bitwise against the plain
       integrator over K5 and against K1c: config 2's 6,200 rays @128,
       262,144 rays @64, and 6,200 rays on a 2 × 4 grid × ray mesh;
    4. the ray mesh (4 shards, 62 antennas padded to 64): phase 16's
       snapshot solve and config 5's first chunk through the
       mixed-fidelity wind-adaptive filter, each against the unsharded
       one on the same padded rays (within 3e-5 of max|m| at the
       reference dry run's schedule; at the production schedule as phase
       16 holds the card to the CPU) and bitwise across two calls;
    5. ``member_parallel_enkf`` on config 5's ensemble (8 members, 6
       epochs) over 2 and 8 groups against the unsharded filter;
    6. ``InversionPipeline`` with ``mesh=`` in the kalman and the
       member-parallel enkf modes against the pipeline without one; then
       (``pipeline_mesh_modes``) on §4's 4-shard mesh at full width the
       profile estimate, GCV and evidence prior selection, posterior
       draws, the Kalman filter's noise-adaptation and spectrum events
       and the batched mode, each against the meshless pipeline on the
       same padded rays, its kernels counted at a shard's points."""
    from ionotomo_tpu_torch import configs
    from ionotomo_tpu_torch.core import linalg, tricubic
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import fermat, rays
    from ionotomo_tpu_torch.device import host
    from ionotomo_tpu_torch.inversion import kalman, solvers
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
    from ionotomo_tpu_torch.models import chapman
    from ionotomo_tpu_torch.parallel import grid_sharding as gs
    from ionotomo_tpu_torch.parallel import sharding as sm
    from ionotomo_tpu_torch.testing import edge_case_points

    cuda = dev.type == "cuda"
    card = card_line() if cuda else "cpu"

    def clock(fn):
        """(fn(), host seconds) on the card; (fn(), 0.0) in a rehearsal."""
        return timed(fn) if cuda else (fn(), 0.0)

    print(f"phase 18: the multi-device layer, shards in turn on one device "
          f"({card}; arithmetic, not a multi-card speed)")
    out = {"card": card, "at": {}}
    gen = torch.Generator(device=dev).manual_seed(18)
    mesh8 = gs.grid_mesh([dev] * GRID_SHARDS)
    t0 = time.perf_counter()

    # 1. K7 and K7ᵀ at their shapes
    shape4 = (32, 32, 32) if small else (256, 256, 256)
    w4 = configs.config4_world(
        shape=shape4, device=dev,
        **(dict(n_ants=10, n_dirs=10, n_modes=16, trace_steps=32)
           if small else {}))
    grid4 = w4.grid
    print(f"  config 4's world {shape4}: {w4.rays.num_rays} rays x "
          f"{w4.rays.num_samples} samples ({time.perf_counter() - t0:.2f} s)")
    sf4 = gs.shard_field(mesh8, w4.m_prior)
    loc = sf4.loc
    ring = torch.cat([w4.m_prior[-2:], w4.m_prior, w4.m_prior[:2]])
    check(all(torch.equal(sf4.ext[s], ring[s * loc:s * loc + loc + 4])
              for s in range(GRID_SHARDS)),
          f"halo exchange over {GRID_SHARDS} shards (loc {loc}) exact "
          f"against slices of the field, the ring wrapped at the edges")
    table4 = w4.m_prior.reshape(-1, shape4[2])
    pts4 = w4.rays.points.reshape(-1, 3)
    ends4, _ = tec._endpoint_tangents(w4.rays.points)
    if cuda:
        out["halo_exchange_ms"] = cuda_ms(lambda: gs._exchange_halos(sf4),
                                          20)
        outs = [gs._shard_eval(sf4.slab2d(s), grid4, sf4.x0(s), loc, pts4,
                               True) for s in range(GRID_SHARDS)]
        out["psum_ms"] = cuda_ms(lambda: (sm.psum([o[0] for o in outs]),
                                          sm.psum([o[1] for o in outs])), 20)
        print(f"  halo exchange {out['halo_exchange_ms']:.4f} ms, psum of the "
              f"8 shards' K7 outputs at {pts4.shape[0]} points "
              f"{out['psum_ms']:.4f} ms (CUDA events)")
        del outs
    k7_kw = dict(parent=parent)
    out["at"]["config4_points"] = k7_at(
        f"config 4's {pts4.shape[0]} bundle points", gs, kernels, tricubic,
        sf4, grid4, table4, pts4, gen, **k7_kw)
    out["at"]["config4_ends"] = k7_at(
        f"config 4's {ends4.shape[0]} endpoints", gs, kernels, tricubic, sf4,
        grid4, table4, ends4, gen, **k7_kw)
    rng = np.random.default_rng(18)
    o4, s4 = grid4.origin.cpu().numpy(), grid4.spacing.cpu().numpy()
    edge = edge_case_points(shape4, o4, s4, 4096 if small else 1 << 20,
                            rng)                          # 917,504 points
    # the first of its uniform points moved onto every x-plane (every
    # shard seam among them) and beyond both x edges
    xs = np.concatenate([np.repeat(o4[0] + s4[0] * np.arange(shape4[0]), 2),
                         [o4[0] - 100.0, o4[0] + s4[0] * shape4[0] + 100.0]])
    edge[:xs.shape[0], 0] = xs
    edge = torch.from_numpy(edge).to(dev)
    n_edge = edge.shape[0]
    out["at"]["edge"] = k7_at(f"{n_edge} edge-case points of {shape4} (on "
                              f"every x-plane, outside the grid)", gs,
                              kernels, tricubic, sf4, grid4, table4, edge,
                              gen, full=False, **k7_kw)
    del edge
    shape5 = (64, 64, 64) if small else (512, 512, 512)
    grid5 = Grid3D.from_bounds((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0),
                               shape5, device=dev)
    f5 = torch.randn(shape5, generator=gen, device=dev)
    sf5 = gs.shard_field(mesh8, f5)
    n_rand = 4096 if small else 1 << 20
    lo, hi = grid5.origin - 30.0, grid5.upper() + 30.0
    rnd = lo + (hi - lo) * torch.rand((n_rand, 3), generator=gen, device=dev)
    out["at"]["random_512"] = k7_at(
        f"{n_rand} random points of a {shape5} field", gs, kernels,
        tricubic, sf5, grid5, f5.reshape(-1, shape5[2]), rnd, gen,
        full=False, **k7_kw)
    del sf5, f5, rnd
    torch.cuda.empty_cache() if cuda else None
    print(f"  [K7 and K7ᵀ: {time.perf_counter() - t0:.1f} s]")

    # 2. J, Jᵀ and LSQR on the x-sharded grid against the unsharded operator
    t1 = time.perf_counter()
    # linearised about the truth: about the horizontally uniform Chapman
    # prior the paired dTEC is a near-cancellation (~0), against which no
    # relative bound means anything
    op_sh = gs.ShardedGridDtecLinear(mesh8, gs.shard_field(mesh8, w4.m_true),
                                     grid4, w4.rays, w4.n_dirs, 0)
    op_un = tec.dtec_paired_linear(w4.m_true, grid4, w4.rays, w4.n_dirs, 0,
                                   "hermite", "cubic")
    v = torch.randn(shape4, generator=gen, device=dev)
    y = torch.randn(op_un.g0.shape, generator=gen, device=dev)
    for what, a, b, lim in (("g0", op_sh.g0, op_un.g0, 3e-6),
                            ("J", op_sh.apply(v), op_un.apply(v), 3e-6),
                            ("Jᵀ", op_sh.apply_t(y), op_un.apply_t(y),
                             2e-5)):
        err = float((a - b).abs().max()) / float(b.abs().max())
        check(err <= lim, f"sharded-grid Hermite dTEC {what} within {lim:g} "
                          f"of max|unsharded| ({err:.3e})")
        out[f"grid_{what}_rel_err"] = err
    # the reference test's solve: the absolute-TEC operator (here the
    # Hermite one, whose endpoint terms run K7's gradient entries) and a
    # right-hand side of a 2 % excess over its own forward, the same for
    # both; the paired operator's near-cancellations make its 20-step
    # LSQR amplify f32 differences past the bound
    op_sh = gs.ShardedGridDtecLinear(mesh8, op_sh.sf, grid4, w4.rays,
                                     None, None)
    op_un = tec.tec_linear_op(w4.m_true, grid4, w4.rays, "hermite", "cubic")
    r_sh = r_un = 0.02 * op_un.g0
    zeros = torch.zeros(grid4.num_voxels, device=dev)

    def lsqr(op, r):
        return linalg.lsqr(lambda x: op.apply(x.reshape(shape4)),
                           lambda z: op.apply_t(z).reshape(-1), r, zeros,
                           damp=1e-3, max_iters=20)[0]

    if cuda:
        kernels.reset_launches()
    dm_sh, secs_sh = clock(lambda: lsqr(op_sh, r_sh))
    launches = dict(kernels.launches) if cuda else {}
    if cuda:
        for name in K7_KERNELS:
            check(launches[name] > 0 and launches[name] % GRID_SHARDS == 0,
                  f"{name} launched in the sharded-grid LSQR, once a shard "
                  f"a call ({launches[name]} times)")
    dm_un, secs_un = clock(lambda: lsqr(op_un, r_un))
    err = float((dm_sh - dm_un).abs().max())
    scale = float(dm_un.abs().max())
    check(err < 2e-3 * scale, f"LSQR (20 iterations) on the x-sharded grid "
                              f"within 2e-3 of max|dm| of the unsharded one "
                              f"({err:.3e} / {scale:.3e})")
    control(out, "grid_lsqr", err / scale, 2e-3,
            lambda: float((lsqr(op_sh, r_sh) - dm_un).abs().max()) / scale,
            ("dropped_shard",))
    out["lsqr"] = dict(seconds_sharded=secs_sh, seconds_unsharded=secs_un,
                       err=err, scale=scale)
    out["launches"] = {k: launches.get(k, 0) for k in K7_KERNELS}
    if cuda:
        out["apply_ms"] = {
            "J_sharded": cuda_ms(lambda: op_sh.apply(v), 5),
            "J_unsharded": cuda_ms(lambda: op_un.apply(v), 5),
            "Jt_sharded": cuda_ms(lambda: op_sh.apply_t(y), 5),
            "Jt_unsharded": cuda_ms(lambda: op_un.apply_t(y), 5)}
    print(f"  sharded-grid LSQR {secs_sh:.3f} s against {secs_un:.3f} s "
          f"unsharded (host clock); launches {out['launches']}; J/Jᵀ ms "
          f"{out.get('apply_ms')}")
    op_p = None
    if cuda and parent is not None:
        pgs = importlib.import_module(parent.package().__name__
                                      + ".parallel.grid_sharding")
        op_p = pgs.ShardedGridDtecLinear(mesh8, op_sh.sf, grid4, w4.rays,
                                         None, None)
        check(bool(torch.equal(lsqr(op_p, r_sh), dm_sh)),
              "the sharded-grid LSQR bitwise the parent's")
        turns = {"parent": [], "new": []}
        for i in range(LSQR_PAIRS):
            for who in (("new", "parent") if i % 2 == 0
                        else ("parent", "new")):
                turns[who].append(timed(lambda: lsqr(
                    op_sh if who == "new" else op_p, r_sh))[1])
        out["lsqr"]["seconds_in_turns"] = turns
        out["lsqr"]["median_in_turns"] = {
            who: float(np.median(t)) for who, t in turns.items()}
        print(f"  sharded-grid LSQR in turns, {LSQR_PAIRS} pairs (host "
              f"clock): " + "; ".join(
                  f"{who} median {np.median(t):.4f} s, {min(t):.4f}-"
                  f"{max(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                  for who, t in turns.items()))
    if cuda and profile:
        out["lsqr"]["profile"] = {"new": profile_by_kernel(
            "the sharded-grid LSQR", lambda: lsqr(op_sh, r_sh))}
        if op_p is not None:
            out["lsqr"]["profile"]["parent"] = profile_by_kernel(
                "the parent's sharded-grid LSQR", lambda: lsqr(op_p, r_sh))
    del op_p
    del op_sh, op_un, dm_sh, dm_un, v, y, sf4, w4
    torch.cuda.empty_cache() if cuda else None
    print(f"  [J, Jᵀ, LSQR: {time.perf_counter() - t1:.1f} s]")

    # 3. the sharded tracer
    t1 = time.perf_counter()
    shape2 = (32, 32, 32) if small else (128, 128, 128)
    grid2 = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0), shape2,
                               device=dev)
    m2 = chapman.log_parametrize(chapman.chapman_field(grid2)).contiguous()
    table2 = m2.reshape(-1, shape2[2])
    sf2 = gs.shard_field(mesh8, m2)
    mesh24 = gs.grid_ray_mesh(2, 4, [dev] * 8)
    sf24 = gs.shard_field(mesh24, m2)
    out["trace"] = {}
    cases = (("config2_6200@128", configs.make_rays(62, 100), 128, mesh8,
              sf2, False),
             ("262144@64", configs.make_rays(512, 512), 64, mesh8, sf2,
              False),
             ("grid2_x_rays4_6200@128", configs.make_rays(62, 100), 128,
              mesh24, sf24, True))
    for name, (ants, dirs), steps, mesh, sf, by_rays in cases:
        if small:
            ants, dirs, steps = ants[:8], dirs[:4], 8
        o, d = rays.make_ray_batch(torch.from_numpy(ants).to(dev),
                                   torch.from_numpy(dirs).to(dev))
        kw = dict(keep_path=False, method="leapfrog")
        sh, s_sh = clock(lambda: gs.trace_rays_sharded(
            mesh, sf, grid2, o, d, FREQ_HZ, LENGTH_KM, n_steps=steps,
            rays_sharded=by_rays, **kw))

        def whole(x):       # K5, or in a rehearsal its twin in K5's order
            if x.is_cuda:
                return kernels.cubic_value_grad(table2, grid2, x)
            return tricubic.interp_rows_with_grad_taps_ref(table2, grid2, x)
        k5, s_k5 = clock(lambda: fermat._trace_impl(
            fermat.log_field_ne_vg(whole), o, d, FREQ_HZ, LENGTH_KM, steps,
            False, "leapfrog"))
        check(bool(torch.equal(sh[0].points, k5[0].points)
                   and torch.equal(sh[1], k5[1])),
              f"trace_rays_sharded {name} ({o.shape[0]} rays) bitwise the "
              f"plain integrator over "
              + ("K5" if cuda else "the plain evaluator"))
        k1c, s_k1c = clock(lambda: fermat.trace_rays(
            m2, grid2, o, d, FREQ_HZ, LENGTH_KM, n_steps=steps, **kw))
        err_x, err_t = check_against_plain(f"K1c against the sharded trace "
                                           f"{name}", k1c, sh)
        out["trace"][name] = dict(rays=o.shape[0], steps=steps,
                                  seconds_sharded=s_sh, seconds_k5=s_k5,
                                  seconds_k1c=s_k1c, k1c_err_x=err_x,
                                  k1c_err_tau=err_t)
        print(f"  trace {name}: sharded {s_sh:.3f} s, over K5 {s_k5:.3f} s, "
              f"K1c {s_k1c:.4f} s (host clock)")
    del sf2, sf24, m2
    print(f"  [traces: {time.perf_counter() - t1:.1f} s]")

    # 4a. the ray mesh: phase 16's snapshot solve
    t1 = time.perf_counter()
    if small:
        from ionotomo_tpu_torch.data import synth
        dp, truth = synth.generate_example_datapack(
            n_antennas=6, n_directions=4, n_times=3, grid_shape=(16, 16, 16),
            device=dev)
        dp.wind_kmps = truth["wind_kmps"]
        anchor_truth, truth = truth, None
    else:
        dp, truth = invert_world(dev)
        anchor_truth = truth
    sub = dp.select(times=[0])
    sub.wind_kmps = dp.wind_kmps
    mesh4 = sm.ray_mesh([dev] * RAY_SHARDS)
    cfg = invert_config("sharded", shape=(16,) * 3 if small else None)
    pipe = InversionPipeline(sub, cfg, device=dev, mesh=mesh4)
    nd = pipe.directions.shape[1]
    ants, d_t, noise, na = pipe._padded_data(0)
    rb = pipe.rays_for_time(0, antennas=ants)
    srb = pipe._shard(rb)
    check(ants.shape[0] % RAY_SHARDS == 0 and ants.shape[0] >= na,
          f"{na} antennas padded to {ants.shape[0]} for {RAY_SHARDS} shards")

    def solve(bundle, **sched):
        if not sched:                   # the invert CLI's: gn 2, cg 40
            return pipe._solve_once(bundle, d_t, noise, pipe.m_prior, nd).m
        return solvers.map_gauss_newton(
            pipe.grid, bundle, d_t, noise, pipe.m_prior, pipe.cov,
            num_directions=nd, i0=pipe.i0, quadrature=cfg.rays.quadrature,
            interp=cfg.rays.interp, **sched).m

    dry = dict(gn_iters=1, cg_iters=8)  # the reference dry run's schedule
    a, b = solve(srb, **dry), solve(rb, **dry)
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    check(err <= SHARDED_SOLVE_LIMIT * scale,
          f"the ray-sharded snapshot solve at the reference dry run's "
          f"schedule (gn 1, cg 8) within {SHARDED_SOLVE_LIMIT:g} of max|m| "
          f"of the unsharded one on the same padded problem ({err:.3e} / "
          f"{scale:.3e})")
    control(out, "snapshot_dry", err / scale, SHARDED_SOLVE_LIMIT,
            lambda: float((solve(srb, **dry) - b).abs().max()) / scale)
    m_a, s_a = clock(lambda: solve(srb))
    m_b = solve(srb)
    check(bool(torch.equal(m_a, m_b)), "the ray-sharded snapshot solve is "
                                       "bitwise the same across two calls")
    m_u, s_u = clock(lambda: solve(rb))
    rel, dh = sharded_reading(m_a, m_u, pipe.m_prior,
                              lambda m: invert_heldout(
                                  host(m), pipe.grid, truth, 0, cfg)
                              if truth is not None else 0.0)
    check(rel <= INVERT_FIELD_LIMIT and dh <= INVERT_HELDOUT_LIMIT,
          f"at the invert CLI's schedule (gn 2, cg 40) the ray-sharded "
          f"solve against the unsharded one as phase 16 holds the card to "
          f"the CPU: field within {INVERT_FIELD_LIMIT:.0e} of the update "
          f"({rel:.3e}), held-out rms within {INVERT_HELDOUT_LIMIT:.0e} "
          f"({dh:.3e})")
    control(out, "snapshot_cli", rel, INVERT_FIELD_LIMIT,
            lambda: sharded_reading(solve(srb), m_u, pipe.m_prior, None)[0])
    out["snapshot"] = dict(seconds_sharded=s_a, seconds_unsharded=s_u,
                           dry_err=err, dry_scale=scale, rel_update=rel,
                           heldout_rel=dh, antennas=na,
                           padded=int(ants.shape[0]))
    if cuda:        # what the ray-sharded Jᵀ adds: one table a shard
        tables = [torch.randn(pipe.grid.shape, generator=gen, device=dev)
                  for _ in range(RAY_SHARDS)]
        out["snapshot"]["table_psum_ms"] = cuda_ms(lambda: sm.psum(tables),
                                                   20)
        del tables
    print(f"  snapshot solve on {RAY_SHARDS} ray shards {s_a:.3f} s against "
          f"{s_u:.3f} s unsharded (host clock); the psum of {RAY_SHARDS} "
          f"Jᵀ tables {out['snapshot'].get('table_psum_ms', 0.0):.4f} ms "
          f"(CUDA events)")
    del pipe, srb, rb
    print(f"  [snapshot: {time.perf_counter() - t1:.1f} s]")

    # 4b, 5: config 5's world
    t1 = time.perf_counter()
    w5 = configs.config5_world(
        device=dev, **(dict(shape=(16, 16, 16), n_ants=8, n_dirs=6, nt=6,
                            n_modes=16, trace_steps=16, heldout=(3, 4, 99))
                       if small else {}))
    n_steps = 6

    def seq(b):
        return configs._expand_steps(b, n_steps)

    def sm_steps(rs, steps):
        """The first ``steps`` steps of a stacked (sharded) bundle."""
        if isinstance(rs, sm.ShardedRayBundle):
            return rs.map(lambda b: rays.RayBundle(b.points[:steps],
                                                   b.ds[:steps]))
        return rays.RayBundle(rs.points[:steps], rs.ds[:steps])

    srs = sm.shard_rays(mesh4, seq(w5.rays), ray_axis=1)
    srs_in = sm.shard_rays(mesh4, seq(w5.rays_inner), ray_axis=1)

    def kf(rs, rs_in, steps=n_steps, **sched):
        kw = {"cg_iters": 10, **sched}
        return kalman.kalman_filter(
            w5.grid, sm_steps(rs, steps), w5.d_seq[:steps], w5.noise,
            w5.m_bg, w5.cov, w5.wind, w5.dt_s, num_directions=w5.n_dirs,
            rays_inner_seq=sm_steps(rs_in, steps), interp="zp",
            wind_adapt_iters=1, **kw).m_seq

    # the reference dry run's filter: 2 steps, cg 4, fade 0.9
    dry = dict(steps=2, cg_iters=4, fade=0.9)
    a = kf(srs, srs_in, **dry)
    b = kf(seq(w5.rays), seq(w5.rays_inner), **dry)
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    check(err <= SHARDED_SOLVE_LIMIT * scale,
          f"the mixed-fidelity wind-adaptive filter at the reference dry "
          f"run's schedule (2 steps, cg 4) on {RAY_SHARDS} ray shards within "
          f"{SHARDED_SOLVE_LIMIT:g} of max|m| of the unsharded one "
          f"({err:.3e} / {scale:.3e})")
    control(out, "filter_dry", err / scale, SHARDED_SOLVE_LIMIT,
            lambda: float((kf(srs, srs_in, **dry) - b).abs().max()) / scale)
    k_a, s_a = clock(lambda: kf(srs, srs_in))
    check(bool(torch.equal(k_a, kf(srs, srs_in))),
          "the ray-sharded filter is bitwise the same across two calls")
    k_u, s_u = clock(lambda: kf(seq(w5.rays), seq(w5.rays_inner)))
    rel, _ = sharded_reading(k_a, k_u, w5.m_bg[None], None)
    check(rel <= SHARDED_FILTER_LIMIT,
          f"config 5's first chunk ({n_steps} steps, cg 10, mixed fidelity, "
          f"wind adaptation) on {RAY_SHARDS} ray shards within "
          f"{SHARDED_FILTER_LIMIT:.0e} of the update of the unsharded filter "
          f"({rel:.3e})")
    control(out, "filter_chunk", rel, SHARDED_FILTER_LIMIT,
            lambda: sharded_reading(kf(srs, srs_in), k_u, w5.m_bg[None],
                                    None)[0])
    out["kalman"] = dict(seconds_sharded=s_a, seconds_unsharded=s_u,
                         dry_err=err, dry_scale=scale, rel_update=rel)
    print(f"  filter on {RAY_SHARDS} ray shards {s_a:.3f} s against "
          f"{s_u:.3f} s unsharded (host clock)")

    # 5. the member-parallel ensemble
    b = B_MEMBERS
    init, obs = configs.enkf_noise(w5, b, n_steps, seed=0)
    en_kw = dict(num_directions=w5.n_dirs, cg_iters=10, interp="zp",
                 n_members=b, obs_noise=obs, m_clim=w5.m_bg,
                 rays_inner_seq=seq(w5.rays_inner))
    ens0 = kalman.initial_ensemble(w5.grid, w5.cov, w5.m_bg, init)
    args = (w5.grid, seq(w5.rays), w5.d_seq[:n_steps], w5.noise, w5.m_bg,
            w5.cov, w5.wind, w5.dt_s)
    base, s_base = clock(lambda: kalman.ensemble_kalman_filter(
        *args, ens0=ens0, **en_kw))
    scale = float((base.ensemble - w5.m_bg[None]).abs().max())
    out["enkf"] = {}
    for groups in (2, 8):
        mesh = sm.member_mesh([dev] * groups)
        if cuda:
            kernels.reset_launches()
        res, secs = clock(lambda: kalman.member_parallel_enkf(
            mesh, *args, ens0=sm.member_sharding(mesh)(ens0), **en_kw))
        got = dict(kernels.launches) if cuda else {}
        if cuda:
            for k in ("rows_value_fwd_batched", "rows_value_bwd_batched",
                      "pack_members"):
                check(got[k] > 0, f"{k} launched by the {groups} groups of "
                                  f"{b // groups} ({got[k]} times)")
        def reading(res):
            """The largest difference from the unsharded filter, over
            max(the ensemble's departure, 1)."""
            return max(float((getattr(res, k) if k != "ensemble"
                              else res.ensemble.gather()).sub(
                                  getattr(base, k)).abs().max())
                       for k in ("mean_seq", "std_seq", "ensemble")
                       ) / max(scale, 1.0)
        err = reading(res)
        check(err < 2e-3, f"member_parallel_enkf over {groups} groups "
                          f"within 2e-3 of the ensemble's departure "
                          f"{scale:.3e} of the unsharded filter ({err:.3e})")
        if groups == 2:
            control(out, "enkf_members", err, 2e-3,
                    lambda: reading(kalman.member_parallel_enkf(
                        mesh, *args, ens0=sm.member_sharding(mesh)(ens0),
                        **en_kw)), ("dropped_shard",))
        out["enkf"][f"groups_{groups}"] = dict(seconds=secs, err=err,
                                               launches=got)
        print(f"  member_parallel_enkf over {groups} groups of {b // groups} "
              f"{secs:.3f} s against {s_base:.3f} s unsharded (host clock)")
    out["enkf"]["seconds_unsharded"] = s_base
    if cuda:
        # the shapes the 8 groups of 1 give K2b, K3b, the pack and the
        # fold: config 5's two bundles at B = 1, held against the plain
        # versions (their launches are the 8-group run's)
        rng = np.random.default_rng(181)
        nx, ny, nz = w5.grid.shape
        out["enkf"]["at_b1"] = {}
        for name, rb in (("outer", w5.rays), ("inner", w5.rays_inner)):
            geo = tec.DtecGeometry(w5.grid, rb, w5.n_dirs, 0, "hermite",
                                   "zp")
            out["enkf"]["at_b1"][f"zp@{geo.ri.shape[0]}"] = member_kernels_at(
                f"config 5's {name} bundle, B = 1", dev, tricubic, kernels,
                (geo.ri, geo.wxy, geo.zi, geo.wz), geo.row_plan, nx * ny, nz,
                True, rng, layout=rb is w5.rays, b=1)
            del geo
    del w5, base
    torch.cuda.empty_cache() if cuda else None
    print(f"  [config 5 on meshes: {time.perf_counter() - t1:.1f} s]")

    # 6. the pipeline with mesh=
    t1 = time.perf_counter()
    sub3 = dp.select(times=[0, 1, 2])
    sub3.wind_kmps = dp.wind_kmps
    mesh2 = sm.ray_mesh([dev] * PIPE_SHARDS)
    out["pipeline"] = {}
    for mode, argv, kinds in (
            ("kalman", ("--solver", "kalman", "--kalman-chunk", "3"), FAULTS),
            ("enkf_members", ("--solver", "enkf", "--enkf-shard",
                              "members", "--kalman-chunk", "3"),
             ("dropped_shard",))):
        sols, secs = [], []

        def run(tag, mesh):
            c = invert_config(f"pipe_{mode}_{tag}", *argv,
                              shape=(16,) * 3 if small else None)
            p = InversionPipeline(sub3, c, device=dev, mesh=mesh)
            return clock(lambda: p.run(resume=False)), p

        for tag, mesh in (("mesh", mesh2), ("none", None)):
            (sol, s), p = run(tag, mesh)
            sols.append(sol)
            secs.append(s)
        prior = p.m_prior.cpu().numpy()
        delta = float(np.abs(sols[1].m - prior).max())
        diff = float(np.abs(sols[0].m - sols[1].m).max())
        check(diff < SHARDED_PIPE_LIMIT * delta
              and np.isfinite(sols[0].m).all(),
              f"the pipeline in {mode} mode on a {PIPE_SHARDS}-device mesh "
              f"within {SHARDED_PIPE_LIMIT:g} of the departure of the "
              f"meshless run ({diff:.3e} / {delta:.3e})")
        control(out, f"pipeline_{mode}", diff / delta, SHARDED_PIPE_LIMIT,
                lambda: float(np.abs(run("fault", mesh2)[0][0].m
                                     - sols[1].m).max()) / delta, kinds)
        out["pipeline"][mode] = dict(seconds_mesh=secs[0],
                                     seconds_none=secs[1], diff=diff,
                                     delta=delta)
        print(f"  pipeline {mode}: with the mesh {secs[0]:.2f} s, without "
              f"{secs[1]:.2f} s (host clock)")
    print(f"  [pipelines: {time.perf_counter() - t1:.1f} s]")

    # 6b. the pipeline's other ray-mesh call sites, on §4's mesh
    t1 = time.perf_counter()
    out["pipeline_modes"] = pipeline_mesh_modes(
        dev, kernels, dp, anchor_truth, mesh4, small, clock, out,
        depth_study)
    print(f"  [pipeline modes on the ray mesh: "
          f"{time.perf_counter() - t1:.1f} s]")
    results["sharded"] = out
    return out


def sharded_only(parent_dir=None, profile=False, study=False,
                 depth_study=False) -> int:
    """``--sharded``: the build and phase 18 alone (the multi-device layer
    with its shards on the one card); with ``--parent DIR`` K7, K7ᵀ and the
    LSQR held to the parent's and timed in turns, with ``--profile`` the
    LSQR's device time by kernel, with ``--k7-study`` first the sweep of
    ``k7_study``, with ``--depth-study`` §6b's ``depth_finding``."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s")
    for kernel, (regs, stack, spill_st, spill_ld) in ptxas_by_kernel(
            info["log"]).items():
        if "sharded" in kernel:
            print(f"  ptxas: {kernel}: {regs} registers, stack {stack} B, "
                  f"spills {spill_st}/{spill_ld} B")
    build.load()
    parent = Parent(parent_dir) if parent_dir else None
    lap = Laps()
    results = {}
    if study:
        results["k7_study"] = k7_study(dev, K7_RULES_BEFORE)
        lap("k7_study")
    phase18_sharded(dev, kernels, results, profile=profile, parent=parent,
                    depth_study=depth_study)
    lap("phase18_sharded")
    main, at = sharded_kernel_entries(results)
    print(json.dumps({"kernels": main, "kernels_at_sharded": at}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def sharded_kernel_entries(results):
    """(rows, rows at other shapes) of K7 and K7ᵀ for the kernels line:
    launches in the sharded-grid LSQR at config 4 (phase 18's main path),
    error, ms (summed over the 8 shards, and per shard), bound and plain
    ms at config 4's bundle points (the value entries) and endpoints (the
    gradient entries), ``index_add_`` of the owned entries for K7ᵀ; the
    other shapes are "kernels_at_sharded"."""
    sh = results["sharded"]
    src = "ionotomo_tpu_torch/kernels/csrc/"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def row(name, line, shape):
        f, rep = K7_KERNELS[name]
        return {"name": name, "route": "cuda", "source": src + f,
                "replaces": rep, "launches": sh["launches"][name],
                **{k: line[k] for k in keys}, "timed_by": timed_by(line),
                "ms_per_shard": line["ms_per_shard"],
                "points": line["points"], "shards": line["shards"],
                "shape": shape,
                **{k: line[k] for k in ("one_shot_ms", "parent_ms",
                                        "new_ms_in_turns", "variants")
                   if k in line}}
    main = [row(name, sh["at"][shape][name], shape)
            for name in K7_KERNELS
            for shape in (("config4_ends",) if "grad" in name
                          else ("config4_points",))]
    at = [row(name, line, shape) for shape, lines in sh["at"].items()
          for name, line in lines.items()
          if shape != ("config4_ends" if "grad" in name
                       else "config4_points")]
    # K2b, K3b, the pack and the fold at the member groups' B = 1 (config
    # 5's two bundles), with their launches in the 8-group run
    sources = {name: (f, rep) for name, f, rep in KERNEL_ENTRIES}
    got = sh["enkf"]["groups_8"]["launches"]
    for shape, lines in sh["enkf"].get("at_b1", {}).items():
        for name, line in lines.items():
            f, rep = sources[name]
            at.append({"name": name, "route": "cuda", "source": src + f,
                       "replaces": rep, "launches": got.get(name, 0),
                       **{k: line[k] for k in keys},
                       "timed_by": timed_by(line), "shape": shape,
                       "members": 1, "groups": 8})
    return main, at


#: Each kernel of the kernels line: its wrapper's name, its source in
#: ionotomo_tpu_torch/kernels/csrc and the reference line it replaces.
KERNEL_ENTRIES = [
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
    ("trace_rk4_zp", "trace_leapfrog_zp.cu",
     "ionotomo_tpu/geometry/fermat.py:182"),
    ("trace_rk4_cubic", "trace_leapfrog_cubic.cu",
     "ionotomo_tpu/geometry/fermat.py:182"),
    ("trace_rk4_zpc", "trace_leapfrog_zpc.cu",
     "ionotomo_tpu/geometry/fermat.py:182"),
    ("trace_rk4_quad", "trace_leapfrog_quad.cu",
     "ionotomo_tpu/geometry/fermat.py:182"),
    ("trace_split", "trace_split.cu",
     "ionotomo_tpu/geometry/fermat.py:243"),
]

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
    # error, ms and bound at the bench trace's points halfway, "at" phase
    # 2's points;
    # K1z and K1q: launches in one trace of the bench's batch, error (8192
    # rays, phase 2), ms and bound of the call (pack, sort and trace) at
    # the bench's batch. "kernels_at_config4" holds K2 at zpc's (8, 4)
    # shape at the solve's two bundles, with its launches in one
    # zpc2-inner solve. K6q's launches: in the rk4 trace on quadratic
    # through trace_rays (phase 14; 0, as K1r took its place; the per-stage
    # route's count, which no entry point takes on the card, under
    # "route_not_a_path"). K1r on each model:
    # launches in one rk4 trace of the bench's batch, error (8192 rays),
    # ms and bound of the call (pack, sort and trace) at the bench's batch,
    # rk4@64; K1s: the same for the split trace at leapfrog@32, "at" its
    # rk4@64.
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
                             "trace_leapfrog_quad", "trace_rk4_zp",
                             "trace_rk4_cubic", "trace_rk4_zpc",
                             "trace_rk4_quad", "trace_split")}}
    entries = KERNEL_ENTRIES
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def entry(name, f, rep, n, line):
        return {"name": name, "route": "cuda", "source": src + f,
                "replaces": rep, "launches": n, **{k: line[k] for k in keys},
                "timed_by": timed_by(line)}

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
    # "kernels_at_service": every kernel of the service's path alone at
    # the shapes an epoch gives it (phase 15: 620 rays x 129 samples on
    # 128^3, 1,240 endpoints, the adaptive-R probes' 2 members), with its
    # launches in the 110-epoch stream
    service = results["service"]
    at_service = [{**entry(name, *reps[name],
                           service["launches"].get(name, 0), line),
                   "shape": "service"} for name, line in service["at"].items()]
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
    fold = results["fold_member_rows"]["line"]
    extra = {
        "zp_value_grad": k1e,
        # the fold's bound over the spans it reads, the first design's
        # (whole partial rows) beside it
        "fold_member_rows": {
            **entry("fold_member_rows", *reps["fold_member_rows"],
                    launches["fold_member_rows"], fold),
            "full_row_bound_ms": fold["full_row_bound_ms"]},
        "trace_split": {**entry("trace_split", *reps["trace_split"],
                                launches["trace_split"],
                                results["trace_split"]["line"]),
                        "at": results["trace_split"]["at"]},
        **{name: {**entry(name, *reps[name], launches[name],
                          results[name]["line"]),
                  "at": results[name + "_at"]}
           for name in ("zpc_value_grad", "zpc_value_grad_bwd")},
        "quad_value_grad": {
            **entry("quad_value_grad", *reps["quad_value_grad"],
                    launches["quad_value_grad"],
                    results["quad_value_grad"]["line"]),
            "route_not_a_path":
                results["quad_value_grad"]["route_not_a_path"],
            "at": results["quad_value_grad_at"]},
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
    kernel_list = [extra[name] if name in extra else
                   entry(name, f, rep, launches[name], results[name]["line"])
                   for name, f, rep in entries]
    # K7 and K7ᵀ (phase 18: the x-sharded grid's main path, the LSQR at
    # config 4 on 8 shards of the one card)
    sharded_rows, at_sharded = sharded_kernel_entries(results)
    kernel_list += sharded_rows
    # the service's launches (phase 15: the 110-epoch stream at the
    # defaults, counted from 0 just before it and read just after), and
    # the batch inversion's (phase 16: the default snapshot mode over its
    # timesteps, and each other mode's run)
    inv = results["invert"]
    by_mode = {name: m["launches"] for name, m in inv["modes"].items()}
    for e in kernel_list:
        paths = e.setdefault("launches_by_path", {})
        paths["service_110_epochs"] = service["launches"].get(e["name"], 0)
        paths[f"invert_{inv['timesteps']}_snapshots"] = \
            inv["launches"].get(e["name"], 0)
        paths["invert_modes"] = {mode: got[e["name"]]
                                 for mode, got in by_mode.items()
                                 if got.get(e["name"])}
    # phase 17: each predict form's launches over the world's 8 timesteps
    # (counted from 0 just before the form's first timed call)
    pv = results["predict"]
    for e in kernel_list:
        e["launches_by_path"]["predict"] = {
            form: f["launches"][e["name"]] for form, f in pv["forms"].items()
            if f["launches"].get(e["name"])}
    # "kernels_at_invert": K2b with its pack and K3b with its fold at B = 8
    # over the snapshot geometry's points (phase 16), with their launches
    # summed over the inversion modes that run them (by mode beside)
    at_invert = [{**entry(name, *reps[name],
                          sum(got.get(name, 0) for got in by_mode.values()),
                          line),
                  "shape": "invert", "members": B_MEMBERS,
                  "launches_by_mode": {mode: got[name]
                                       for mode, got in by_mode.items()
                                       if got.get(name)}}
                 for name, line in inv["at"].items()
                 if name in reps]
    # "kernels_at_predict": K2 in ray order at the straight and the bent
    # bundle's points, K5 at the endpoints, K1c with its path at 620 rays
    # x 64 steps (phase 17), each with its launches a timestep in the form
    # that gives it that shape (K2 at the straight shape: straight with
    # RM, one gather for the dTEC and one for RM; at the bent shape: bent
    # with RM, likewise; K5: straight; K1c: bent with RM)
    forms = {"rows_value_fwd@straight": "straight_rm",
             "rows_value_fwd@bent": "bent_rm",
             "cubic_value_grad": "straight",
             "trace_leapfrog_cubic": "bent_rm"}
    at_predict = []
    for label, line in pv["at"].items():
        name = label.split("@")[0]
        per_t = pv["forms"][forms[label]]["launches_per_timestep"]
        at_predict.append({**entry(name, *reps[name],
                                   pv["forms"][forms[label]]["launches"]
                                   .get(name, 0), line),
                           "shape": label, "form": forms[label],
                           "launches_per_timestep": per_t.get(name, 0)})
    return {"kernels": kernel_list,
            "kernels_at_config4": at4, "kernels_at_member_shapes": members,
            "kernels_at_service": at_service,
            "kernels_at_invert": at_invert,
            "kernels_at_predict": at_predict,
            "kernels_at_sharded": at_sharded}


def service_only() -> int:
    """``--service``: the build and phase 15 alone (the streaming service;
    ~1-2 min on an H100)."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s")
    build.load()
    lap = Laps()
    phase15_service(dev, kernels, {})
    lap("phase15_service")
    return 0


def invert_only(profile=False, parent_dir=None) -> int:
    """``--invert [--parent DIR]``: the build and phase 16 alone (the
    batch inversion in every mode; ~1-2 min on an H100)."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s")
    build.load()
    lap = Laps()
    phase16_invert(dev, kernels, {}, profile=profile,
                   parent=Parent(parent_dir) if parent_dir else None)
    lap("phase16_invert")
    return 0


def predict_only(profile=False) -> int:
    """``--predict``: the build and phase 17 alone (``predict`` in its four
    forms, the screens, the structure function, the NaN-check mode and
    the path's kernels at its shapes; with --profile one timestep of each
    form profiled)."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s")
    build.load()
    lap = Laps()
    phase17_predict(dev, kernels, {}, profile=profile)
    lap("phase17_predict")
    return 0


#: ``--theta-study``'s Gauss-Newton schedules of the estimate_profile
#: mode's joint (θ, δm) solve: (cg, gn); the mode runs cg 40 (the invert
#: CLI's default) and gn 4 (the pipeline's least).
THETA_CARD_RUNS = ((5, 4), (10, 4), (20, 4), (40, 4), (80, 4), (40, 1),
                   (40, 2), (40, 3))
THETA_CPU_RUNS = ((40, 4),)
THETA_F64_RUNS = ((40, 1), (40, 4))


def theta_solve(pipe, anchors, cg_iters, gn_iters):
    """The joint (θ, δm) solve of ``pipe._estimate_profile`` (its
    arguments, the single flat Chapman layer) at another depth: θ̂ as
    (N_peak, h_peak km, H km), the residual after each Gauss-Newton step,
    the CG iterations of each, and the seconds."""
    from ionotomo_tpu_torch.device import host
    from ionotomo_tpu_torch.inversion.profile import (
        ProfileParams, chapman_log_field, map_gauss_newton_profile)

    p, sc = pipe.config.physics, pipe.config.solver
    ants, d0, noise0, _ = pipe._padded_data(0)
    theta0 = ProfileParams.create(n_peak=p.chapman_n_peak,
                                  h_peak_km=p.chapman_h_peak_km,
                                  scale_km=p.chapman_scale_km,
                                  device=pipe.device)
    sync(pipe.device)
    t0 = time.perf_counter()
    res = map_gauss_newton_profile(
        pipe.grid, pipe.rays_for_time(0, antennas=ants), d0, noise0, theta0,
        sc.profile_sigma, pipe.cov, num_directions=pipe.directions.shape[1],
        anchors=anchors, i0=pipe.i0, gn_iters=gn_iters, cg_iters=cg_iters,
        quadrature=pipe.config.rays.quadrature,
        interp=pipe.config.rays.interp,
        field_builder=lambda t: chapman_log_field(
            pipe.grid, ProfileParams(t[0], t[1], t[2]),
            curved=bool(p.curved_earth)))
    sync(pipe.device)
    theta = [float(res.theta.n_peak), float(res.theta.h_peak_km),
             float(res.theta.scale_km)]
    return dict(theta=theta, residual=host(res.info[0]).tolist(),
                cg=host(res.info[1]).tolist(),
                seconds=time.perf_counter() - t0)


def theta_study() -> int:
    """``--theta-study``: why phase 16's estimate_profile mode returns an
    unphysical θ̂ (a negative scale height) at the invert CLI's cg 40. The
    mode's joint solve, on phase 16's world (timestep 0, the truth's slant
    anchors, 128^3 cubic Hermite@129), through ``theta_solve``: on the
    card at every schedule of ``THETA_CARD_RUNS`` (the depth of CG, then
    the Gauss-Newton steps at cg 40), on the CPU (the plain versions of
    the kernels) at ``THETA_CPU_RUNS``, then on the CPU in float64 at
    ``THETA_F64_RUNS``: for that last part every ``torch.float32`` that the
    port names is rebound to float64, and the pipeline, its grid, prior,
    data and anchors are made again under it (the study's last step; the
    process ends after it). If f32 rounding in CG set θ̂, the float64
    solve would part from the card's; if the Gauss-Newton iteration does,
    the two agree and θ̂ moves with the number of steps. The pipeline's
    own ``_estimate_profile`` is run once on the card and must equal
    ``theta_solve`` at (cg 40, gn 4) bit for bit."""
    from ionotomo_tpu_torch.geometry.rays import RayBundle
    from ionotomo_tpu_torch.inversion.anchors import TecAnchors
    from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
    from ionotomo_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card_line()}")
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s")
    build.load()
    dp, truth = invert_world(dev)
    sub = dp.select(times=[0])
    sub.wind_kmps = dp.wind_kmps
    cfg = invert_config("theta", "--estimate-profile")
    pipe = InversionPipeline(sub, cfg, device=dev)
    anchors = slant_truth_anchors(dev, pipe, truth)
    print(f"  world: {sub.shape[0]} antennas x {sub.shape[2]} directions, "
          f"timestep 0, {len(anchors.values)} slant anchors; grid "
          f"{tuple(pipe.grid.shape)}, prior theta (N_peak, h_peak, H) = "
          f"({cfg.physics.chapman_n_peak:g}, {cfg.physics.chapman_h_peak_km}"
          f", {cfg.physics.chapman_scale_km}), sigma "
          f"{cfg.solver.profile_sigma}")
    rows = {}

    def show(where, cg, gn, r):
        rows[f"{where} cg {cg} gn {gn}"] = r
        n, h, H = r["theta"]
        print(f"  {where:>12s} cg {cg:3d} gn {gn}: N_peak {n:.6e}, h_peak "
              f"{h:.3f} km, H {H:.3f} km; residual by step "
              + ", ".join(f"{v:.3f}" for v in r["residual"])
              + f"; CG iterations {r['cg']}; {r['seconds']:.2f} s")

    pipe._estimate_profile(anchors)
    mode = pipe.metrics.read_all()[-1]
    for cg, gn in THETA_CARD_RUNS:
        show("card f32", cg, gn, theta_solve(pipe, anchors, cg, gn))
    want = rows["card f32 cg 40 gn 4"]["theta"]
    got = [mode["n_peak"], mode["h_peak_km"], mode["scale_km"]]
    check(got == want, f"the pipeline's estimate_profile equals theta_solve "
                       f"at cg 40, gn 4 ({got})")
    cpu = torch.device("cpu")
    host_pipe = InversionPipeline(sub, invert_config("theta_cpu",
                                                     "--estimate-profile"),
                                  device=cpu)

    def on_cpu(dtype):
        return TecAnchors(
            rays=RayBundle(anchors.rays.points.to(cpu, dtype),
                           anchors.rays.ds.to(cpu, dtype)),
            values=anchors.values.to(cpu, dtype),
            noise_std=torch.as_tensor(anchors.noise_std).to(cpu, dtype))
    for cg, gn in THETA_CPU_RUNS:
        show("cpu f32", cg, gn,
             theta_solve(host_pipe, on_cpu(torch.float32), cg, gn))
    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)
    f64_pipe = InversionPipeline(sub, invert_config("theta_f64",
                                                    "--estimate-profile"),
                                 device=cpu)
    check(f64_pipe.m_prior.dtype == torch.float64
          and f64_pipe.grid.spacing.dtype == torch.float64,
          "the float64 pipeline's grid and prior are float64")
    for cg, gn in THETA_F64_RUNS:
        show("cpu f64", cg, gn,
             theta_solve(f64_pipe, on_cpu(torch.float64), cg, gn))
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/theta_study.json").write_text(json.dumps(rows))
    return 0


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
        return e_study(parent_dir)
    if "--k1c-study" in args:
        return k1c_study()
    if "--k5t-study" in args:
        return k5t_study()
    if "--k6zt-study" in args:
        return k6zt_study()
    if "--rk4-study" in args:
        return rk4_study()
    if "--k1zq-study" in args:
        return k1zq_study(parent_dir)
    if "--member-study" in args:
        return member_study(parent_dir)
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
    if "--service" in args:
        return service_only()
    if "--theta-study" in args:
        return theta_study()
    if "--invert" in args:
        return invert_only(profile, parent_dir)
    if "--predict" in args:
        return predict_only(profile)
    if "--sharded" in args:
        return sharded_only(parent_dir, profile, "--k7-study" in args,
                            "--depth-study" in args)

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
    lap = Laps()
    info = build.build()
    print(f"  built={info['built']} in {info['seconds']:.2f} s -> "
          f"{info['path'].name}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    build.load()

    parent = Parent(parent_dir) if parent_dir else None
    lap("phase 1, the builds")
    if parent is None:
        print("  no --parent DIR: no phase holds a kernel to the parent's")
    results = {}
    phase2_kernels_vs_plain(dev, boxspline, tricubic, fermat, kernels,
                            Grid3D, chapman, results, parent)
    lap("phase2_kernels_vs_plain")
    phase2_new_models(dev, tricubic, zpcubic, triquadratic, fermat, kernels,
                      Grid3D, chapman, results, parent=parent)
    lap("phase2_new_models")
    phase3_throughput(dev, boxspline, fermat, kernels, Grid3D, chapman,
                      results, card, parent)
    lap("phase3_throughput")
    phase3_new_tracers(dev, fermat, kernels, Grid3D, chapman, results, card,
                       parent=parent)
    lap("phase3_new_tracers")
    phase4_serving(dev, boxspline, fermat, rays, tec, kernels, Grid3D, chapman,
                   results, profile, parent)
    lap("phase4_serving")
    phase5_adjoint_kernels(dev, boxspline, tricubic, kernels, Grid3D,
                           results, parent)
    lap("phase5_adjoint_kernels")
    phase6_solve(dev, boxspline, tricubic, fermat, rays, tec, kernels,
                 chapman, priors, solvers, results, profile, parent)
    lap("phase6_solve")
    phase7_probe(dev, gather, kernels, results, parent)
    lap("phase7_probe")
    phase8_cubic_kernels(dev, tricubic, fermat, rays, tec, kernels, Grid3D,
                         chapman, results, parent)
    lap("phase8_cubic_kernels")
    phase9_config2(dev, fermat, rays, kernels, Grid3D, chapman, configs,
                   results, card, parent=parent)
    lap("phase9_config2")
    phase10_config4(dev, tricubic, rays, tec, kernels, configs, results,
                    profile, parent)
    lap("phase10_config4")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world5 = configs.config5_world(device=dev)
    torch.cuda.synchronize()
    print(f"config 5's world (30 epochs of 10,000 bent rays at 128 steps "
          f"through the drifting analytic world): set-up "
          f"{time.perf_counter() - t0:.2f} s")
    phase11_member_kernels(dev, world5, boxspline, tricubic, tec, kernels,
                           Grid3D, results, parent)
    lap("phase11_member_kernels")
    cache5 = phase12_config5(dev, world5, boxspline, tricubic, tec, kernels,
                             configs, results, profile, parent=parent)
    lap("phase12_config5")
    phase13_enkf(dev, world5, cache5, boxspline, tricubic, tec, kernels,
                 configs, results, profile, parent=parent)
    lap("phase13_enkf")
    del world5, cache5
    torch.cuda.empty_cache()
    phase14_tracers(dev, fermat, rays, kernels, Grid3D, chapman, results,
                    card, lap, parent=parent)
    lap("phase14_tracers")
    torch.cuda.empty_cache()
    phase15_service(dev, kernels, results, parent=parent)
    lap("phase15_service")
    torch.cuda.empty_cache()
    phase16_invert(dev, kernels, results, profile=profile, parent=parent)
    lap("phase16_invert")
    torch.cuda.empty_cache()
    phase17_predict(dev, kernels, results, profile=profile)
    lap("phase17_predict")
    torch.cuda.empty_cache()
    phase18_sharded(dev, kernels, results, profile=profile, parent=parent)
    lap("phase18_sharded")

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
    st = results["rk4_per_stage"]
    print("rk4@64 at 262144 rays, the per-stage route against K1r through "
          "trace_rays (host clock, ms): " + "; ".join(
              f"{k} {min(v['ms']):.3f} ({v['launches']} launches) -> "
              f"{min(v['k1r_ms']):.3f}" for k, v in st.items())
          + f"; split leapfrog@32 {results['trace_split']['line']['ms']:.4f} "
          f"ms; beam noise of a serving epoch "
          f"{results['beam_noise']['ms']:.3f} ms")
    c5, e5 = results["config5"], results["config5_enkf"]
    print(f"config 5: {c5['steps']} filter steps in "
          f"{min(c5['seconds']):.4f} s ({c5['steps'] / min(c5['seconds']):.2f}"
          f" steps/s), held-out dTEC rms {c5['heldout_dtec_rms_prior']:.4f} "
          f"-> {c5['heldout_dtec_rms_post']:.4f}; ensemble step of "
          f"{B_MEMBERS} members {e5['seconds_per_step']:.4f} s against "
          f"{B_MEMBERS} x {e5['point_seconds_per_step']:.4f} s")
    sv = results["service"]
    print(f"service: {sv['epochs']} epochs at 128^3 cubic defaults with "
          f"adaptive R, epoch latency (host clock) median "
          f"{sv['host_ms'][0]:.3f} ms, p90 {sv['host_ms'][1]:.3f}, max "
          f"{sv['host_ms'][2]:.3f} ({sv['rays_per_s']:.1f} rays/s); the "
          f"filter step median {sv['step_ms'][0]:.1f} ms; geometry "
          f"{sv['geometry_ms']:.3f} ms an epoch; ensemble epoch "
          f"{sv['enkf_ms_per_epoch']:.1f} ms")
    iv = results["invert"]
    print(f"invert: {iv['timesteps']} snapshot solves at 128^3 cubic "
          f"(gn 2, cg 40), median {np.median(iv['seconds']):.4f} s a "
          f"timestep, {iv['rays_per_s']:.1f} rays/s, held-out dTEC rms at "
          f"the last timestep {iv['heldout'][-1]:.2f} against the prior's "
          f"{iv['heldout_prior'][-1]:.2f}; modes: " + ", ".join(
              f"{k} {m['seconds']:.2f} s" for k, m in iv["modes"].items())
          + "; card against CPU: field "
          f"{iv['card_vs_cpu'][0]:.3e}, held-out {iv['card_vs_cpu'][1]:.3e}")
    pv = results["predict"]
    print(f"predict: {pv['timesteps']} timesteps of {pv['rays']} rays at "
          f"128^3, ms a timestep " + ", ".join(
              f"{k} {v['ms_per_timestep']:.3f}" for k, v in pv["forms"].items())
          + "; card against CPU: " + ", ".join(
              f"{k} {e:.2e}" + (f"/{r:.2e}" if r is not None else "")
              for k, (e, r) in pv["card_vs_cpu"].items())
          + f"; screens held-out {pv['screens']['heldout']:.3f} against "
          f"{pv['screens']['heldout_mean_predictor']:.3f}")
    sh = results["sharded"]
    print(f"sharded ({GRID_SHARDS} grid shards, {RAY_SHARDS} ray shards, "
          f"member groups of 2 and 8, in turn on the one card): LSQR "
          f"{sh['lsqr']['seconds_sharded']:.3f} s against "
          f"{sh['lsqr']['seconds_unsharded']:.3f} s; snapshot solve "
          f"{sh['snapshot']['seconds_sharded']:.3f} s against "
          f"{sh['snapshot']['seconds_unsharded']:.3f} s; filter chunk "
          f"{sh['kalman']['seconds_sharded']:.3f} s against "
          f"{sh['kalman']['seconds_unsharded']:.3f} s; ensemble over 8 "
          f"groups {sh['enkf']['groups_8']['seconds']:.3f} s against "
          f"{sh['enkf']['seconds_unsharded']:.3f} s (host clock)")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
