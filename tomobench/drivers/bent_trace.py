"""Bent rays traced with TEC through config 5's field, epoch by epoch, in a
closed loop.

A unit is one call of ``geometry.fermat.trace_rays`` (leapfrog, endpoints
only) over every station × every direction, through the truth's field on
the grid at one epoch; the epochs are made in set-up and cycled, so every
call prefilters a new field. The stations are the config's; as many
directions as the mix names are drawn from the seed, uniform in azimuth
and in zenith angle over the config's range.

Checked, once the window has closed: repeats of an epoch bitwise equal to
its first trace; the endpoints and TEC of sampled epochs' first traces
against the plain reference's tracer over the same field and rays.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..harness import work as W
from ..reference.tracer import trace as ref_trace
from ..worlds import analytic
from . import common

#: f32 operations of one leapfrog step with the zp evaluation of value
#: and gradient (the zp weights and the contraction, exp, sqrt, the
#: kick-drift-kick update), as counted for the port's K1 in its
#: chip_smoke.py (FLOPS_K1_STEP) at the time the benchmark was written.
FLOPS_LEAPFROG_ZP_STEP = 470


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        from ionotomo_tpu_torch.geometry import fermat

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.world = w = common.World(cfg, dev)
        self.fields = [w.truth_field(t) for t in range(w.cfg["nt"])]
        rng = np.random.default_rng([int(seed) % (1 << 63), 3])
        nd = mix["directions"]
        zen = rng.uniform(0.05, w.cfg["zen_max"], nd)
        az = rng.uniform(0.0, 2 * np.pi, nd)
        dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                         np.cos(zen)], -1).astype(np.float32)
        self.origins, self.directions = analytic.ray_batch(w.ants, dirs, dev)
        self.grid = common.port_grid(w)
        self.trace = fermat.trace_rays
        self.layer_unit = ("trace", 1)
        self.per_unit = {"bent_ray": self.origins.shape[0],
                         "attempted": self.origins.shape[0]}
        self.repeats = common.Repeats()
        self.unit(0)           # the warm-up: every shape of the window
        common.sync(self.dev)
        self.repeats = common.Repeats()

    def _call(self, field, grid, origins, directions):
        m = self.mix
        return self.trace(field, grid, origins, directions,
                          m["frequency_hz"], m["length_km"],
                          n_steps=m["steps"], keep_path=False,
                          method="leapfrog", interp=m["model"])

    def unit(self, i: int):
        e = i % len(self.fields)
        with record_function("tomobench.trace"):
            bundle, tau = self._call(self.fields[e], self.grid, self.origins,
                                     self.directions)
            common.sync(self.dev)
        self.repeats.record(e, (bundle.points[:, -1], tau))

    def work(self, i: int) -> W.Work:
        """A trace's least time: the zp prefilter of the field, and per ray
        the leapfrog steps, its origin and direction in, endpoint and TEC
        out."""
        g = self.world.grid
        v, nz = g.num_voxels, g.shape[2]
        r = self.origins.shape[0]
        return (W.Work()
                .add("prefilter", *W.zp_prefilter(v, nz))
                .add("trace", float(r) * self.mix["steps"]
                     * FLOPS_LEAPFROG_ZP_STEP, 40.0 * r))

    def check(self, limits: dict):
        mismatches = self.repeats.mismatches()
        epochs = common.sample(self.seed, 4, sorted(self.repeats.first),
                               self.mix["compare_epochs"])
        kept = {e: self.repeats.first[e] for e in epochs}
        self.repeats.first.clear()
        common.free(self.dev)
        gaps = {"tec_gap": 0.0, "endpoint_gap_m": 0.0}
        for e, out in kept.items():
            for name, v in self._gaps(out, self.reference(e)).items():
                gaps[name] = max(gaps[name], v)
        numbers = [("repeat_mismatches", mismatches,
                    limits["repeat_mismatches"])]
        numbers += [(name, v, limits[name]) for name, v in gaps.items()]
        return numbers, mismatches

    @staticmethod
    def _gaps(out, ref) -> dict:
        """The widest relative TEC gap of a ray, and the widest endpoint
        gap in metres."""
        (x_p, tau_p), (x_r, tau_r) = out, ref
        return {"tec_gap": float(((tau_p.double() - tau_r.double()).abs()
                                  / tau_r.double().abs()).max()),
                "endpoint_gap_m": 1e3 * float(torch.linalg.norm(
                    x_p.double() - x_r.double(), dim=-1).max())}

    def control(self) -> dict:
        """The control's numbers: the reference computed in TF32 put in
        the program's place, on an epoch sampled from the seed."""
        (e,) = common.sample(self.seed, 4, range(len(self.fields)), 1)
        self.repeats.first.clear()
        common.free(self.dev)
        return self._gaps(self.reference(e, tf32=True), self.reference(e))

    def reference(self, e: int, tf32: bool = False):
        m = self.mix
        with record_function("tomobench.reference"):
            return ref_trace(self.fields[e], self.world.grid, self.origins,
                             self.directions, m["frequency_hz"],
                             m["length_km"], m["steps"], m["model"], tf32)
