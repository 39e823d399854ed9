"""Config 4's MAP solves back to back, one batch user's closed loop.

A solve is the progressive Gauss-Newton schedule through
``inversion.solvers.map_gauss_newton``, twice: step 1 on the inner
straight bundle from the prior at ``cg_step1`` CG iterations, step 2 on
the full bundle at ``cg_step2``, warm from step 1's field and whitened
Krylov solution. Every solve starts from the prior; its data are the
noise-free bent-ray dTEC plus one of a bank of noise draws made on the
card from the seed, taken in turn, so every draw is solved many times.

Checked, once the window has closed: repeats of a draw bitwise equal to
its first solve; and for draws sampled from the seed, their first solve
against the plain reference. Step 1 runs 20 f32 CG iterations from zero
on a system whose f32 iterates part from exact arithmetic by about as
much as TF32's do, so no two implementations agree on its field; the
reference therefore follows the program from its own state: it runs step
2 from the program's step-1 field and Krylov solution and is compared
with the program's final field and residual. Step 1, which this skips,
is checked by itself: the linearised forward that its CG runs on (the
inner bundle's g, J and Jᵀ at the prior), applied to the program's own
step-1 update and to the draw's data weighted by the noise.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..harness import work as W
from ..reference.operator import Bundle, Linear
from ..reference.solve import Prior, map_step
from . import common


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        from ionotomo_tpu_torch.inversion import solvers
        from ionotomo_tpu_torch.inversion.priors import GPCovariance

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.s = s = cfg["solve"]
        p = cfg["prior"]
        self.world = w = common.World(cfg, dev)
        clean = w.clean_dtec().reshape(-1)
        self.sigma = w.noise_std(clean)
        gen = common.generator(seed, dev)
        self.bank = clean[None] + self.sigma * torch.randn(
            (mix["bank"], clean.numel()), generator=gen, device=dev)
        self.bank = self.bank.reshape(mix["bank"], w.cfg["n_ants"],
                                      w.n_dirs)
        self.grid = common.port_grid(w)
        self.cov = GPCovariance.create(self.grid, sigma=p["sigma"],
                                       length_scale=p["length_scale_km"],
                                       kind=p["kind"],
                                       inner_scale=p["inner_scale_km"])
        self.rays = common.port_bundle(w, s["samples"])
        self.rays_inner = common.port_bundle(w, s["inner_samples"])
        self.solve = solvers.map_gauss_newton
        self.infos, self.step1 = {}, {}
        self.per_unit = {"solve": 1, "attempted": 1}
        self.layer_unit = ("solve", 1)
        self._touched = {n: common.touched(w, s["model"], n)
                         for n in (s["samples"], s["inner_samples"])}
        self._one(0)          # the warm-up: every shape of the window
        common.sync(self.dev)
        self.repeats = common.Repeats()

    def _one(self, k: int):
        s, w = self.s, self.world
        kw = dict(num_directions=w.n_dirs, quadrature=s["quadrature"],
                  interp=s["model"], warm_start=True, cg_tol=s["cg_tol"],
                  gn_iters=1)
        with record_function("tomobench.gn_step1"):
            r1 = self.solve(self.grid, self.rays_inner, self.bank[k],
                            self.sigma, w.m_prior, self.cov,
                            cg_iters=s["cg_step1"], **kw)
        with record_function("tomobench.gn_step2"):
            r2 = self.solve(self.grid, self.rays, self.bank[k], self.sigma,
                            w.m_prior, self.cov, cg_iters=s["cg_step2"],
                            m0=r1.m, u0=r1.u_final, **kw)
        common.sync(self.dev)
        return r1, r2

    def unit(self, i: int):
        k = i % self.mix["bank"]
        r1, r2 = self._one(k)
        if k not in self.infos:
            self.infos[k] = (r1.info[1], r2.info[1])
            self.step1[k] = (r1.m, r1.u_final)
        self.repeats.record(k, (r2.m, r2.residual_norm))

    def work(self, i: int) -> W.Work:
        """A solve's least time at the config's shapes, its CG iterations
        from the solves' own ``info``."""
        w, s = self.world, self.s
        k = i % self.mix["bank"]
        it1, it2 = (int(x.sum()) for x in self.infos[k])
        v = w.grid.num_voxels
        nz = w.grid.shape[2]
        r = w.cfg["n_ants"] * w.n_dirs
        out = W.Work()
        for n_s, iters in ((s["inner_samples"], it1), (s["samples"], it2)):
            n = r * n_s
            taps, d = 64, self._touched[n_s]
            fwd = W.operator(n, 2 * r, r, taps, d, v, forward=True)
            j = W.operator(n, 2 * r, r, taps, d, v)
            jt = W.operator(n, 2 * r, r, taps, d, v, transpose=True)
            c = W.rfft_pair(v, nz)
            out.add("geometry", 20.0 * n, 12.0 * n)
            out.add("g0", *fwd)
            out.add("J", *j, times=3 + iters)         # prior pull, residual
            out.add("Jt", *jt, times=2 + iters)
            out.add("C_half", *c, times=4 + 2 * iters)
            out.add("cg_update", *W.cg_update(v), times=iters)
            out.add("axpy", *W.axpy(v), times=3 + iters)
        return out

    def check(self, limits: dict):
        """(compared numbers with their limits, units that failed)."""
        mismatches = self.repeats.mismatches()
        draws = common.sample(self.seed, 1, sorted(self.repeats.first),
                              self.mix["compare_draws"])
        ported = {}
        for k in draws:
            m1, u1 = self.step1[k]
            m2, res2 = self.repeats.first[k]
            v, w_res = self._probes(k, m1)
            ported[k] = (m1, u1, m2, res2, self._operator_1(v, w_res), v,
                         w_res)
        self._free()
        gaps = {}
        for k, (m1, u1, m2, res2, ops, v, w_res) in ported.items():
            ref = self._reference(k, m1, u1, v, w_res)
            for name, g in self._gaps((m2, res2, ops), ref).items():
                gaps[name] = max(gaps.get(name, 0.0), g)
        numbers = [("repeat_mismatches", mismatches,
                    limits["repeat_mismatches"])]
        numbers += [(n, gaps[n], limits[n]) for n in sorted(gaps)]
        return numbers, mismatches

    def _probes(self, k: int, m1):
        """What step 1's operator is applied to: the program's own step-1
        update, and the draw's data weighted by the noise (what its
        right-hand side applies Jᵀ to: the forward at the layered prior
        is all but zero)."""
        w = self.world
        return ((m1 - w.m_prior).contiguous(),
                self.bank[k].reshape(-1) / (self.sigma * self.sigma))

    def _operator_1(self, v, w_res):
        """The program's linearised forward of step 1 (the inner bundle at
        the prior, with the plans its solve builds): (g, J v, Jᵀ w)."""
        from ionotomo_tpu_torch.forward import tec
        w, s = self.world, self.s
        args = (self.grid, self.rays_inner, w.n_dirs, 0, s["quadrature"],
                s["model"])
        op = tec.dtec_paired_linear(w.m_prior, *args,
                                    geometry=tec.dtec_geometry(*args))
        out = (op.g0, op.apply(v), op.apply_t(w_res))
        common.sync(self.dev)
        return out

    def _bundle(self, n_samples: int) -> Bundle:
        w = self.world
        pts, ds = common.straight_points(w, n_samples)
        return Bundle(w.grid, pts, ds, w.n_dirs, self.s["model"])

    def _reference(self, k, m1, u1, v, w_res, tf32=False):
        """The plain reference's step 2 of draw k from the state (m1, u1),
        and its step-1 operator applied to v and w: (m2, residual,
        (g, J v, Jᵀ w))."""
        w, s, p = self.world, self.s, self.cfg["prior"]
        with record_function("tomobench.reference"):
            prior = Prior(w.grid, p["sigma"], p["length_scale_km"],
                          p["inner_scale_km"])
            op = Linear(self._bundle(s["inner_samples"]), w.m_prior, tf32)
            ops = (op.g0, op.apply(v), op.apply_t(w_res))
            bases = (self.bank[k].reshape(-1),) + ops[1:]
            del op
            m2, _, res = map_step(self._bundle(s["samples"]), prior,
                                  self.bank[k].reshape(-1), self.sigma,
                                  w.m_prior, m1, u1, s["cg_step2"],
                                  s["cg_tol"], tf32)
        return m2, res, ops, bases, m1

    @staticmethod
    def _gaps(out, ref) -> dict:
        """``field_gap``: the final fields' gap over the reference's step-2
        update; ``residual_gap``: the final whitened residuals' relative
        gap; ``operator_gap_1``: the widest gap of step 1's g (over the
        data: at the prior, a horizontally layered field, the true dTEC
        is all but zero and f32 sums read rounding alone), J v and Jᵀ w
        (over the reference's)."""
        (m2, res2, ops), (m2_r, res_r, ops_r, bases, m1) = out, ref
        return {"field_gap": common.rel_gap(m2, m2_r, m2_r - m1),
                "residual_gap": abs(float(res2) - float(res_r))
                / float(res_r),
                "operator_gap_1": max(common.rel_gap(a, b, c) for a, b, c
                                      in zip(ops, ops_r, bases))}

    def _free(self):
        self.repeats.first.clear()
        self.step1.clear()
        self.cov = self.rays = self.rays_inner = None
        common.free(self.dev)

    def control(self) -> dict:
        """The control's numbers: the reference computed in TF32 put in
        the program's place (its step 1 from the prior, its step 2 from
        that, its step-1 operator), judged as the program is, on a draw
        sampled from the seed."""
        (k,) = common.sample(self.seed, 1, range(self.mix["bank"]), 1)
        self._free()
        w, s, p = self.world, self.s, self.cfg["prior"]
        prior = Prior(w.grid, p["sigma"], p["length_scale_km"],
                      p["inner_scale_km"])
        d = self.bank[k].reshape(-1)
        u0 = torch.zeros(w.grid.num_voxels, device=w.m_prior.device)
        m1, u1, _ = map_step(self._bundle(s["inner_samples"]), prior, d,
                             self.sigma, w.m_prior, w.m_prior, u0,
                             s["cg_step1"], s["cg_tol"], tf32=True)
        v, w_res = self._probes(k, m1)
        m2, res2, ops, _, _ = self._reference(k, m1, u1, v, w_res,
                                              tf32=True)
        return self._gaps((m2, res2, ops),
                          self._reference(k, m1, u1, v, w_res))
