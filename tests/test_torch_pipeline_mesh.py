"""The pipeline's ray mesh at the reference's remaining call sites: the
profile estimate, both prior selections, the posterior draws, the
filters' noise-adaptation and spectrum events and the batched mode, each
on 8 CPU shards (``[torch.device("cpu")] * 8``) with 7 antennas padded
to 8, at ``tests/test_torch_multichip.py``'s sizes (12³, Hermite@17).

Each mode runs twice per module, with the mesh and without it, and the
solver entry of each call site is wrapped to record the bundle it is
handed: under the mesh every one must be a ``ShardedRayBundle`` (the
batched mode's along ray axis 1). The meshed run is held against the
port's pipeline without a mesh on the same padded rays
(``chip_smoke.padded_pipeline``; the meshless
port is held against JAX by ``tests/test_torch_pipeline.py`` and
``tests/test_torch_model_selection_eb_profile.py``; no JAX multi-device
program is compiled here). Tolerances: fields within 1e-2 of their
departure from the prior, as ``test_pipeline_shards_rays_on_the_mesh``;
the posterior std within 1e-3 of its max; scores (GCV, log-evidence
tables, the profile's residual, the spectrum) within 1e-3 relative; the
chosen candidate, θ̂'s grid point and the fitted noise scale the same.
"""
import os

import numpy as np
import pytest
import torch

from ionotomo_tpu_torch.config import (EngineConfig, GridConfig, PriorConfig,
                                       RayConfig, RuntimeConfig, SolverConfig)
from ionotomo_tpu_torch.data import synth
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import (empirical_bayes, kalman,
                                          model_selection, profile, solvers)
from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
from ionotomo_tpu_torch.parallel import sharding as sm

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8

#: mode → (the solver entries its call sites hand a bundle to, solver
#: settings, prior settings, timesteps, anchors)
MODES = {
    "estimate_profile": ((profile, "map_gauss_newton_profile"),
                         dict(gn_iters=1, cg_iters=3, estimate_profile=True),
                         {}, 1, True),
    "gcv": ((model_selection, "select_prior"),
            dict(gn_iters=1, cg_iters=3), dict(auto_select="gcv"), 1, False),
    "evidence": ((empirical_bayes, "fit_hyperparameters"),
                 dict(gn_iters=1, cg_iters=4),
                 dict(auto_select="evidence", fit_noise=True), 1, False),
    "posterior": ((solvers, "posterior_samples"),
                  dict(gn_iters=1, cg_iters=4, posterior_samples=5), {}, 1,
                  False),
    "kalman_events": ((empirical_bayes, "log_marginal_family"),
                      (kalman, "update_operator_eigs"),
                      dict(solver="kalman", cg_iters=4, kalman_chunk=1,
                           noise_adapt_every=1, diag_spectrum_every=1,
                           diag_spectrum_rank=4), {}, 2, False),
    "batched": ((solvers, "map_gauss_newton_batched"),
                dict(solver="batched_gn", gn_iters=1, cg_iters=4), {}, 2,
                False),
}


@pytest.fixture(scope="module")
def world():
    dp, truth = synth.generate_example_datapack(
        n_antennas=7, n_directions=5, n_times=2, grid_shape=(12, 12, 12),
        n_samples=17, mjd0=58000.45, device="cpu")
    dp.wind_kmps = truth["wind_kmps"]
    return dp, truth


def config(root, name, solver, prior):
    return EngineConfig(
        grid=GridConfig(shape=(12, 12, 12)), rays=RayConfig(n_samples=17),
        solver=SolverConfig(**solver), prior=PriorConfig(**prior),
        runtime=RuntimeConfig(checkpoint_dir=os.path.join(root, name, "c"),
                              metrics_path=os.path.join(root, name,
                                                        "m.jsonl")))


def run_mode(root, mode, world, mesh):
    """(the Solution, the pipeline, the calls of the mode's solver entries:
    (name, the bundle handed in, args, kwargs, the result), recorded by
    ``chip_smoke.recorded_calls``). Without a mesh the pipeline is
    ``chip_smoke.padded_pipeline``'s, on the meshed run's padded rays (8
    antennas of 7), so that both solve the same problem: GCV's row count
    and the evidence's noise determinant count the padded rows."""
    import chip_smoke

    *entries, solver, prior, nt, anchored = MODES[mode]
    dp, truth = world
    sub = dp.select(times=list(range(nt)))
    sub.wind_kmps = dp.wind_kmps
    tag = "mesh" if mesh else "none"
    cls = InversionPipeline if mesh else chip_smoke.padded_pipeline(len(CPU8))
    with chip_smoke.recorded_calls(entries) as calls:
        pipe = cls(sub, config(root, f"{mode}_{tag}", solver, prior),
                   device="cpu", mesh=mesh)
        anchors = (chip_smoke.slant_truth_anchors(torch.device("cpu"), pipe,
                                                  truth)
                   if anchored else None)
        sol = pipe.run(resume=False, anchors=anchors)
    return sol, pipe, calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory, world):
    root = str(tmp_path_factory.mktemp("pipeline_mesh"))
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = (run_mode(root, mode, world, sm.ray_mesh(CPU8)),
                           run_mode(root, mode, world, None))
        return cache[mode]
    return get


def events(pipe, kind):
    return [r for r in pipe.metrics.read_all() if r.get("event") == kind]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_each_call_site_hands_its_solver_a_sharded_bundle(runs, mode):
    """Under the mesh each call site's solver takes a ``ShardedRayBundle``
    of whole padded antennas (8 of 7), 8 shards; without it a
    ``RayBundle``."""
    (_, pipe, calls), (_, _, calls_u) = runs(mode)
    n_entries = len(MODES[mode]) - 4
    assert {c[0] for c in calls} == {c[0] for c in calls_u}
    assert len({c[0] for c in calls}) == n_entries and calls
    for name, rb, *_ in calls:
        assert isinstance(rb, sm.ShardedRayBundle), name
        assert len(rb.shards) == 8
        assert rb.ray_axis == (1 if mode == "batched" else 0)
        assert rb.num_rays == 8 * 5
        assert all(b.points.shape[rb.ray_axis] == 5 for b in rb.shards)
    assert all(isinstance(rb, trays.RayBundle) for _, rb, *_ in calls_u)
    assert len(events(pipe, "ray_sharding_padded")) == 1


@pytest.mark.parametrize("mode", list(MODES))
def test_each_mode_matches_the_meshless_port(runs, mode):
    (sol, pipe, calls), (sol_u, pipe_u, calls_u) = runs(mode)
    prior = pipe_u._m_prior0.numpy()
    delta = np.abs(sol_u.m - prior).max()
    assert np.isfinite(sol.m).all() and delta > 0
    assert np.abs(sol.m - sol_u.m).max() < 1e-2 * delta
    if mode == "estimate_profile":
        (ev,), (ev_u,) = (events(p, "profile_estimated")
                          for p in (pipe, pipe_u))
        for k in ("residual", "n_peak", "h_peak_km", "scale_km"):
            assert abs(ev[k] - ev_u[k]) <= 1e-3 * abs(ev_u[k]), k
    elif mode == "gcv":
        (*_, (_, params, scores)), = calls
        (*_, (_, params_u, scores_u)), = calls_u
        assert params == params_u
        assert rel(scores, scores_u) < 1e-3
        assert np.argmin(scores) == np.argmin(scores_u)
    elif mode == "evidence":
        assert len(calls) == len(calls_u) == 2          # one a kernel kind
        for (*_, fit), (*_, fit_u) in zip(calls, calls_u):
            assert fit[:3] == fit_u[:3]                 # σ*, L*, ρ*
            assert rel(fit[3], fit_u[3]) < 1e-3         # the table
        (ev,), (ev_u,) = (events(p, "prior_auto_selected")
                          for p in (pipe, pipe_u))
        assert ev["chosen"] == ev_u["chosen"]
    elif mode == "posterior":
        std, std_u = (s.diagnostics["std_seq"] for s in (sol, sol_u))
        assert np.abs(std - std_u).max() < 1e-3 * np.abs(std_u).max()
        assert rel(calls[0][-1][1], calls_u[0][-1][1]) < 1e-3  # the mean
    elif mode == "kalman_events":
        for kind, key in (("noise_adapted", "rho"),
                          ("update_spectrum", "lam")):
            got, want = events(pipe, kind), events(pipe_u, kind)
            assert len(got) == len(want) >= 1, kind
            for a, b in zip(got, want):
                assert rel(a[key], b[key]) < 1e-3, kind
        assert events(pipe, "noise_adapted")[0]["rho"] \
            == events(pipe_u, "noise_adapted")[0]["rho"]
    elif mode == "batched":
        res, res_u = (s.diagnostics["residuals"] for s in (sol, sol_u))
        assert rel(res, res_u) < 1e-3


@pytest.mark.parametrize("b", [5, 128])
def test_sharded_operator_with_a_member_axis(b):
    """J and Jᵀ of ``ShardedPairedDtecLinear`` with a leading member axis
    of B = 5 (GCV's residual and 4 probes) and B = 128 (the evidence's
    identity columns a batch), 35 rays padded to 40 over 8 shards: each
    member within 3e-6 of the unsharded operator on the same padded
    bundle (the reference's operator bound)."""
    na, nd, na_p = 7, 5, 8
    grid, m, rb = _padded_world(na, nd, na_p)
    op = ttec.dtec_paired_linear(m, grid, sm.shard_rays(
        sm.ray_mesh(CPU8), rb), nd, 0, "hermite", "cubic")
    ref = ttec.dtec_paired_linear(m, grid, rb, nd, 0, "hermite", "cubic")
    g = torch.Generator().manual_seed(b)
    v = torch.randn((b,) + tuple(grid.shape), generator=g)
    w = torch.randn((b, na_p * nd), generator=g)
    w[:, na * nd:] = 0.0                         # padded rays weigh nothing
    j, jt = op.apply(v), op.apply_t(w)
    j_u, jt_u = ref.apply(v), ref.apply_t(w)
    assert j.shape == (b, na_p * nd) and jt.shape == v.shape
    for k in range(b):
        torch.testing.assert_close(j[k], j_u[k], rtol=3e-6,
                                   atol=3e-6 * float(j_u.abs().max()))
        torch.testing.assert_close(jt[k], jt_u[k], rtol=3e-6,
                                   atol=3e-6 * float(jt_u.abs().max()))
    # a member of the batch is the one-member operator's
    torch.testing.assert_close(op.apply(v[1]), j[1], rtol=3e-6,
                               atol=3e-6 * float(j_u.abs().max()))


def _padded_world(na, nd, na_p):
    """A 12³ Chapman world and an (antenna × direction) straight bundle,
    its last antenna repeated to ``na_p``."""
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.models import chapman

    grid = Grid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                              (12, 12, 12), device="cpu")
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    rng = np.random.default_rng(5)
    ants = np.concatenate([rng.uniform(-40, 40, (na, 2)),
                           np.zeros((na, 1))], -1).astype(np.float32)
    ants = np.concatenate([ants, np.repeat(ants[-1:], na_p - na, 0)])
    zen = rng.uniform(0.05, 0.4, nd)
    az = rng.uniform(0, 2 * np.pi, nd)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    o, d = trays.make_ray_batch(torch.from_numpy(ants),
                                torch.from_numpy(dirs))
    return grid, m, trays.sample_straight_rays(o, d, max_length_km=800.0,
                                               n_samples=17)
