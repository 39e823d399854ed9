"""Parity of the port's batch inversion pipeline (``InversionPipeline``)
with the JAX package's, mode by mode, on ``tests/test_pipeline.py``'s
world (``make_dp``: 8 antennas × 5 directions, 14³, 33 samples, daytime)
at gn 2 and cg 4. (At 1e-3 TECU noise this world's systems amplify f32
rounding past cg 4: at cg 6 the two packages' snapshot solves part by
0.3 % in held-out rms and 0.2 % in residual, measured; at cg 3-4 they
agree to ~5e-6.) Both pipelines read the same DataPack and the same
config JSON; where the reference draws from its PRNG keys (beam noise,
posterior draws, the ensemble, the spectrum's start block, the GCV
probes), ``JaxDraws`` feeds the port the JAX package's own draws through
the pipeline's ``draw_normals``/``draw_signs``.

Compared (ROADMAP.md: solvers and filters by residual and held-out rms):
each timestep's held-out dTEC rms (the truth's dTEC over the 8 antennas
toward 2 other directions, through the port's Hermite forward) within
``HELDOUT_TOL`` relative, and each solve's reported residual within
``RES_TOL`` relative. Kill and resume must be bitwise in the port; a
checkpoint of either package resumes in the other. Each JAX pipeline runs
in one test, so that one process runs it.
"""
import dataclasses
import functools
import json
import shutil
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionotomo_tpu.inversion import pipeline as jpipeline
from ionotomo_tpu.utils import checkpoint as jckpt
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.config import EngineConfig as TEngineConfig
from ionotomo_tpu_torch.config import resumable
from ionotomo_tpu_torch.data import synth as tsynth
from ionotomo_tpu_torch.data.datapack import DataPack as TDataPack
from ionotomo_tpu_torch.data.radio_array import RadioArray as TRadioArray
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import anchors as tanch
from ionotomo_tpu_torch.inversion import pipeline as tpipeline
from ionotomo_tpu_torch.inversion.model_selection import DRAW_GCV
from ionotomo_tpu_torch.utils import draws

from tests.test_pipeline import make_dp, small_config

torch.set_num_threads(2)

CG = 4
RES_TOL = 1e-3       # relative, each reported residual
HELDOUT_TOL = 1e-3   # relative, each timestep's held-out dTEC rms


class JaxDraws(tpipeline.InversionPipeline):
    """The port's pipeline fed the reference's draws, keyed as
    ``ionotomo_tpu.inversion.pipeline`` and ``kalman`` key them."""

    def draw_normals(self, use, index, shape):
        key = jax.random.key(self.config.runtime.seed)
        normal = jax.random.normal
        if use == tpipeline.DRAW_BEAM:
            x = normal(jax.random.fold_in(key, 9000017 + index), shape)
        elif use in (tpipeline.DRAW_POSTERIOR_DATA,
                     tpipeline.DRAW_POSTERIOR_PRIOR):
            k = jax.random.split(jax.random.fold_in(key, 1000003 + index))
            x = normal(k[use - tpipeline.DRAW_POSTERIOR_DATA], shape)
        elif use == draws.DRAW_SPECTRUM:
            x = normal(jax.random.key(index), shape)
        elif use == draws.DRAW_ENKF_INIT:
            ks = jax.random.split(jax.random.fold_in(key, 0x7FFFFFFF),
                                  shape[0])
            x = jnp.stack([normal(k, shape[1:]) for k in ks])
        elif use == draws.DRAW_ENKF_OBS:
            x = normal(jax.random.split(jax.random.fold_in(key, index))[1],
                       shape)
        elif use == draws.DRAW_ENKF_PROCESS:
            ks = jax.random.split(
                jax.random.split(jax.random.fold_in(key, index))[0],
                shape[0])
            x = jnp.stack([normal(k, shape[1:]) for k in ks])
        else:
            raise AssertionError(f"no JAX draw for use {use}")
        return torch.from_numpy(np.array(x, np.float32))

    def draw_signs(self, use, index, shape):
        assert use == DRAW_GCV
        key = jax.random.key(self.config.runtime.seed)
        return torch.from_numpy(np.array(
            jax.random.rademacher(key, shape).astype(jnp.float32)))


def one_device_jax_pipeline(jdp, jc):
    """The JAX package's pipeline on one device: ``tests/conftest.py``
    gives JAX 8 virtual CPU devices, on which the reference shards rays
    over a mesh (and its ``lsqr_smoothness`` mode fails to trace there:
    "This reshape is not supported", a reshape of the ray-sharded data
    vector to the grid); the port is the single-device pipeline."""
    one = jax.devices()[:1]
    with mock.patch.object(jpipeline.jax, "devices", lambda *a: one):
        return jpipeline.InversionPipeline(jdp, jc)


def port_datapack(jdp) -> TDataPack:
    """The port's DataPack holding the JAX package's arrays."""
    dp = TDataPack(TRadioArray(jdp.array.itrs, labels=jdp.array.labels,
                               name=jdp.array.name),
                   jdp.directions, jdp.times, dtec=jdp.dtec.copy(),
                   flags=jdp.flags.copy(), noise_std=jdp.noise_std.copy(),
                   ref_antenna=jdp.ref_antenna,
                   frequency_hz=jdp.frequency_hz,
                   frame_model=jdp.frame_model)
    if getattr(jdp, "wind_kmps", None) is not None:
        dp.wind_kmps = jdp.wind_kmps
    return dp


@functools.lru_cache(maxsize=None)
def world(n_times):
    """make_dp's DataPack and truth, and the held-out rays of each
    timestep with the truth's dTEC over them (port tensors)."""
    jdp, truth = make_dp(n_times=n_times)
    tdp = port_datapack(jdp)
    pc = tsynth.zenith_phase_center(tdp.array, tdp.times.mean())
    ho = TDataPack(tdp.array, tsynth.choose_directions(pc, 2, seed=99),
                   tdp.times)
    ants = torch.from_numpy(tdp.antennas_enu().astype(np.float32))
    dirs = torch.from_numpy(ho.directions_enu().astype(np.float32))
    tgrid = convert.grid_from_numpy(truth["grid"], device="cpu")
    bundles, want = [], []
    for t in range(n_times):
        o, d = trays.make_ray_batch(ants, dirs[t])
        rb = trays.sample_straight_rays(o, d, n_samples=33)
        bundles.append(rb)
        want.append(ttec.dtec_paired_q(torch.from_numpy(truth["m"][t]),
                                       tgrid, rb, 2, 0, "hermite"))
    return jdp, truth, (bundles, want)


def heldout(sol, grid, n_times):
    bundles, want = world(n_times)[2]
    out = []
    for t in range(sol.m.shape[0]):
        pred = ttec.dtec_paired_q(torch.from_numpy(np.array(sol.m[t])),
                                  grid, bundles[t], 2, 0, "hermite")
        out.append(float(torch.sqrt(torch.mean((pred - want[t]) ** 2))))
    return np.asarray(out)


def configs(tmp_path, rays=None, prior=None, runtime=None, **solver):
    """The JAX config (``small_config`` at gn 2, cg 4) and the port's from
    its JSON, each with its own checkpoint and metrics paths."""
    out = []
    for side in ("jax", "port"):
        c = small_config(tmp_path / side, **{"cg_iters": CG, **solver})
        c = dataclasses.replace(
            c, rays=dataclasses.replace(c.rays, **(rays or {})),
            prior=dataclasses.replace(c.prior, **(prior or {})),
            runtime=dataclasses.replace(c.runtime, **(runtime or {})))
        out.append(c)
    return out[0], TEngineConfig.from_json(out[1].to_json())


def run_both(tmp_path, n_times=2, anchors=None, run_kw=None, **cfg_kw):
    """Both pipelines over make_dp(n_times) under one config; returns
    (JAX Solution, port Solution, JAX pipeline, port pipeline)."""
    jdp = world(n_times)[0]
    jc, tc = configs(tmp_path, **cfg_kw)
    jpipe = one_device_jax_pipeline(jdp, jc)
    tpipe = JaxDraws(port_datapack(jdp), tc, device="cpu")
    ja = ta = None
    if anchors is not None:
        ja, ta = anchors(jpipe, tpipe, world(n_times)[1])
    kw = dict(run_kw or {})
    jsol = jpipe.run(resume=False, anchors=ja, **kw)
    tsol = tpipe.run(resume=False, anchors=ta, **kw)
    return jsol, tsol, jpipe, tpipe


def residuals(pipe, key="residual"):
    return np.asarray([r[key] for r in pipe.metrics.read_all()
                       if key in r and "event" not in r], np.float64)


def assert_parity(jsol, tsol, tpipe, n_times, res=None,
                  heldout_tol=HELDOUT_TOL, res_tol=RES_TOL):
    """Held-out rms per timestep and the residuals (pairs of arrays)."""
    assert tsol.m.shape == jsol.m.shape
    assert np.isfinite(tsol.m).all()
    hj = heldout(jsol, tpipe.grid, n_times)
    ht = heldout(tsol, tpipe.grid, n_times)
    np.testing.assert_allclose(ht, hj, rtol=heldout_tol)
    prior = tpipe._m_prior0.numpy()
    hp = heldout(type(tsol)(tpipe.grid, np.broadcast_to(
        prior, tsol.m.shape)), tpipe.grid, n_times)
    assert np.all(hj < hp)
    for jr, tr in res or []:
        np.testing.assert_allclose(np.asarray(tr), np.asarray(jr),
                                   rtol=res_tol)


# --- the snapshot modes ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def snapshot_runs():
    """The default mode over 2 timesteps, checkpointing every timestep:
    the run the cross-package resume tests start from (in a temporary
    directory of its own, kept for the process)."""
    return run_both(Path(tempfile.mkdtemp(prefix="snapshot_runs")))


def test_snapshot_gn_matches_jax():
    jsol, tsol, jpipe, tpipe = snapshot_runs()
    assert_parity(jsol, tsol, tpipe, 2,
                  [(residuals(jpipe), residuals(tpipe))])
    jr = [r for r in jpipe.metrics.read_all()]
    tr = [r for r in tpipe.metrics.read_all()]
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    assert [(r["timestep"], r["rays"], r["retraces"]) for r in tr] \
        == [(r["timestep"], r["rays"], r["retraces"]) for r in jr]


@pytest.mark.parametrize("mode", ["robust_gn", "steepest", "lsqr_smoothness"])
def test_snapshot_solver_matches_jax(tmp_path, mode):
    """One timestep of each other snapshot solver (robust IRLS: 3 rounds
    at the default Huber threshold; steepest: 16 descent steps; LSQR at
    6 iterations: on this world the two packages' f32 LSQR agree to 3e-6
    at 6 and part by 9 % in residual at 10, measured)."""
    jsol, tsol, jpipe, tpipe = run_both(tmp_path, n_times=1, solver=mode,
                                        lsqr_iters=6)
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])


def test_batched_gn_matches_jax(tmp_path):
    jsol, tsol, jpipe, tpipe = run_both(tmp_path, solver="batched_gn")
    assert_parity(jsol, tsol, tpipe, 2,
                  [(jsol.diagnostics["residuals"],
                    tsol.diagnostics["residuals"])])
    names = sorted(p.name for p in (tmp_path / "port" / "ckpt").iterdir())
    assert names == ["ckpt_00000002.npz"]       # one checkpoint, at the end


def test_posterior_std_matches_jax(tmp_path):
    """4 RTO draws at timestep 0, JAX's own: the std field within 1e-2
    rms relative."""
    jsol, tsol, jpipe, tpipe = run_both(tmp_path, n_times=1,
                                        posterior_samples=4)
    assert_parity(jsol, tsol, tpipe, 1)
    js, ts = jsol.diagnostics["std_seq"], tsol.diagnostics["std_seq"]
    assert np.sqrt(np.mean((ts - js) ** 2)) <= 1e-2 * np.sqrt(np.mean(js**2))
    np.testing.assert_allclose(residuals(tpipe, "posterior_std_mean"),
                               residuals(jpipe, "posterior_std_mean"),
                               rtol=1e-2)


def test_beam_noise_matches_jax(tmp_path):
    """A 4-path beam at timestep 0 (16 steps), JAX's jitter: the logged
    spread within 1e-3 relative, then the solve as the others."""
    jsol, tsol, jpipe, tpipe = run_both(tmp_path, n_times=1,
                                        rays=dict(beam_noise=4, n_steps=16))
    beams = [[(r["mean"], r["max"]) for r in p.metrics.read_all()
              if r.get("event") == "beam_noise"] for p in (jpipe, tpipe)]
    assert len(beams[1]) == 1
    np.testing.assert_allclose(beams[1], beams[0], rtol=1e-3)
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])


def test_bent_retrace_matches_jax(tmp_path):
    """Bent rays (leapfrog@16) re-traced through the iterate after each
    Gauss-Newton step: the same retrace count, residual and held-out rms
    as the other modes."""
    jsol, tsol, jpipe, tpipe = run_both(
        tmp_path, n_times=1, rays=dict(bent=True, retrace_every=1,
                                       n_steps=16))
    assert residuals(tpipe, "retraces").tolist() \
        == residuals(jpipe, "retraces").tolist() == [1.0]
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])


def vertical_anchors(jpipe, tpipe, truth):
    """2 × 2 vertical absolute-TEC columns of the truth (17 samples),
    noise 10 working units, in both packages."""
    from ionotomo_tpu.forward import tec as jtec
    from ionotomo_tpu.inversion import anchors as janch
    jb = janch.vertical_anchor_bundle(jpipe.grid, nx=2, ny=2, n_samples=17)
    v = jtec.tec(jnp.asarray(truth["m"][0]), truth["grid"], jb)
    ja = janch.TecAnchors(rays=jb, values=v, noise_std=jnp.float32(10.0))
    tb = tanch.vertical_anchor_bundle(tpipe.grid, nx=2, ny=2, n_samples=17)
    assert np.array_equal(tb.points.numpy(), np.asarray(jb.points))
    ta = tanch.TecAnchors(rays=tb, values=torch.from_numpy(np.array(v)),
                          noise_std=torch.tensor(10.0))
    return ja, ta


@pytest.mark.parametrize("anchor_mode", ["sequential", "joint"])
def test_anchored_run_matches_jax(tmp_path, anchor_mode):
    jsol, tsol, jpipe, tpipe = run_both(
        tmp_path, n_times=1, anchors=vertical_anchors,
        run_kw=dict(anchor_mode=anchor_mode))
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])
    if anchor_mode == "sequential":
        d = tpipe.m_prior.numpy() - jpipe.m_prior
        assert np.sqrt(np.mean(d ** 2)) <= 1e-3 * np.sqrt(np.mean(
            (np.asarray(jpipe.m_prior) - tpipe._m_prior0.numpy()) ** 2))


def slant_anchors(jpipe, tpipe, truth):
    """3 receivers × 5 elevations of slant absolute TEC of the truth."""
    from ionotomo_tpu.forward import tec as jtec
    from ionotomo_tpu.inversion import anchors as janch
    rng = np.random.default_rng(1)
    xy = np.repeat(np.array([[-30.0, -20.0], [10.0, 30.0], [25.0, -15.0]]),
                   5, axis=0)
    el = np.tile(np.deg2rad([15.0, 25.0, 40.0, 60.0, 75.0]), 3)
    az = rng.uniform(0, 2 * np.pi, 15)
    jb = janch.slant_bundle(jpipe.grid, xy, az, el, n_samples=33)
    v = jtec.tec(jnp.asarray(truth["m"][0]), truth["grid"], jb)
    noise = float(0.005 * jnp.mean(v))
    ja = janch.TecAnchors(rays=jb, values=v, noise_std=jnp.float32(noise))
    tb = tanch.slant_bundle(tpipe.grid, xy, az, el, n_samples=33)
    ta = tanch.TecAnchors(rays=tb, values=torch.from_numpy(np.array(v)),
                          noise_std=torch.tensor(np.float32(noise)))
    return ja, ta


def test_estimate_profile_matches_jax(tmp_path):
    """The joint (θ, δm) profile solve at set-up (4 GN steps at cg 3,
    where that system's f32 CG still agrees between the packages,
    ``tests/test_torch_model_selection_eb_profile.py``), then the solve:
    θ̂ within 1e-3 relative, the profile residual within 1e-3."""
    jsol, tsol, jpipe, tpipe = run_both(
        tmp_path, n_times=1, anchors=slant_anchors, estimate_profile=True,
        cg_iters=3)
    ev = [[r for r in p.metrics.read_all()
           if r.get("event") == "profile_estimated"][0]
          for p in (jpipe, tpipe)]
    for k in ("residual", "n_peak", "h_peak_km", "scale_km"):
        assert abs(ev[1][k] - ev[0][k]) <= 1e-3 * abs(ev[0][k]), k
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])


def every_ninth_candidate(module):
    """Replace ``module.select_prior`` by a wrapper that records the
    candidates the pipeline builds and scores every ninth (one of each
    kernel family): the JAX package compiles its GCV program once per
    candidate (the covariance's hyperparameters are static), ~3 s each."""
    seen = []
    inner = module.select_prior

    def wrapper(grid, rays, d_obs, noise_std, m0, candidates, *a, **kw):
        seen.append(list(candidates))
        return inner(grid, rays, d_obs, noise_std, m0, candidates[::9],
                     *a, **kw)
    return mock.patch.object(module, "select_prior", wrapper), seen


@pytest.mark.parametrize("method", ["gcv", "evidence"])
def test_auto_select_prior_matches_jax(tmp_path, method):
    """The same winner among the GCV candidates (JAX's probes; both
    pipelines build the same 27 and score 3, see
    ``every_ninth_candidate``) or on the evidence grid, its score within
    1e-3 relative, then the solve."""
    from ionotomo_tpu.inversion import model_selection as jms
    from ionotomo_tpu_torch.inversion import model_selection as tms
    (jpatch, jseen), (tpatch, tseen) = map(every_ninth_candidate,
                                           (jms, tms))
    with jpatch, tpatch:
        jsol, tsol, jpipe, tpipe = run_both(
            tmp_path, n_times=1, prior=dict(auto_select=method))
    if method == "gcv":
        assert len(tseen[0]) == 27 and tseen == jseen
    ev = [[r for r in p.metrics.read_all()
           if r.get("event") == "prior_auto_selected"][0]
          for p in (jpipe, tpipe)]
    assert ev[1]["chosen"] == ev[0]["chosen"]
    key = "best_score" if method == "gcv" else "log_evidence"
    assert abs(ev[1][key] - ev[0][key]) <= 1e-3 * abs(ev[0][key])
    assert_parity(jsol, tsol, tpipe, 1,
                  [(residuals(jpipe), residuals(tpipe))])


# --- the filters -----------------------------------------------------------

def test_kalman_with_options_matches_jax(tmp_path):
    """The point filter over 4 timesteps in chunks of 2, the wind
    estimated from two snapshot solves (no wind on the DataPack),
    the rigid + shear state adapted online, R adapted at the chunk
    boundary and the spectrum logged at both: the estimated wind within
    1e-3 km/s, the noise scale's pick and the top eigenvalues within
    1e-2 relative, the filter's residuals and held-out rms as the
    snapshot modes."""
    jsol, tsol, jpipe, tpipe = run_both(
        tmp_path, n_times=4, solver="kalman", kalman_chunk=2,
        wind_shear=True, wind_adapt_iters=1, noise_adapt_every=1,
        diag_spectrum_every=1, diag_spectrum_rank=4)

    def events(p, name):
        return [r for r in p.metrics.read_all() if r.get("event") == name]
    jw, tw = (events(p, "wind_estimated") for p in (jpipe, tpipe))
    np.testing.assert_allclose(tw[0]["wind_kmps"], jw[0]["wind_kmps"],
                               atol=1e-3)
    jn, tn = (events(p, "noise_adapted") for p in (jpipe, tpipe))
    assert [r["rho"] for r in tn] == [r["rho"] for r in jn] and len(tn) == 1
    js, ts = (events(p, "update_spectrum") for p in (jpipe, tpipe))
    assert len(ts) == 2
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b["lam"][:2], a["lam"][:2], rtol=1e-2)
    assert_parity(jsol, tsol, tpipe, 4, [
        (jsol.diagnostics[k], tsol.diagnostics[k])
        for k in ("pre_residuals", "post_residuals")])


def test_enkf_chunked_matches_jax(tmp_path):
    """4 members over 3 timesteps in chunks of 2, with the reference's
    draws: the mean's held-out rms, the pre-update residuals and the
    spread within 1e-2 relative (rms)."""
    jsol, tsol, jpipe, tpipe = run_both(
        tmp_path, n_times=3, solver="enkf", kalman_chunk=2,
        enkf_members=4)
    assert_parity(jsol, tsol, tpipe, 3, [
        (jsol.diagnostics["pre_residuals"],
         tsol.diagnostics["pre_residuals"])])
    js, ts = jsol.diagnostics["std_seq"], tsol.diagnostics["std_seq"]
    assert np.sqrt(np.mean((ts - js) ** 2)) <= 1e-2 * np.sqrt(np.mean(js**2))


# --- checkpoints -----------------------------------------------------------

def port_pipe(tmp_path, n_times, **solver):
    jdp = world(n_times)[0]
    tc = configs(tmp_path, **solver)[1]
    return tpipeline.InversionPipeline(port_datapack(jdp), tc, device="cpu")


@pytest.mark.parametrize("mode", [
    dict(),
    dict(solver="kalman", kalman_chunk=1),
    dict(solver="enkf", kalman_chunk=1, enkf_members=3)])
def test_kill_and_resume_is_bitwise(tmp_path, mode):
    """The run killed after its first checkpoint and resumed by a new
    pipeline gives the uninterrupted run's Solution bit for bit (the
    checkpoint is the one the uninterrupted run wrote)."""
    full = port_pipe(tmp_path / "a", 3, **mode)
    sol = full.run(resume=False)
    ck = full.config.runtime.checkpoint_dir
    killed = tmp_path / "b" / "ckpt"
    killed.mkdir(parents=True)
    shutil.copy(f"{ck}/ckpt_00000001.npz", killed)
    again = port_pipe(tmp_path / "b", 3, **mode)
    sol2 = again.run(resume=True)
    assert np.array_equal(sol2.m, sol.m)
    for k in sol.diagnostics:
        assert np.array_equal(sol2.diagnostics[k], sol.diagnostics[k]), k


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX run's checkpoint after timestep 0, read by
    ``convert.pipeline_checkpoint_from_numpy``: timestep 0 is the JAX
    field bit for bit, timestep 1 solved by the port from it matches the
    JAX run's as the snapshot parity test states."""
    jsol, tsol, jpipe, tpipe = snapshot_runs()
    step, state, cfg = jckpt.load_checkpoint(
        f"{jpipe.config.runtime.checkpoint_dir}/ckpt_00000001.npz")
    state = convert.pipeline_checkpoint_from_numpy(state)
    assert step == 1 and state["m_seq"].dtype == np.float32
    pipe = port_pipe(tmp_path, 2)
    from ionotomo_tpu_torch.utils import checkpoint as tckpt
    tckpt.save_checkpoint(pipe.config.runtime.checkpoint_dir, step, state,
                          cfg)
    sol = pipe.run(resume=True)
    assert np.array_equal(sol.m[0], np.asarray(jsol.m[0]))
    assert_parity(jsol, sol, pipe, 2)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    """And the other way: the JAX pipeline continues from the port's
    checkpoint after timestep 0."""
    jsol, tsol, jpipe, tpipe = snapshot_runs()
    jdp = world(2)[0]
    jc = configs(tmp_path)[0]
    ck = tmp_path / "jax" / "ckpt"
    ck.mkdir(parents=True)
    shutil.copy(f"{tpipe.config.runtime.checkpoint_dir}/ckpt_00000001.npz",
                ck)
    sol = one_device_jax_pipeline(jdp, jc).run(resume=True)
    assert np.array_equal(np.asarray(sol.m[0]), tsol.m[0])
    assert_parity(sol, tsol, tpipe, 2)


def test_mismatched_checkpoint_is_refused_runtime_change_accepted(tmp_path):
    """A checkpoint whose config differs only in runtime fields (the
    metrics path, the checkpoint cadence) is resumed; one of another prior
    is ignored (the event is logged and the run starts from timestep 0);
    a config JSON of an older schema (a field missing) still matches."""
    a = port_pipe(tmp_path / "a", 2)
    sol = a.run(resume=False)
    rt = a.config.runtime
    moved = dataclasses.replace(a.config, runtime=dataclasses.replace(
        rt, metrics_path=str(tmp_path / "moved.jsonl"), checkpoint_every=2))
    b = tpipeline.InversionPipeline(port_datapack(world(2)[0]), moved,
                                    device="cpu")
    assert np.array_equal(b.run(resume=True).m, sol.m)
    assert not b.metrics.read_all()              # nothing left to solve
    other = configs(tmp_path / "o", prior=dict(sigma=0.5))[1]
    other = dataclasses.replace(other, runtime=dataclasses.replace(
        rt, metrics_path=str(tmp_path / "other.jsonl")))
    c = tpipeline.InversionPipeline(port_datapack(world(2)[0]), other,
                                    device="cpu")
    c.run(resume=True)
    recs = c.metrics.read_all()
    assert recs[0]["event"] == "checkpoint_config_mismatch"
    assert recs[0]["step"] == 2
    assert [r["timestep"] for r in recs[1:]] == [0, 1]
    assert not resumable(a.config, other.to_json())
    assert not resumable(a.config, "{not json")
    cfg = json.loads(a.config.to_json())
    del cfg["solver"]["diag_spectrum_rank"]      # an older schema
    assert resumable(a.config, json.dumps(cfg))


def test_enkf_member_sharding_raises(tmp_path):
    pipe = port_pipe(tmp_path, 2, solver="enkf", enkf_shard="members")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        pipe.run(resume=False)


def test_profile_dir_captures_a_trace(tmp_path):
    """runtime.profile_dir: the run writes a torch.profiler trace there."""
    jdp = world(1)[0]
    tc = configs(tmp_path, runtime=dict(
        profile_dir=str(tmp_path / "trace")))[1]
    sol = tpipeline.InversionPipeline(port_datapack(jdp), tc,
                                      device="cpu").run(resume=False)
    assert np.isfinite(sol.m).all()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
