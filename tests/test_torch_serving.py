"""``ionotomo_tpu_torch.serving.EpochService`` on the CPU: every contract of
``tests/test_serving.py`` held on the port, parity with the JAX service,
a JAX service's state continued by the port, and the ``serve`` CLI.

Epoch files come from the port's ``data.synth`` (6 antennas × 4
directions, 17 samples, 12³ truth) with the reference's turbulence white
noise fed in, so they are ``tests/test_serving.py``'s worlds, and the
services run at 14³ with cg 8, as that file's do. Services that draw (the ensemble
filter, adaptive R, beam noise) are held to their restart identity and
their own checks, not to the JAX service: the port draws from CPU
generators keyed by the epoch index, the reference from its PRNG keys.

One JAX service runs in this file (a module-scoped fixture): the point
filter over three epochs, its state kept after the second. The port's
service on the same files gives each epoch's field within 1e-2 of the
update's L2 size (the filter tolerance of ``test_torch_kalman.py``, the
update measured from the prior), residuals within 1e-3 relative, and
JSONL records with the same keys, events, files and epochs.
"""
import dataclasses
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu_torch.config import (EngineConfig, GridConfig,
                                       PhysicsConfig, PriorConfig, RayConfig,
                                       SolverConfig)
from ionotomo_tpu_torch.data import ionosonde as iono
from ionotomo_tpu_torch.data.synth import generate_example_datapack
from ionotomo_tpu_torch.inversion.solution import Solution
from ionotomo_tpu_torch.models import chapman
from ionotomo_tpu_torch.serving import EpochService

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _white(seed):
    """The turbulence white noise the reference's synth draws for
    ``seed`` (``normal(key(seed + 2))``), so the epoch files are
    ``tests/test_serving.py``'s worlds."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed + 2), (12, 12, 12), jnp.float32)))


def _pack(mjd, nt=1, seed=0):
    dp, _ = generate_example_datapack(
        n_antennas=6, n_directions=4, n_times=nt, mjd0=mjd,
        grid_shape=(12, 12, 12), seed=seed, n_samples=17,
        white=_white(seed), device="cpu")
    return dp


def _epoch_files(directory, n_files, nt_each=1, seed=0, start=0):
    paths = []
    for i in range(start, start + n_files):
        dp = _pack(58000.45 + i * nt_each * 30.0 / 86400.0, nt_each, seed)
        p = os.path.join(directory, f"epoch_{i:03d}.h5")
        dp.save(p)
        paths.append(p)
    return paths


def _one(directory, name, mjd, seed=0):
    dp = _pack(mjd, seed=seed)
    dp.save(os.path.join(directory, name))
    return dp


def _cfg(**solver):
    return EngineConfig(
        grid=GridConfig(shape=(14, 14, 14)),
        rays=RayConfig(n_samples=17),
        prior=PriorConfig(kind="sqexp", length_scale_km=90.0),
        solver=SolverConfig(solver="kalman", cg_iters=8, **solver))


def service(watch, out, cfg=None, **kw):
    return EpochService(str(watch), str(out), cfg or _cfg(), device="cpu",
                        **kw)


def load(out, i):
    return Solution.load(pathlib.Path(out) / f"epoch_{i:06d}.h5",
                         device="cpu")


def records(out):
    return [json.loads(line)
            for line in open(pathlib.Path(out) / "epochs.jsonl")]


def same_epochs(out_a, out_b, n):
    for i in range(n):
        np.testing.assert_array_equal(load(out_a, i).m, load(out_b, i).m)


def test_service_ingests_once_and_restarts_identically(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out_a, out_b = tmp_path / "out_a", tmp_path / "out_b"
    _epoch_files(str(watch), 2, nt_each=2)
    svc = service(watch, out_a)
    assert svc.process_available() == 4
    assert svc.process_available() == 0          # ingest-once
    _epoch_files(str(watch), 1, start=2)         # one more file appears
    assert svc.process_available() == 1
    # interrupted twin: two files, "crash", resume from state.npz
    svc_b = service(watch, out_b)
    os.rename(watch / "epoch_002.h5", tmp_path / "stash.h5")
    assert svc_b.process_available() == 4
    del svc_b
    os.rename(tmp_path / "stash.h5", watch / "epoch_002.h5")
    svc_b2 = service(watch, out_b)
    assert svc_b2.filter.t == 4
    assert svc_b2.process_available() == 1
    for d in (out_a, out_b):
        assert sorted(f for f in os.listdir(d) if f.startswith("epoch_")) \
            == [f"epoch_{i:06d}.h5" for i in range(5)]
    same_epochs(out_a, out_b, 5)
    recs = records(out_a)
    assert [r["epoch"] for r in recs] == list(range(5))
    assert all("pre_residual" in r for r in recs)


def test_service_cadence_config_guard_and_unreadable_files(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    for i in range(2):
        _one(watch, f"e{i}.h5", 58000.45 + i * 10.0 / 86400.0)
    svc = service(watch, out)
    assert svc.process_available() == 2
    assert abs(svc.filter.dt_s - 10.0) < 0.01
    # a partially-written file pauses ingestion; later files wait for it
    (watch / "e2.h5").write_bytes(b"not an hdf5 file")
    dp3 = _one(watch, "e3.h5", 58000.45 + 30.0 / 86400.0)
    assert svc.process_available() == 0
    assert any(r.get("event") == "unreadable" for r in records(out))
    dp3.save(watch / "e2.h5")                    # the producer finishes e2
    assert svc.process_available() == 2
    cfg2 = dataclasses.replace(
        _cfg(), prior=dataclasses.replace(_cfg().prior, sigma=0.9))
    with pytest.raises(ValueError, match="different engine config"):
        service(watch, out, cfg2)
    assert service(watch, out).last_mjd is not None


def test_service_out_of_order_epoch_no_advection_and_restart(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out_a, out_b = tmp_path / "out_a", tmp_path / "out_b"
    _one(watch, "z0.h5", 58000.45, seed=0)
    _one(watch, "z1.h5", 58000.45 - 20.0 / 86400.0, seed=1)
    wind = dict(wind_kmps=(0.5, 0.0, 0.0))
    svc = service(watch, out_a, **wind)
    assert svc.process_available() == 2
    assert svc.filter.dt_s == 0.0          # out of order: no advection
    svc_b = service(watch, out_b, **wind)
    assert svc_b.process_available() == 2
    svc_b2 = service(watch, out_b, **wind)
    assert svc_b2.filter.dt_s == 0.0       # persisted, not reset to 30 s
    _one(watch, "z2.h5", 58000.45 + 40.0 / 86400.0, seed=2)
    assert svc_b2.process_available() == 1
    assert service(watch, out_a, **wind).process_available() == 1
    same_epochs(out_a, out_b, 3)


def test_service_vtec_anchors_from_npz(tmp_path):
    """Anchors built at bootstrap hold the filter's absolute level: the
    VTEC at the anchor columns approaches the anchored values."""
    from ionotomo_tpu_torch.forward import tec as tec_mod
    from ionotomo_tpu_torch.inversion import anchors as anch

    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    _epoch_files(str(watch), 2)
    npz = tmp_path / "vtec.npz"
    np.savez(npz, points_xy=np.array([[-20.0, -20.0], [20.0, 20.0]]),
             values_tecu=np.array([25.0, 26.0]), noise_tecu=np.array(0.2))
    svc = service(watch, out, vtec_anchors_npz=str(npz))
    assert svc.process_available() == 2
    assert svc.filter.anchors is not None
    bundle = anch.columns_bundle(svc.grid, [[-20.0, -20.0], [20.0, 20.0]])
    v = tec_mod.tec(torch.from_numpy(load(out, 1).m[0]), svc.grid, bundle)
    np.testing.assert_allclose(v.numpy(), [25000.0, 26000.0], rtol=0.10)


def test_service_anchor_restart_guard(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    _epoch_files(str(watch), 1)
    npz = tmp_path / "vtec.npz"
    np.savez(npz, points_xy=np.array([[0.0, 0.0]]),
             values_tecu=np.array([30.0]), noise_tecu=np.array(0.5))
    assert service(watch, out, vtec_anchors_npz=str(npz)
                   ).process_available() == 1
    with pytest.raises(ValueError, match="anchors"):
        service(watch, out)                                  # dropped
    np.savez(npz, points_xy=np.array([[5.0, 5.0]]),          # changed
             values_tecu=np.array([30.0]), noise_tecu=np.array(0.5))
    with pytest.raises(ValueError, match="anchors"):
        service(watch, out, vtec_anchors_npz=str(npz))
    np.savez(npz, points_xy=np.array([[5000.0, 0.0]]),       # off the grid
             values_tecu=np.array([30.0]), noise_tecu=np.array(0.5))
    watch2 = tmp_path / "in2"; watch2.mkdir()
    _epoch_files(str(watch2), 1)
    svc3 = service(watch2, tmp_path / "out2", vtec_anchors_npz=str(npz))
    with pytest.raises(ValueError, match="outside the grid"):
        svc3.process_available()


def test_service_time_varying_climatology(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    for i in range(3):
        _one(watch, f"e{i}.h5", 58000.45 + i * 3.0 / 24.0, seed=i)
    base = _cfg()
    solver = dataclasses.replace(base.solver, kalman_fade=0.6)
    cfg_tv = dataclasses.replace(
        base, physics=PhysicsConfig(time_varying_clim=True), solver=solver)
    cfg_st = dataclasses.replace(base, solver=solver)
    out_tv, out_st = tmp_path / "tv", tmp_path / "st"
    assert service(watch, out_tv, cfg_tv).process_available() == 3
    assert service(watch, out_st, cfg_st).process_available() == 3
    assert np.abs(load(out_tv, 2).m - load(out_st, 2).m).max() > 1e-4
    out_b = tmp_path / "tv_b"
    os.rename(watch / "e2.h5", tmp_path / "stash.h5")
    assert service(watch, out_b, cfg_tv).process_available() == 2
    os.rename(tmp_path / "stash.h5", watch / "e2.h5")
    assert service(watch, out_b, cfg_tv).process_available() == 1
    same_epochs(out_tv, out_b, 3)


def test_service_soundings_streaming_and_restart(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out_a, out_b = tmp_path / "out_a", tmp_path / "out_b"
    _epoch_files(str(watch), 2)
    svc, svc_b = service(watch, out_a), service(watch, out_b)
    np.savez(watch / "a0.sounding.npz",
             points_enu=np.array([[0.0, 0.0, 350.0]]),
             ne_m3=np.array([3e11]), noise_frac=np.array(0.05))
    assert svc.process_available() == 2
    assert "a0.sounding.npz" in svc.processed    # held, then ingested
    assert svc_b.process_available() == 2
    grid = svc.grid
    m_true = chapman.log_parametrize(chapman.chapman_field(grid,
                                                           h_peak_km=420.0))
    origin = grid.origin.numpy().astype(np.float64)
    span = grid.spacing.numpy() * (np.asarray(grid.shape) - 1)
    cx, cy = origin[0] + 0.5 * span[0], origin[1] + 0.5 * span[1]
    probes = iono.bottomside_probes(m_true, grid, [[cx, cy]],
                                    n_per_station=6, noise_log=0.05, seed=2)
    iono.probes_to_npz(watch / "a1.sounding.npz", probes)
    _epoch_files(str(watch), 1, start=2)
    m_clim_before = svc.filter.m_clim.clone()
    assert svc.process_available() == 1     # epoch 2 + the a1 sounding
    assert "a1.sounding.npz" in svc.processed
    assert svc.process_available() == 0
    assert not torch.equal(svc.filter.m_clim, m_clim_before)
    snd = [r for r in records(out_a) if r.get("event") == "sounding"]
    assert [r["file"] for r in snd] == ["a0.sounding.npz", "a1.sounding.npz"]
    assert snd[1]["n_probes"] == 6
    assert all(r["mean_abs_dlogne"] > 0 for r in snd)
    del svc_b
    svc_b2 = service(watch, out_b)
    assert svc_b2.process_available() == 1
    same_epochs(out_a, out_b, 3)
    assert torch.equal(svc_b2.filter.m_clim, svc.filter.m_clim)
    assert torch.equal(svc_b2._clim_delta, svc._clim_delta)
    bad = iono.NeProbes(points=torch.tensor([[1e5, 1e5, 300.0]]),
                        values=torch.tensor([0.0]),
                        noise_std=torch.tensor(0.05))
    iono.probes_to_npz(watch / "bad.sounding.npz", bad)
    assert svc.process_available() == 0
    assert "bad.sounding.npz" in svc.processed
    assert any(r.get("event") == "bad_sounding" for r in records(out_a))


def test_service_sounding_hardening(tmp_path):
    """A held sounding lands in the same call as the first epoch; a
    truncated npz is retried until its size is stable; event records
    survive the restart prune; other probe settings refuse to resume."""
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    np.savez(watch / "a0.sounding.npz",
             points_enu=np.array([[0.0, 0.0, 350.0]]),
             ne_m3=np.array([3e11]), noise_frac=np.array(0.05))
    _epoch_files(str(watch), 1)
    svc = service(watch, out)
    assert svc.process_available() == 1
    assert "a0.sounding.npz" in svc.processed
    np.savez(watch / "t0.sounding.npz",
             points_enu=np.array([[0.0, 0.0, 350.0]]))
    assert svc.process_available() == 0
    assert "t0.sounding.npz" not in svc.processed       # retried
    assert any(r.get("event") == "unreadable"
               and r["file"] == "t0.sounding.npz" for r in records(out))
    assert svc.process_available() == 0
    assert "t0.sounding.npz" in svc.processed           # size stable: bad
    svc2 = service(watch, out)
    recs = records(out)
    assert any(r.get("event") == "sounding" for r in recs)
    assert any(r.get("event") == "bad_sounding" for r in recs)
    assert [r["epoch"] for r in recs if "epoch" in r] == [0]
    assert svc2.process_available() == 0
    with pytest.raises(ValueError, match="probe"):
        service(watch, out, probe_update_clim=False)


@pytest.mark.parametrize("kind", ["enkf", "adapt_r", "beam_noise"])
def test_drawing_services_restart_identically(tmp_path, kind):
    """Services that draw: the ensemble filter (spread in the Solutions),
    adaptive R (the learned scale logged and restored) and beam noise (a
    beam_noise record per epoch). A service killed after two epochs and
    restarted gives the uninterrupted service's Solutions and records bit
    for bit."""
    watch = tmp_path / "in"; watch.mkdir()
    out_a, out_b = tmp_path / "out_a", tmp_path / "out_b"
    _epoch_files(str(watch), 3)
    cfg = _cfg()
    if kind == "enkf":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, solver="enkf", cg_iters=6, enkf_members=4))
    elif kind == "adapt_r":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, adapt_r=0.3))
    else:
        cfg = dataclasses.replace(cfg, rays=dataclasses.replace(
            cfg.rays, beam_noise=3, n_steps=16))
    svc = service(watch, out_a, cfg)
    assert svc.process_available() == 3
    os.rename(watch / "epoch_002.h5", tmp_path / "stash.h5")
    assert service(watch, out_b, cfg).process_available() == 2
    os.rename(tmp_path / "stash.h5", watch / "epoch_002.h5")
    svc_b = service(watch, out_b, cfg)
    assert svc_b.process_available() == 1
    same_epochs(out_a, out_b, 3)

    def stable(out):
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in records(out)]
    assert stable(out_a) == stable(out_b)
    recs = records(out_a)
    if kind == "enkf":
        std = load(out_a, 0).diagnostics["std"]
        assert np.isfinite(std).all() and std.max() > 0
        assert torch.equal(svc_b.filter.ens, svc.filter.ens)
    elif kind == "adapt_r":
        assert all("r_scale" in r for r in recs if "epoch" in r)
        assert svc.filter.r_scale != 1.0
        assert svc_b.filter.r_scale == svc.filter.r_scale
    else:
        beams = [r for r in recs if r.get("event") == "beam_noise"]
        assert [r["epoch"] for r in beams] == [0, 1, 2]
        assert all(r["max"] >= r["mean"] > 0 for r in beams)
        plain = tmp_path / "plain"
        service(watch, plain).process_available()
        assert np.abs(load(plain, 2).m - load(out_a, 2).m).max() > 0


def test_service_diag_spectrum_events(tmp_path):
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    _epoch_files(str(watch), 3)
    svc = service(watch, out, _cfg(diag_spectrum_every=2))
    assert svc.process_available() == 3
    recs = records(out)
    evs = [r for r in recs if r.get("event") == "update_spectrum"]
    assert [e["epoch"] for e in evs] == [0, 2]
    for e in evs:
        lam = e["lam"]
        assert len(lam) == e["rank"] == 16
        assert lam[0] >= lam[-1] >= 0.9
        assert e["kappa_bound"] == lam[0] >= 1.0
    assert len([r for r in recs if "seconds" in r and "epoch" in r
                and r.get("event") is None]) == 3


@pytest.fixture(scope="module")
def jax_service(tmp_path_factory):
    """The reference's point-filter service over three epoch files, its
    output directory copied after the second epoch."""
    from ionotomo_tpu.config import EngineConfig as JConfig
    from ionotomo_tpu.serving import EpochService as JService

    root = tmp_path_factory.mktemp("jax_service")
    watch = root / "in"; watch.mkdir()
    _epoch_files(str(watch), 3)
    stash = root / "stash"; stash.mkdir()
    os.rename(watch / "epoch_002.h5", stash / "epoch_002.h5")
    cfg = JConfig.from_json(_cfg().to_json())
    svc = JService(str(watch), str(root / "out"), cfg)
    assert svc.process_available() == 2
    shutil.copytree(root / "out", root / "after_2")
    os.rename(stash / "epoch_002.h5", watch / "epoch_002.h5")
    assert svc.process_available() == 1
    return root


def _assert_epochs_close(out_port, out_jax, epochs):
    prior = chapman.log_parametrize(chapman.chapman_field(
        load(out_port, 0).grid)).numpy()
    for i in epochs:
        got, want = load(out_port, i).m, load(out_jax, i).m
        update = np.linalg.norm((want - prior).astype(np.float64))
        assert np.linalg.norm((got - want).astype(np.float64)) \
            <= 1e-2 * update, i
    pr, jr = records(out_port), records(out_jax)
    pr = [r for r in pr if r.get("epoch") in epochs]
    jr = [r for r in jr if r.get("epoch") in epochs]
    assert [sorted(r) for r in pr] == [sorted(r) for r in jr]
    assert [(r["epoch"], r["file"], r.get("event")) for r in pr] \
        == [(r["epoch"], r["file"], r.get("event")) for r in jr]
    for a, b in zip(pr, jr):
        for k in ("pre_residual", "post_residual"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3)


def test_point_service_matches_the_jax_service(jax_service, tmp_path):
    """Default options, no adaptive R, no beam noise (nothing drawn): the
    same watch directory gives each epoch's field and record as the
    reference's service does."""
    root = jax_service
    svc = service(root / "in", tmp_path / "out")
    assert svc.process_available() == 3
    np.testing.assert_array_equal(svc.grid.origin.numpy(),
                                  load(root / "out", 0).grid.origin.numpy())
    _assert_epochs_close(tmp_path / "out", root / "out", [0, 1, 2])


def test_jax_service_state_continues_in_the_port(jax_service, tmp_path):
    """The reference service's output directory after epoch 2 (its
    state.npz: the same keys and config guard) resumed by the port's
    service gives epoch 3 as the reference's gives it."""
    root = jax_service
    out = tmp_path / "out"
    shutil.copytree(root / "after_2", out)
    svc = service(root / "in", out)
    assert svc.filter.t == 2 and svc.processed == ["epoch_000.h5",
                                                   "epoch_001.h5"]
    assert svc.process_available() == 1
    _assert_epochs_close(out, root / "out", [2])


def test_serve_cli_gives_the_python_service(tmp_path):
    """``python -m ionotomo_tpu_torch serve ... --device cpu --max-epochs
    2`` over a watch directory writes the Solutions that the same service
    built in Python writes."""
    watch = tmp_path / "in"; watch.mkdir()
    _epoch_files(str(watch), 2)
    cli_out, py_out = tmp_path / "cli", tmp_path / "py"
    args = ["serve", str(watch), str(cli_out), "--grid", "14", "--samples",
            "17", "--cg-iters", "8", "--prior-kind", "sqexp",
            "--prior-length", "90", "--poll-s", "0.01", "--max-epochs",
            "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "ionotomo_tpu_torch", *args],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "assimilated 2 epoch(s)" in out.stdout
    from ionotomo_tpu_torch.__main__ import parser, serve_config
    cfg = serve_config(parser().parse_args(args))
    assert cfg.grid.shape == (14, 14, 14) and cfg.solver.cg_iters == 8
    assert service(watch, py_out, cfg).run(poll_s=0.01, max_epochs=2) == 2
    same_epochs(cli_out, py_out, 2)
    with pytest.raises(SystemExit):          # 1 or 3 lengths, not 2
        serve_config(parser().parse_args(args + ["--prior-length", "1",
                                                 "2"]))
