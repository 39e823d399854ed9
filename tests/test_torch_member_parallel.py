"""The port's member-parallel ensemble filter
(``ionotomo_tpu_torch.inversion.kalman.member_parallel_enkf``: S groups of
members, one a device, pmeans in group order) on the CPU: the
counterparts of ``tests/test_multichip.py``'s member-parallel tests at
their sizes and tolerances over 8 CPU groups, held against the JAX
package's ``member_parallel_enkf``, run once in the module fixture
``jax_member_parallel`` (its one multi-device compile), and against its
unsharded ``ensemble_kalman_filter``; the guards; groups of one member;
chunked continuation of the grouped ensemble; the pipeline's
``enkf_shard="members"``.

The port takes its draws as arrays: ``tests/test_torch_enkf.jax_draws``
draws them by the reference's key derivation at global shape, and the
port's groups take their rows, so all filters consume the same numbers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion.anchors import (TecAnchors as JTecAnchors,
                                            background_covariance as jbg,
                                            columns_bundle as jcolumns)
from ionotomo_tpu.inversion.kalman import (ensemble_kalman_filter as jenkf,
                                           initial_ensemble as jinitial,
                                           member_parallel_enkf as jmpenkf)
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu.parallel import sharding as jshard
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import anchors as tanch
from ionotomo_tpu_torch.inversion.kalman import (
    ensemble_kalman_filter as tenkf, initial_ensemble as tinitial,
    member_parallel_enkf as tmpenkf)
from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
from ionotomo_tpu_torch.parallel import sharding as sm

from tests.test_multichip import world as jworld
from tests.test_torch_enkf import jax_draws
from tests.test_torch_multichip import cfg, pipeline_world

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
NT, B, N_DIRS = 3, 8, 4


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def setup():
    """``tests/test_multichip.py``'s member-parallel world (12³, 16 rays,
    3 steps, 8 members, 2 VTEC anchors, wind adaptation) in both
    packages, with the reference's draws."""
    grid, m, o, d = jworld(nx=12, n_rays=16)
    rb = jrays.sample_straight_rays(o, d, max_length_km=900.0, n_samples=33)
    rs = jrays.RayBundle(points=jnp.stack([rb.points] * NT),
                         ds=jnp.stack([rb.ds] * NT))
    d_seq = jnp.stack([jtec.dtec_paired(m, grid, rb, N_DIRS, 0)] * NT)
    cov = JGPCovariance.create(grid, sigma=0.3, length_scale=120.0,
                               kind="sqexp")
    arb = jcolumns(grid, np.asarray([[0.0, 0.0], [150.0, -100.0]],
                                    np.float32))
    anchors = JTecAnchors(rays=arb, values=jtec.tec(m, grid, arb),
                          noise_std=jnp.float32(0.5))
    a_cov = jbg(grid)
    key = jax.random.key(3)
    kw = dict(cg_iters=5, fade=0.95, inflation=1.05, process_sigma=0.02,
              wind_adapt_iters=1)
    jkw = dict(kw, num_directions=N_DIRS, key=key, n_members=B,
               anchors=anchors, anchor_cov=a_cov)
    ens0 = jinitial(grid, cov, m, key, B)
    n_rows = int(np.prod(d_seq.shape[1:]))
    init, process, obs, _ = jax_draws(key, grid.shape, n_rows, n_anchors=2,
                                      nt=NT, b=B)
    pts, ds = t(rs.points[0]), t(rs.ds[0])
    port = dict(
        grid=convert.grid_from_numpy(grid, device="cpu"),
        rays_seq=trays.RayBundle(pts.expand(NT, *pts.shape),
                                 ds.expand(NT, *ds.shape)),
        d_seq=t(d_seq), m=t(m),
        cov=convert.gp_covariance_from_numpy(cov, device="cpu"),
        kw=dict(kw, num_directions=N_DIRS, n_members=B,
                obs_noise=torch.from_numpy(obs),
                process_noise=torch.from_numpy(process),
                anchors=tanch.TecAnchors(
                    rays=trays.RayBundle(points=t(arb.points),
                                         ds=t(arb.ds)),
                    values=t(anchors.values), noise_std=torch.tensor(0.5)),
                anchor_cov=convert.gp_covariance_from_numpy(a_cov,
                                                            device="cpu")),
        init=torch.from_numpy(init))
    port["ens0"] = tinitial(port["grid"], port["cov"], port["m"],
                            port["init"])
    jax_args = (grid, rs, d_seq, jnp.float32(1e-2), m, cov, (0.1, 0.0, 0.0),
                60.0)
    return dict(jax_args=jax_args, jkw=jkw, ens0=ens0, port=port)


@pytest.fixture(scope="module")
def jax_member_parallel(setup):
    """The JAX package's member_parallel_enkf, once, on its 8 virtual
    devices, and its unsharded filter."""
    mesh = jshard.member_mesh()
    ens0_s = jax.device_put(setup["ens0"], jshard.member_sharding(mesh))
    sh = jmpenkf(mesh, *setup["jax_args"], ens0=ens0_s, **setup["jkw"])
    base = jenkf(*setup["jax_args"], ens0=setup["ens0"], **setup["jkw"])
    return {name: {k: np.asarray(getattr(r, k)) for k in
                   ("mean_seq", "std_seq", "ensemble", "wind_seq",
                    "residuals")}
            for name, r in (("sharded", sh), ("base", base))}


def port_run(setup, groups=None, ens0=None, **over):
    p = setup["port"]
    args = (p["grid"], p["rays_seq"], p["d_seq"], 1e-2, p["m"], p["cov"],
            (0.1, 0.0, 0.0), 60.0)
    kw = dict(p["kw"], **over)
    ens0 = p["ens0"] if ens0 is None else ens0
    if groups is None:
        return tenkf(*args, ens0=ens0, **kw)
    mesh = sm.member_mesh(CPU8[:groups])
    return tmpenkf(mesh, *args, ens0=sm.member_sharding(mesh)(ens0)
                   if not isinstance(ens0, sm.Sharded) else ens0, **kw)


def as_np(res, name):
    x = getattr(res, name)
    return (x.gather() if isinstance(x, sm.Sharded) else x).numpy()


def assert_close(got, want, scale, res_tol=1e-4):
    """The reference's bounds: each state within 2e-3 of the ensemble's
    departure (the wind within 2e-3 km/s), residuals within ``res_tol``
    relative (1e-4 within one package; 1e-3 between the two, the
    cross-package bound of ``tests/test_torch_enkf.py``)."""
    for name in ("mean_seq", "std_seq", "ensemble", "wind_seq"):
        ref = scale if name != "wind_seq" else 1.0
        diff = float(np.abs(as_np(got, name) - want[name]).max())
        assert diff < 2e-3 * max(ref, 1.0), (name, diff)
    rel = float(np.abs(got.residuals.numpy() - want["residuals"]).max()
                / np.abs(want["residuals"]).max())
    assert rel < res_tol, rel


@pytest.mark.parametrize("groups", [8, 2])
def test_member_parallel_enkf_matches_unsharded(setup, jax_member_parallel,
                                                groups):
    """The member-parallel filter (8 groups of one member, 2 of four)
    against the JAX package's member_parallel_enkf and its unsharded
    filter, and against the port's unsharded filter, within the
    reference's bounds (``assert_close``); the ensemble comes back as one
    group a device."""
    sh = port_run(setup, groups)
    assert isinstance(sh.ensemble, sm.Sharded)
    assert len(sh.ensemble.shards) == groups
    assert all(e.shape[0] == B // groups for e in sh.ensemble.shards)
    want = jax_member_parallel["sharded"]
    m = setup["port"]["m"].numpy()
    scale = float(np.abs(jax_member_parallel["base"]["ensemble"]
                         - m[None]).max())
    assert_close(sh, want, scale, res_tol=1e-3)
    assert_close(sh, jax_member_parallel["base"], scale, res_tol=1e-3)
    base = port_run(setup)
    assert_close(sh, {k: as_np(base, k) for k in
                      ("mean_seq", "std_seq", "ensemble", "wind_seq",
                       "residuals")}, scale)


def test_member_parallel_enkf_guards(setup):
    """The wrapper's input validation, with the reference's messages:
    wrong mesh axis, indivisible members, missing ens0, spectrum_blend."""
    p = setup["port"]
    mesh = sm.member_mesh(CPU8)
    args = (p["grid"], None, None, None, p["m"], p["cov"], (0, 0, 0), 30.0)
    ens0 = p["ens0"]
    with pytest.raises(ValueError, match="member_mesh"):
        tmpenkf(sm.ray_mesh(CPU8), *args, ens0=ens0, n_members=8)
    with pytest.raises(ValueError, match="divide"):
        tmpenkf(mesh, *args, ens0=ens0, n_members=9)
    with pytest.raises(ValueError, match="requires ens0"):
        tmpenkf(mesh, *args, ens0=None, n_members=8)
    with pytest.raises(ValueError, match="requires ens0"):
        tmpenkf(mesh, *args, ens0=ens0[:4], n_members=8)
    with pytest.raises(ValueError, match="spectrum_blend"):
        tmpenkf(mesh, *args, ens0=ens0, n_members=8, spectrum_blend=0.5)
    with pytest.raises(ValueError, match="member_mesh"):
        sm.member_sharding(sm.ray_mesh(CPU8))
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "device_count", lambda: 0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            sm.member_mesh()
    finally:
        monkey.undo()


def test_member_groups_chunk_like_one_call(setup):
    """Chunked continuation of the grouped ensemble (2 steps, then 1 with
    the carried groups) equals one 3-step call bit for bit, as the
    unsharded filter's does."""
    p = setup["port"]
    one = port_run(setup, 4)
    first = tmpenkf(sm.member_mesh(CPU8[:4]), p["grid"],
                    trays.RayBundle(p["rays_seq"].points[:2],
                                    p["rays_seq"].ds[:2]),
                    p["d_seq"][:2], 1e-2, p["m"], p["cov"], (0.1, 0.0, 0.0),
                    60.0, ens0=sm.member_sharding(sm.member_mesh(CPU8[:4]))(
                        p["ens0"]), **p["kw"])
    second = tmpenkf(sm.member_mesh(CPU8[:4]), p["grid"],
                     trays.RayBundle(p["rays_seq"].points[2:],
                                     p["rays_seq"].ds[2:]),
                     p["d_seq"][2:], 1e-2, first.ensemble.gather(),
                     p["cov"], first.wind_seq[-1], 60.0,
                     ens0=first.ensemble, advect_first=True, m_clim=p["m"],
                     step_offset=2, **p["kw"])
    assert torch.equal(torch.cat([first.mean_seq, second.mean_seq]),
                       one.mean_seq)
    assert torch.equal(second.ensemble.gather(), one.ensemble.gather())


def test_pipeline_enkf_member_sharding_matches_rays_mode(tmp_path):
    """``enkf_shard="members"`` end to end over an 8-device mesh: the
    member-parallel pipeline filter against the ray-sharded one (both
    consume the same draws) within the reference's bounds, and a
    checkpointed ensemble gathered whole."""
    dp = pipeline_world(7, 5, 3)
    kw = dict(solver="enkf", cg_iters=8, enkf_members=8, kalman_chunk=2)
    pipe_m = InversionPipeline(dp, cfg(tmp_path, "m", enkf_shard="members",
                                       **kw), device="cpu",
                               mesh=sm.ray_mesh(CPU8))
    sol_m = pipe_m.run(resume=False)
    pipe_r = InversionPipeline(dp, cfg(tmp_path, "r", enkf_shard="rays",
                                       **kw), device="cpu",
                               mesh=sm.ray_mesh(CPU8))
    sol_r = pipe_r.run(resume=False)
    delta = np.abs(sol_r.m - pipe_r.m_prior.numpy()).max()
    assert np.abs(sol_m.m - sol_r.m).max() < 0.02 * delta
    sd = np.abs(np.asarray(sol_m.diagnostics["std_seq"])
                - np.asarray(sol_r.diagnostics["std_seq"]))
    assert np.sqrt(np.mean(sd ** 2)) < 5e-3 and sd.max() < 0.05
    ck = np.load(sorted((tmp_path / "m" / "c").glob("*.npz"))[-1])
    assert ck["enkf_ensemble"].shape == (8, 12, 12, 12)
    # without a mesh, "members" runs the one-device filter, as the
    # reference's pipeline does on one device
    pipe_1 = InversionPipeline(dp, cfg(tmp_path, "one", enkf_shard="members",
                                       **kw), device="cpu")
    assert pipe_1.mesh is None and np.isfinite(
        pipe_1.run(resume=False).m).all()
