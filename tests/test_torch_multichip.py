"""The port's ray mesh (``ionotomo_tpu_torch.parallel.sharding``: the mesh,
its placements and padding, the ray-sharded bundle and operators, the
pipeline's mesh) against the JAX package on the CPU: one counterpart for
each test of ``tests/test_multichip.py`` but its member-parallel ones
(``tests/test_torch_member_parallel.py``), at its sizes and tolerances,
over 8 CPU shards (``[torch.device("cpu")] * 8``, the counterpart of
``tests/conftest.py``'s 8 virtual devices).

The port's sharded paths are held against the JAX package's replicated
functions, as the JAX tests hold theirs (none of them runs a JAX
multi-device compile: those are what crash XLA here). The pipelines with
a mesh are held against the port's pipeline without one, as the JAX
tests hold theirs (the unmeshed port pipeline is held against JAX by
``tests/test_torch_pipeline.py``).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid3D
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import anchors as janch
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu.parallel import sharding as jshard
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.config import (EngineConfig, GridConfig, RayConfig,
                                       RuntimeConfig, SolverConfig)
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import fermat as tfermat
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.inversion import anchors as tanch
from ionotomo_tpu_torch.inversion import solvers as tsolvers
from ionotomo_tpu_torch.inversion.pipeline import InversionPipeline
from ionotomo_tpu_torch.parallel import sharding as sm

from tests.test_torch_pipeline import port_datapack

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def world(nx=16, n_rays=40):
    """``tests/test_multichip.py``'s world for both packages: (JAX grid,
    JAX m, port grid, port m, origins, directions)."""
    rng = np.random.default_rng(0)
    jgrid = JGrid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                                (nx, nx, nx))
    m = jchapman.log_parametrize(jchapman.chapman_field(jgrid))
    o = np.concatenate([rng.uniform(-30, 30, (n_rays, 2)),
                        np.zeros((n_rays, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.5, n_rays)
    az = rng.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return jgrid, m, convert.grid_from_numpy(jgrid, device="cpu"), t(m), o, d


def array_world(seed, na, nd, nx=12):
    """An (antenna × direction) straight bundle on the 12³ world, both
    packages: (jgrid, m, grid, tm, jb, tb, rng)."""
    jgrid, m, grid, tm, _, _ = world(nx=nx, n_rays=0)
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-40, 40, (na, 2)),
                           np.zeros((na, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.4, nd)
    az = rng.uniform(0, 2 * np.pi, nd)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    o, d = jrays.make_ray_batch(ants, dirs)
    jb = jrays.sample_straight_rays(o, d, max_length_km=800.0, n_samples=17)
    to, tdv = trays.make_ray_batch(torch.from_numpy(ants),
                                   torch.from_numpy(dirs))
    tb = trays.sample_straight_rays(to, tdv, max_length_km=800.0,
                                    n_samples=17)
    return jgrid, m, grid, tm, jb, tb, rng


def test_mesh_and_padding():
    """The mesh over the given devices; shard_ray_batch pads to a
    multiple of its size by repeating the last element, as the
    reference's does (its padded array held against the port's)."""
    mesh = sm.ray_mesh(CPU8)
    assert mesh.size == 8 and mesh.shape == {"rays": 8}
    o = torch.arange(39, dtype=torch.float32).reshape(13, 3)
    (o_p,), n = sm.shard_ray_batch(mesh, o)
    assert n == 13 and len(o_p.shards) == 8
    assert o_p.shape[0] % mesh.size == 0
    o_np = o_p.gather().numpy()
    np.testing.assert_allclose(o_np[12], o_np[-1])
    (j_p,), jn = jshard.shard_ray_batch(jshard.ray_mesh(), jnp.asarray(o))
    assert jn == n and np.array_equal(np.asarray(j_p), o_np)
    (r,) = sm.replicate(mesh, o)
    assert all(s is o for s in r.shards)


def test_sharded_tec_matches_single_device():
    """TEC over a ray-sharded bundle (each shard's rays on its device,
    the per-ray values back in ray order) against the JAX single-device
    tec."""
    jgrid, m, grid, tm, o, d = world()
    jb = jrays.sample_straight_rays(jnp.asarray(o), jnp.asarray(d),
                                    n_samples=33)
    want = np.asarray(jtec.tec(m, jgrid, jb))
    tb = trays.sample_straight_rays(torch.from_numpy(o), torch.from_numpy(d),
                                    n_samples=33)
    mesh = sm.ray_mesh(CPU8)
    (pts, ds), n = sm.shard_ray_batch(mesh, tb.points, tb.ds)
    srb = sm.ShardedRayBundle(tuple(trays.RayBundle(points=p, ds=s)
                                    for p, s in zip(pts.shards, ds.shards)))
    got = ttec.tec(tm, grid, srb).numpy()
    np.testing.assert_allclose(got[:n], want, rtol=2e-6,
                               atol=1e-3 * np.abs(want).max())


def test_sharded_bent_tracer_matches_single_device():
    """The tracer over ray-sharded origins, shard by shard, against the
    JAX single-device trace."""
    jgrid, m, grid, tm, o, d = world()
    _, tec_single = jfermat.trace_rays(m, jgrid, o, d, 150e6, 1000.0,
                                       n_steps=16, keep_path=False,
                                       method="leapfrog")
    mesh = sm.ray_mesh(CPU8)
    (o_p, d_p), n = sm.shard_ray_batch(mesh, torch.from_numpy(o),
                                       torch.from_numpy(d))
    taus = [tfermat.trace_rays(tm, grid, oo, dd, 150e6, 1000.0, n_steps=16,
                               keep_path=False, method="leapfrog")[1]
            for oo, dd in zip(o_p.shards, d_p.shards)]
    got = torch.cat(taus).numpy()
    np.testing.assert_allclose(got[:n], np.asarray(tec_single), rtol=3e-6)


def pipeline_world(na, nd, nt, noise=None):
    from ionotomo_tpu.data.synth import generate_example_datapack

    kw = {} if noise is None else dict(noise_tecu=noise)
    dp, truth = generate_example_datapack(
        n_antennas=na, n_directions=nd, n_times=nt, mjd0=58000.45,
        grid_shape=(12, 12, 12), n_samples=17, **kw)
    dp.wind_kmps = truth["wind_kmps"]
    return port_datapack(dp)


def cfg(root, sub, **solver):
    return EngineConfig(
        grid=GridConfig(shape=(12, 12, 12)), rays=RayConfig(n_samples=17),
        solver=SolverConfig(**solver),
        runtime=RuntimeConfig(checkpoint_dir=os.path.join(root, sub, "c"),
                              metrics_path=os.path.join(root, sub,
                                                        "m.jsonl")))


def test_pipeline_shards_rays_on_the_mesh(tmp_path):
    """With an 8-shard mesh and Na·Nd divisible by 8, the snapshot solve
    runs on a ray-sharded bundle (whole antennas a shard) and matches the
    pipeline without a mesh."""
    dp = pipeline_world(8, 4, 1)
    pipe = InversionPipeline(dp, cfg(tmp_path, "a", gn_iters=1, cg_iters=10),
                             device="cpu", mesh=sm.ray_mesh(CPU8))
    assert pipe.mesh is not None
    rb = pipe._shard(pipe.rays_for_time(0))
    assert isinstance(rb, sm.ShardedRayBundle) and len(rb.shards) == 8
    assert all(b.points.shape[0] == 4 for b in rb.shards)
    m_t, diag = pipe.solve_snapshot(0)
    assert np.isfinite(m_t.numpy()).all() and diag["rays"] == 32
    un = InversionPipeline(dp, cfg(tmp_path, "b", gn_iters=1, cg_iters=10),
                           device="cpu")
    assert un.mesh is None
    m_u, _ = un.solve_snapshot(0)
    delta = float((m_u - un.m_prior).abs().max())
    assert float((m_t - m_u).abs().max()) < 1e-2 * delta


def test_sharded_gradient_step_psums_correctly():
    """The gradient of a data misfit with respect to the field, rays
    sharded and padded (padded rays masked by zero weight): Jᵀ shard by
    shard, the tables added in shard order, against jax.grad on one
    device."""
    jgrid, m, grid, tm, o, d = world(n_rays=48)
    jb = jrays.sample_straight_rays(jnp.asarray(o), jnp.asarray(d),
                                    n_samples=33)
    target = jtec.tec(m, jgrid, jb) * 1.1

    def loss(mm):
        return jnp.sum((jtec.tec(mm, jgrid, jb) - target) ** 2)

    g_single = np.asarray(jax.grad(loss)(m))
    tb = trays.sample_straight_rays(torch.from_numpy(o), torch.from_numpy(d),
                                    n_samples=33)
    mesh = sm.ray_mesh(CPU8[:5])             # 48 rays pad to 50
    (pts, ds, tgt), n = sm.shard_ray_batch(mesh, tb.points, tb.ds, t(target))
    srb = sm.ShardedRayBundle(tuple(trays.RayBundle(points=p, ds=s)
                                    for p, s in zip(pts.shards, ds.shards)))
    w = torch.zeros(pts.shape[0])
    w[:n] = 1.0
    op = ttec.dtec_paired_linear(tm, grid, srb, None, None, "simpson",
                                 "cubic")
    g_sharded = op.apply_t(2.0 * w * (op.g0 - tgt.gather())).numpy()
    np.testing.assert_allclose(g_sharded, g_single,
                               atol=2e-3 * np.abs(g_single).max())


def test_pipeline_pads_indivisible_ray_batches(tmp_path):
    """Na·Nd not divisible by the mesh: whole antennas are padded (noise
    inflated), one ``ray_sharding_padded`` event, the diagnostics count
    the real rays, and the solve matches the pipeline without a mesh
    within the reference's 8 % of the reconstruction's departure."""
    dp = pipeline_world(7, 5, 1)
    pipe = InversionPipeline(dp, cfg(tmp_path, "a", gn_iters=1, cg_iters=10),
                             device="cpu", mesh=sm.ray_mesh(CPU8))
    m_sharded, diag = pipe.solve_snapshot(0)
    events = [r for r in pipe.metrics.read_all()
              if r.get("event") == "ray_sharding_padded"]
    assert len(events) == 1 and events[0]["na_padded"] == 8
    assert diag["rays"] == 35
    un = InversionPipeline(dp, cfg(tmp_path, "b", gn_iters=1, cg_iters=10),
                           device="cpu")
    m_single, _ = un.solve_snapshot(0)
    delta = np.abs(m_single.numpy() - un.m_prior.numpy())
    diff = np.abs(m_sharded.numpy() - m_single.numpy())
    assert diff.max() < 0.08 * delta.max(), (diff.max(), delta.max())


def test_pipeline_kalman_shards_rays_with_padding(tmp_path):
    """The filter's chunks on ray-sharded, padded bundles (axis 1 of the
    stacked sequence), at the reference's physical noise (1e-2 TECU),
    within 5 % of the departure of the filter without a mesh."""
    dp = pipeline_world(7, 5, 3, noise=1e-2)
    kw = dict(solver="kalman", cg_iters=10)
    sol_sh = InversionPipeline(dp, cfg(tmp_path, "a", **kw), device="cpu",
                               mesh=sm.ray_mesh(CPU8)).run(resume=False)
    pipe_un = InversionPipeline(dp, cfg(tmp_path, "b", **kw), device="cpu")
    sol_un = pipe_un.run(resume=False)
    delta = np.abs(sol_un.m - pipe_un.m_prior.numpy()).max()
    assert np.abs(sol_sh.m - sol_un.m).max() < 0.05 * delta


@pytest.mark.parametrize("interp", ["cubic", "zp"])
def test_sharded_operator_applies_match_unsharded_tightly(interp):
    """One J and one Jᵀ of the linearised dTEC operator on a padded,
    ray-sharded bundle against the JAX unsharded operator (jax.linearize
    and linear_transpose): within 3e-6, the reference's bound, and
    against the port's unsharded operator the same."""
    na, nd = 7, 5                      # 35 rays: 35 % 8 != 0 → padding
    jgrid, m, grid, tm, jb, tb, rng = array_world(5, na, nd)

    def fwd(mm):
        return jtec.dtec_paired_q(mm, jgrid, jb, nd, 0, "hermite",
                                  interp).ravel()

    v = rng.normal(size=jgrid.shape).astype(np.float32)
    w = rng.normal(size=(na * nd,)).astype(np.float32)
    _, jvp_un = jax.linearize(fwd, jnp.asarray(m))
    j_un = np.asarray(jvp_un(jnp.asarray(v)))
    (jt_un,) = jax.linear_transpose(jvp_un, jnp.asarray(m))(jnp.asarray(w))
    jt_un = np.asarray(jt_un)

    mesh = sm.ray_mesh(CPU8)
    na_p = sm.pad_to_multiple(na, mesh.size)
    pts = tb.points.reshape(na, nd, -1, 3)
    pts_p = torch.cat([pts, pts[-1:].expand(na_p - na, *pts.shape[1:])])
    ds = tb.ds.reshape(na, nd)
    ds_p = torch.cat([ds, ds[-1:].expand(na_p - na, nd)])
    srb = sm.shard_rays(mesh, trays.RayBundle(
        points=pts_p.reshape(na_p * nd, -1, 3), ds=ds_p.reshape(-1)))
    op = ttec.dtec_paired_linear(tm, grid, srb, nd, 0, "hermite", interp)
    w_p = torch.cat([t(w), torch.zeros((na_p - na) * nd)])
    j_sh = op.apply(t(v)).numpy()[:na * nd]
    jt_sh = op.apply_t(w_p).numpy()
    np.testing.assert_allclose(j_sh, j_un, rtol=3e-6,
                               atol=3e-6 * np.abs(j_un).max())
    np.testing.assert_allclose(jt_sh, jt_un, rtol=3e-6,
                               atol=3e-6 * np.abs(jt_un).max())
    ref = ttec.dtec_paired_linear(tm, grid, tb, nd, 0, "hermite", interp)
    np.testing.assert_allclose(j_sh, ref.apply(t(v)).numpy(), rtol=3e-6,
                               atol=3e-6 * np.abs(j_un).max())
    np.testing.assert_allclose(jt_sh, ref.apply_t(t(w)).numpy(), rtol=3e-6,
                               atol=3e-6 * np.abs(jt_un).max())


def test_anchored_solve_with_sharded_rays_matches_unsharded():
    """Joint anchor rows (whole) + dTEC rays (sharded) in one MAP solve
    against the JAX unsharded solve, slant anchors included."""
    na, nd = 8, 4
    jgrid, m, grid, tm, jb, tb, rng = array_world(3, na, nd)
    m_true = m + 0.2
    d_obs = jtec.dtec_paired(m_true, jgrid, jb, nd, 0)
    jcov = JGPCovariance.create(jgrid, sigma=0.3, length_scale=120.0,
                                kind="sqexp")
    xy = rng.uniform(-40, 40, (6, 2))
    az = rng.uniform(0, 2 * np.pi, 6)
    el = rng.uniform(0.8, 1.5, 6)
    jbundle = janch.slant_bundle(jgrid, xy, az_rad=az, el_rad=el,
                                 n_samples=17)
    ja = janch.TecAnchors(rays=jbundle,
                          values=jtec.tec(m_true, jgrid, jbundle),
                          noise_std=jnp.float32(1.0))
    ref = jsolvers.map_gauss_newton(jgrid, jb, d_obs, 1.0, m, jcov,
                                    num_directions=nd, gn_iters=1,
                                    cg_iters=10, anchors=ja)
    ta = tanch.TecAnchors(
        rays=trays.RayBundle(points=t(jbundle.points), ds=t(jbundle.ds)),
        values=t(ja.values), noise_std=torch.tensor(1.0))
    cov = convert.gp_covariance_from_numpy(jcov, device="cpu")
    srb = sm.shard_rays(sm.ray_mesh(CPU8), tb)
    got = tsolvers.map_gauss_newton(grid, srb, t(d_obs), 1.0, tm, cov,
                                    num_directions=nd, gn_iters=1,
                                    cg_iters=10, anchors=ta)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(ref.m), atol=3e-3)


def test_slant_bundle_geometry_and_mapping():
    """Slant rays exit at the grid top; the slant/vertical TEC ratio of a
    horizontally uniform field matches the secant law and the thin-shell
    mapping, and the port's bundles and TEC equal the JAX package's."""
    jgrid, m, grid, tm, _, _ = world(nx=16, n_rays=0)
    el = np.deg2rad(55.0)
    sb = tanch.slant_bundle(grid, [[0.0, 0.0]], az_rad=0.7, el_rad=el,
                            n_samples=33)
    jsb = janch.slant_bundle(jgrid, [[0.0, 0.0]], az_rad=0.7, el_rad=el,
                             n_samples=33)
    np.testing.assert_allclose(sb.points.numpy(), np.asarray(jsb.points),
                               rtol=1e-6, atol=1e-4)
    top = float(sb.points[0, -1, 2])
    z_top = float(grid.origin[2] + grid.spacing[2] * (grid.shape[2] - 1))
    assert abs(top - z_top) < 1e-3
    vb = tanch.columns_bundle(grid, [[0.0, 0.0]], n_samples=33)
    stec = float(ttec.tec(tm, grid, sb)[0])
    vtec = float(ttec.tec(tm, grid, vb)[0])
    assert abs(stec - float(jtec.tec(m, jgrid, jsb)[0])) < 1e-5 * stec
    assert abs(stec / vtec - 1.0 / np.sin(el)) < 0.03 / np.sin(el)
    msf = tanch.thin_shell_mapping(el)
    assert 0.85 < (stec / vtec) / msf < 1.25


def test_multislice_mesh_solve_matches_unsharded():
    """A 2-level slice × device mesh: rays sharded over the flattened
    product, the MAP solve against the JAX unsharded solve."""
    na, nd = 8, 4
    jgrid, m, grid, tm, jb, tb, _ = array_world(5, na, nd)
    d_obs = jtec.dtec_paired(m + 0.15, jgrid, jb, nd, 0)
    jcov = JGPCovariance.create(jgrid, sigma=0.3, length_scale=120.0,
                                kind="sqexp")
    ref = jsolvers.map_gauss_newton(jgrid, jb, d_obs, 1.0, m, jcov,
                                    num_directions=nd, gn_iters=1,
                                    cg_iters=8)
    mesh = sm.multislice_ray_mesh(2, devices=CPU8)
    assert mesh.shape == {"slice": 2, "rays": 4} and mesh.size == 8
    srb = sm.shard_rays(mesh, tb)
    assert len(srb.shards) == 8
    cov = convert.gp_covariance_from_numpy(jcov, device="cpu")
    got = tsolvers.map_gauss_newton(grid, srb, t(d_obs), 1.0, tm, cov,
                                    num_directions=nd, gn_iters=1,
                                    cg_iters=8)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(ref.m), atol=3e-3)
    with pytest.raises(ValueError, match="do not divide"):
        sm.multislice_ray_mesh(3, devices=CPU8)
    with pytest.raises(ValueError, match="need 12 devices"):
        sm.multislice_ray_mesh(3, 4, devices=CPU8)


def test_ray_mesh_with_no_devices_given_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for make in (sm.ray_mesh, sm.member_mesh,
                 lambda: sm.multislice_ray_mesh(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_sharded_solve_is_bitwise_across_calls_and_equals_one_shard():
    """A solve on a ray-sharded bundle is the same bit for bit from call
    to call (the fixed shard order), and on a mesh of one shard it is the
    unsharded solve bit for bit."""
    na, nd = 8, 4
    jgrid, m, grid, tm, jb, tb, _ = array_world(2, na, nd)
    d_obs = ttec.dtec_paired(tm + 0.1, grid, tb, nd, 0)
    cov = convert.gp_covariance_from_numpy(
        JGPCovariance.create(jgrid, sigma=0.3, length_scale=120.0,
                             kind="sqexp"), device="cpu")

    def solve(rays):
        return tsolvers.map_gauss_newton(grid, rays, d_obs, 1.0, tm, cov,
                                         num_directions=nd, gn_iters=1,
                                         cg_iters=6).m

    srb = sm.shard_rays(sm.ray_mesh(CPU8[:4]), tb)
    assert torch.equal(solve(srb), solve(srb))
    one = sm.shard_rays(sm.ray_mesh(CPU8[:1]), tb)
    assert torch.equal(solve(one), solve(tb))


@pytest.mark.parametrize("quadrature", ["simpson", "hermite"])
def test_ray_sharded_forwards_are_the_forward_alone(quadrature, monkeypatch):
    """``tec``, ``dtec_paired_q`` and ``dtec_paired_over`` over a
    ray-sharded bundle evaluate the forward alone
    (``sharding.sharded_dtec_forward``, no operator built), equal to the
    sharded operator's g0 bitwise and to the JAX single-device forms."""
    jgrid, m, grid, tm, jb, tb, _ = array_world(5, 8, 4)
    mesh = sm.ray_mesh(CPU8)
    srb = sm.shard_rays(mesh, tb)

    def no_operator(*a, **k):
        raise AssertionError("a forward built an operator")
    monkeypatch.setattr(sm, "ShardedPairedDtecLinear", no_operator)
    got_q = ttec.dtec_paired_q(tm, grid, srb, 4, 0, quadrature)
    got_t = ttec.tec(tm, grid, srb)
    geo = ttec.dtec_geometry(grid, srb, 4, 0, "simpson", "cubic")
    got_o = ttec.dtec_paired_over(tm, geo)
    monkeypatch.undo()
    op = ttec.dtec_paired_linear(tm, grid, srb, 4, 0, quadrature, "cubic")
    assert got_q.shape == (8, 4) and torch.equal(got_q.reshape(-1), op.g0)
    assert torch.equal(got_o, ttec.dtec_paired_linear(
        tm, grid, srb, 4, 0, "simpson", "cubic").g0)
    # the paired dTEC of this smooth world is a near-cancellation: held
    # within 3e-6 of the TEC it is the difference of
    want_t = np.asarray(jtec.tec(m, jgrid, jb))
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=3e-6)
    want_q = np.asarray(jtec.dtec_paired_q(m, jgrid, jb, 4, 0, quadrature))
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=3e-6,
                               atol=3e-6 * np.abs(want_t).max())
