"""The port's x-sharded grid (``ionotomo_tpu_torch.parallel.grid_sharding``:
the halo exchange, K7 and K7ᵀ's plain versions, the differentiable
sharded operators, the sharded tracer) against the JAX package on the
CPU: one counterpart for each test of ``tests/test_grid_sharding.py`` at
its sizes and tolerances, over 8 CPU shards (the counterpart of
``tests/conftest.py``'s 8 virtual devices), held chiefly against the JAX
package's replicated functions, as the JAX tests hold theirs. The JAX
sharded entry points run once, in the module fixture ``jax_sharded``
(each JAX multi-device compile is costly and the source of the XLA
crash the ROADMAP records).

Also here: the halo exchange against slices of the whole field, the sum
of the shards' K7 bitwise the plain K5 twin, K7ᵀ's plain version bitwise
a numpy walk of the kernel over its task list, the linearised sharded
operator (``ShardedGridDtecLinear``) against the port's unsharded one,
and the guards (cubic only, nx divisible, loc ≥ HALO, no CUDA device with
``devices=None``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ionotomo_tpu.core import linalg as jlinalg
from ionotomo_tpu.core import tricubic as jtricubic
from ionotomo_tpu.core.grids import Grid3D as JGrid3D
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu.parallel import grid_sharding as jgs
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import linalg as tlinalg
from ionotomo_tpu_torch.core import tricubic as ttricubic
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.parallel import grid_sharding as gs

from .test_torch_k7_tasks import kernel_walk

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def world(nx=16, seed=0):
    """``tests/test_grid_sharding.py``'s smooth random world, both
    packages: (JAX grid, JAX field, port grid, port field)."""
    rng = np.random.default_rng(seed)
    jgrid = JGrid3D.from_bounds((-200, -200, 0.0), (200, 200, 800.0),
                                (nx, nx, nx))
    f = gaussian_filter(rng.normal(size=(nx, nx, nx)), 1.5).astype(np.float32)
    return (jgrid, jnp.asarray(f),
            convert.grid_from_numpy(jgrid, device="cpu"), torch.from_numpy(f))


def chapman_world():
    jgrid = JGrid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                                (16, 16, 16))
    m = jchapman.log_parametrize(jchapman.chapman_field(jgrid))
    return jgrid, m, convert.grid_from_numpy(jgrid, device="cpu"), t(m)


def slant_rays(seed, n, spread=30.0):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.1, 0.5, n)
    az = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return o, d, rng


def bundles(o, d, n_samples=17):
    jb = jrays.sample_straight_rays(jnp.asarray(o), jnp.asarray(d),
                                    n_samples=n_samples)
    tb = trays.sample_straight_rays(torch.from_numpy(o), torch.from_numpy(d),
                                    n_samples=n_samples)
    return jb, tb


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded entry points, each run once on the
    virtual 8-device mesh: interp_sharded and interp_sharded_with_grad at
    the first test's points, tec_hermite_sharded on the Chapman world."""
    jgrid, f, _, _ = world()
    rng = np.random.default_rng(1)
    pts = rng.uniform((-200, -200, 0), (200, 200, 800),
                      (500, 3)).astype(np.float32)
    mesh = jgs.grid_mesh()
    f_sh = jgs.shard_field(mesh, f)
    v = np.asarray(jgs.interp_sharded(mesh, f_sh, jgrid, jnp.asarray(pts)))
    vg = [np.asarray(a) for a in jgs.interp_sharded_with_grad(
        mesh, f_sh, jgrid, jnp.asarray(pts))]
    cgrid, m, _, _ = chapman_world()
    o, d, _ = slant_rays(9, 24)
    jb, _ = bundles(o, d)
    th = np.asarray(jgs.tec_hermite_sharded(mesh, jgs.shard_field(mesh, m),
                                            cgrid, jb))
    return dict(pts=pts, interp=v, interp_with_grad=vg, tec_hermite=th)


def test_sharded_interp_matches_replicated(jax_sharded):
    jgrid, f, grid, tf = world()
    pts = jax_sharded["pts"]
    want = np.asarray(jtricubic.interp(f, jgrid, jnp.asarray(pts)))
    mesh = gs.grid_mesh(CPU8)
    got = gs.interp_sharded(mesh, gs.shard_field(mesh, tf), grid,
                            torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, jax_sharded["interp"], rtol=2e-5,
                               atol=2e-6)


def test_sharded_interp_handles_edges_and_outside_points():
    """Points on every x-plane (shard seams included) and beyond both
    edges: exactly one shard owns each, so the sum is finite and right."""
    jgrid, f, grid, tf = world()
    xs = np.asarray(jgrid.axes()[0])
    pts = np.stack([np.concatenate([xs, [-500.0, 500.0]]),
                    np.full(len(xs) + 2, 13.0),
                    np.full(len(xs) + 2, 390.0)], axis=-1).astype(np.float32)
    want = np.asarray(jtricubic.interp(f, jgrid, jnp.asarray(pts)))
    mesh = gs.grid_mesh(CPU8)
    got = gs.interp_sharded(mesh, gs.shard_field(mesh, tf), grid,
                            torch.from_numpy(pts)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_shard_field_rejects_indivisible_axis():
    mesh = gs.grid_mesh(CPU8)
    with pytest.raises(AssertionError, match="must divide"):
        gs.shard_field(mesh, torch.zeros((17, 8, 8)))


def test_sharded_interp_with_grad_matches_replicated(jax_sharded):
    jgrid, f, grid, tf = world()
    rng = np.random.default_rng(3)
    pts = rng.uniform((-200, -200, 0), (200, 200, 800),
                      (300, 3)).astype(np.float32)
    want_v, want_g = jtricubic.interp_with_grad(f, jgrid, jnp.asarray(pts))
    mesh = gs.grid_mesh(CPU8)
    got_v, got_g = gs.interp_sharded_with_grad(
        mesh, gs.shard_field(mesh, tf), grid, torch.from_numpy(pts))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=2e-4,
                               atol=2e-5)
    v, g = gs.interp_sharded_with_grad(mesh, gs.shard_field(mesh, tf), grid,
                                       torch.from_numpy(jax_sharded["pts"]))
    np.testing.assert_allclose(v.numpy(), jax_sharded["interp_with_grad"][0],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(g.numpy(), jax_sharded["interp_with_grad"][1],
                               rtol=2e-4, atol=2e-5)


def test_sharded_grid_bent_trace_matches_replicated():
    """The Fermat trace through the x-sharded field (K7's plain version
    per integrator step) equals the JAX replicated trace, and the port's
    own plain tracer bit for bit (the shards' sum is the plain K5 twin's
    evaluation)."""
    jgrid, m, grid, tm = chapman_world()
    o, d, _ = slant_rays(5, 24)
    b_rep, t_rep = jfermat.trace_rays(m, jgrid, jnp.asarray(o),
                                      jnp.asarray(d), 60e6, 900.0,
                                      n_steps=24, method="leapfrog")
    mesh = gs.grid_mesh(CPU8)
    b_sh, t_sh = gs.trace_rays_sharded(
        mesh, gs.shard_field(mesh, tm), grid, torch.from_numpy(o),
        torch.from_numpy(d), 60e6, 900.0, n_steps=24, method="leapfrog")
    np.testing.assert_allclose(b_sh.points.numpy(), np.asarray(b_rep.points),
                               atol=2e-3)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(t_rep), rtol=3e-5)
    from ionotomo_tpu_torch.geometry import fermat as tfermat
    table = tm.reshape(-1, 16)
    b_pl, t_pl = tfermat._trace_impl(
        tfermat.log_field_ne_vg(
            lambda x: ttricubic.interp_rows_with_grad_taps_ref(table, grid,
                                                               x)),
        torch.from_numpy(o), torch.from_numpy(d), 60e6, 900.0, 24, True,
        "leapfrog")
    assert torch.equal(b_sh.points, b_pl.points) and torch.equal(t_sh, t_pl)


def test_2d_grid_ray_mesh_trace_matches_replicated():
    """2 grid shards × 4 ray shards: each ray shard traced by the grid
    shards of its column, results in ray order."""
    jgrid, m, grid, tm = chapman_world()
    o, d, _ = slant_rays(9, 32)
    b_rep, t_rep = jfermat.trace_rays(m, jgrid, jnp.asarray(o),
                                      jnp.asarray(d), 60e6, 900.0,
                                      n_steps=16, method="leapfrog")
    mesh = gs.grid_ray_mesh(2, 4, CPU8)
    assert mesh.shape == {gs.GRID_AXIS: 2, "rays": 4}
    b_sh, t_sh = gs.trace_rays_sharded(
        mesh, gs.shard_field(mesh, tm), grid, torch.from_numpy(o),
        torch.from_numpy(d), 60e6, 900.0, n_steps=16, method="leapfrog",
        rays_sharded=True)
    np.testing.assert_allclose(b_sh.points.numpy(), np.asarray(b_rep.points),
                               atol=2e-3)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(t_rep), rtol=3e-5)
    # points split over the ray axis, each ray shard's column of grid
    # shards evaluating it: the 1-D mesh's sum bit for bit
    pts = b_sh.points.reshape(-1, 3)
    v, g = gs.interp_sharded_with_grad(mesh, gs.shard_field(mesh, tm), grid,
                                       pts, points_sharded=True)
    mesh1 = gs.grid_mesh(CPU8)
    v1, g1 = gs.interp_sharded_with_grad(mesh1, gs.shard_field(mesh1, tm),
                                         grid, pts)
    assert torch.equal(v, v1) and torch.equal(g, g1)
    assert torch.equal(gs.interp_sharded(mesh, gs.shard_field(mesh, tm),
                                         grid, pts, points_sharded=True), v1)


def test_sharded_tec_forward_and_adjoint_match_replicated():
    """tec_sharded's forward against forward/tec.tec, and its autograd
    gradient (K7ᵀ's plain version and the halo adjoint) against
    jax.grad of the replicated tec."""
    jgrid, m, grid, tm = chapman_world()
    o, d, rng = slant_rays(4, 24)
    jb, tb = bundles(o, d)
    want = np.asarray(jtec.tec(m, jgrid, jb))
    mesh = gs.grid_mesh(CPU8)
    got = gs.tec_sharded(mesh, gs.shard_field(mesh, tm), grid, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-6)

    y = rng.normal(size=(24,)).astype(np.float32)
    g_rep = np.asarray(jax.grad(
        lambda f: jnp.vdot(jtec.tec(f, jgrid, jb), jnp.asarray(y)))(m))
    f = tm.clone().requires_grad_(True)
    out = gs.tec_sharded(mesh, gs.shard_field(mesh, f), grid, tb)
    (g_sh,) = torch.autograd.grad(torch.dot(out, torch.from_numpy(y)), f)
    np.testing.assert_allclose(g_sh.numpy(), g_rep,
                               atol=2e-5 * np.abs(g_rep).max())


def test_lsqr_inversion_on_sharded_grid_matches_replicated():
    """A damped least-squares solve whose operator runs on the x-sharded
    field (``ShardedGridDtecLinear``: K7 and K7ᵀ) against the JAX
    replicated solve (jax.linearize / linear_transpose + its LSQR)."""
    jgrid, m0, grid, tm0 = chapman_world()
    o, d, _ = slant_rays(6, 32, spread=40.0)
    jb, tb = bundles(o, d)
    jd_obs = jtec.tec(m0, jgrid, jb) * 1.02

    g0, jvp = jax.linearize(lambda f: jtec.tec(f, jgrid, jb), m0)
    vjp = jax.linear_transpose(jvp, m0)
    dm_rep, _ = jlinalg.lsqr(jvp, lambda y: vjp(y)[0], jd_obs - g0,
                             jnp.zeros_like(m0), damp=1e-3, max_iters=20)
    dm_rep = np.asarray(dm_rep)

    mesh = gs.grid_mesh(CPU8)
    op = gs.ShardedGridDtecLinear(mesh, gs.shard_field(mesh, tm0), grid, tb,
                                  None, None, "simpson")
    r = t(jd_obs) - op.g0
    dm_sh, _ = tlinalg.lsqr(
        lambda x: op.apply(x.reshape(grid.shape)),
        lambda y: op.apply_t(y).reshape(-1), r,
        torch.zeros(grid.num_voxels), damp=1e-3, max_iters=20)
    scale = np.abs(dm_rep).max()
    assert np.abs(dm_sh.reshape(grid.shape).numpy() - dm_rep).max() \
        < 2e-3 * scale


def test_sharded_hermite_tec_matches_replicated(jax_sharded):
    """The Hermite quadrature on the x-sharded grid: tec_hermite_sharded
    and dtec_paired_hermite_sharded against the replicated JAX forms (and
    the JAX sharded one), the autograd gradient against jax.grad."""
    jgrid, m, grid, tm = chapman_world()
    o, d, rng = slant_rays(9, 24)
    jb, tb = bundles(o, d)
    mesh = gs.grid_mesh(CPU8)
    sf = gs.shard_field(mesh, tm)
    got_t = gs.tec_hermite_sharded(mesh, sf, grid, tb).numpy()
    want_t = np.asarray(jtec.tec_hermite(m, jgrid, jb))
    np.testing.assert_allclose(got_t, want_t, rtol=3e-6)
    np.testing.assert_allclose(got_t, jax_sharded["tec_hermite"], rtol=3e-6)
    got_d = gs.dtec_paired_hermite_sharded(mesh, sf, grid, tb, 2, 0).numpy()
    want_d = np.asarray(jtec.dtec_paired_hermite(m, jgrid, jb, 2, 0))
    np.testing.assert_allclose(got_d, want_d, rtol=3e-6,
                               atol=2e-6 * np.abs(want_t).max())

    y = rng.normal(size=(24,)).astype(np.float32)
    g_rep = np.asarray(jax.grad(lambda f: jnp.vdot(
        jtec.tec_hermite(f, jgrid, jb), jnp.asarray(y)))(m))
    f = tm.clone().requires_grad_(True)
    out = gs.tec_hermite_sharded(mesh, gs.shard_field(mesh, f), grid, tb)
    (g_sh,) = torch.autograd.grad(torch.dot(out, torch.from_numpy(y)), f)
    np.testing.assert_allclose(g_sh.numpy(), g_rep,
                               atol=2e-5 * np.abs(g_rep).max())


def test_sharded_grid_rejects_nonreplicated_field_models():
    """Every sharded-grid operator raises NotImplementedError for
    interp='zp' (the cubic-only contract, the reference's message)."""
    from ionotomo_tpu_torch.core.grids import Grid3D

    mesh = gs.grid_mesh(CPU8)
    grid = Grid3D.create((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), (16, 12, 12),
                         device="cpu")
    f = gs.shard_field(mesh, torch.zeros(grid.shape))
    pts = torch.full((4, 3), 30.0)
    rays = trays.RayBundle(points=pts[None].expand(2, 4, 3),
                           ds=torch.ones(2))
    for call in [
        lambda: gs.interp_sharded(mesh, f, grid, pts, interp="zp"),
        lambda: gs.interp_sharded_with_grad(mesh, f, grid, pts,
                                            interp="zp"),
        lambda: gs.tec_sharded(mesh, f, grid, rays, interp="zp"),
        lambda: gs.dtec_paired_sharded(mesh, f, grid, rays, 2, interp="zp"),
        lambda: gs.tec_hermite_sharded(mesh, f, grid, rays, interp="zp"),
        lambda: gs.dtec_paired_hermite_sharded(mesh, f, grid, rays, 2,
                                               interp="zp"),
        lambda: gs.trace_rays_sharded(mesh, f, grid, pts,
                                      torch.tensor([[0.0, 0.0, 1.0]] * 4),
                                      150e6, interp="zp"),
    ]:
        with pytest.raises(NotImplementedError, match="cubic"):
            call()


# --- beyond the JAX tests' counterparts ------------------------------------


def test_halo_exchange_is_exact_and_ring_wrapped():
    """Each buffer holds its own planes and its neighbours' 2 planes on
    either side (the far edge's at the ring's seam), equal to slices of
    the whole field."""
    _, _, _, tf = world()
    mesh = gs.grid_mesh(CPU8)
    sf = gs.shard_field(mesh, tf)
    loc = sf.loc
    ext = torch.cat([tf[-2:], tf, tf[:2]])       # the ring's view
    for s in range(8):
        assert torch.equal(sf.ext[s], ext[s * loc:s * loc + loc + 4])
    assert torch.equal(sf.gather(), tf)


def test_shard_field_rejects_shards_thinner_than_the_halo():
    mesh = gs.grid_mesh(CPU8)
    with pytest.raises(AssertionError, match="halo width"):
        gs.shard_field(mesh, torch.zeros((8, 8, 8)))


def test_mesh_with_no_devices_given_needs_a_cuda_device(monkeypatch):
    """``devices=None`` takes the visible CUDA devices and raises where
    there is none: no mesh quietly becomes the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        gs.grid_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        gs.grid_ray_mesh(2, 4)


def test_shards_sum_to_the_whole_table_evaluator_bitwise():
    """K7's plain version summed over the shards equals the plain K5 twin
    in the kernels' order (``interp_rows_with_grad_taps_ref``) bit for
    bit, at random, seam and outside points: exactly one shard owns each
    point, and the owner reads the same taps."""
    jgrid, _, grid, tf = world()
    rng = np.random.default_rng(7)
    xs = np.asarray(jgrid.axes()[0])
    seams = np.stack([np.repeat(xs, 3), rng.uniform(-250, 250, 48),
                      rng.uniform(-50, 850, 48)], -1)
    pts = torch.from_numpy(np.concatenate(
        [rng.uniform((-250, -250, -50), (250, 250, 850), (400, 3)),
         seams]).astype(np.float32))
    mesh = gs.grid_mesh(CPU8)
    v, g = gs.interp_sharded_with_grad(mesh, gs.shard_field(mesh, tf), grid,
                                       pts)
    wv, wg = ttricubic.interp_rows_with_grad_taps_ref(tf.reshape(-1, 16),
                                                      grid, pts)
    assert torch.equal(v, wv) and torch.equal(g, wg)


@pytest.mark.parametrize("grad", [False, True])
def test_transpose_plain_version_is_the_kernels_tree(grad):
    """``sharded_transpose_ref`` (the plain K7ᵀ) equals a numpy walk of
    the kernel over the plan's task list bit for bit (``kernel_walk``: a
    warp's shuffle levels over each task, then a large cell's levels over
    its 32-entry subtree sums, added into the slab; outside points clamp
    onto the edges, so cells of many subtrees occur); and the shards'
    slabs, through the halo adjoint, are the transpose of the sharded
    value map (against the plain K5ᵀ)."""
    jgrid, _, grid, tf = world()
    rng = np.random.default_rng(11)
    corner = rng.uniform((-400, -400, -300), (-250, -250, -100), (300, 3))
    pts = torch.from_numpy(np.concatenate([
        rng.uniform((-260, -260, -60), (260, 260, 860), (700, 3)),
        corner]).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    cg = (torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
          if grad else None)
    for x0 in (0, 6, 14):
        plan = gs.sharded_plan(grid, pts, x0, 2)
        base = torch.from_numpy(rng.normal(size=plan.slab_cells)
                                .astype(np.float32))
        got = gs.sharded_transpose_ref(base.clone(), plan, grid, cv, cg)
        terms = gs._entry_terms(plan, grid, cv, cg).numpy()
        want = kernel_walk(plan, terms, base.numpy())
        assert np.array_equal(got.numpy(), want)
        # the first shard owns the clamped corner: cells of many subtrees
        assert x0 != 0 or plan.n_sub > plan.big_cell.shape[0]
    mesh = gs.grid_mesh(CPU8)
    f = tf.clone().requires_grad_(True)
    sf = gs.shard_field(mesh, f)
    if grad:
        v, g = gs.interp_sharded_with_grad(mesh, sf, grid, pts)
        loss = torch.dot(v, cv) + torch.sum(g * cg)
        want = ttricubic.interp_rows_with_grad_transpose_ref(grid, pts, cv,
                                                             cg)
    else:
        loss = torch.dot(gs.interp_sharded(mesh, sf, grid, pts), cv)
        want = ttricubic.interp_rows_with_grad_transpose_ref(
            grid, pts, cv, torch.zeros(1000, 3))
    (got,) = torch.autograd.grad(loss, f)
    np.testing.assert_allclose(got.reshape(-1, 16).numpy(), want.numpy(),
                               atol=2e-6 * float(want.abs().max()))


def test_sharded_grid_operator_matches_the_unsharded_operator():
    """``ShardedGridDtecLinear`` (Hermite, paired) against the port's
    ``PairedDtecLinear`` on the whole field: g0 and J within 3e-6
    relative, Jᵀ within 2e-5 of its largest entry, and ⟨Jv, w⟩ = ⟨v, Jᵀw⟩."""
    _, _, grid, tm = chapman_world()
    o, d, rng = slant_rays(12, 24)
    _, tb = bundles(o, d)
    mesh = gs.grid_mesh(CPU8)
    op = gs.ShardedGridDtecLinear(mesh, gs.shard_field(mesh, tm), grid, tb,
                                  4, 0)
    ref = ttec.dtec_paired_linear(tm, grid, tb, 4, 0, "hermite", "cubic")
    v = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    for a, b in ((op.g0, ref.g0), (op.apply(v), ref.apply(v))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-6,
                                   atol=3e-6 * float(b.abs().max()))
    jt, jt_ref = op.apply_t(w), ref.apply_t(w)
    np.testing.assert_allclose(jt.numpy(), jt_ref.numpy(),
                               atol=2e-5 * float(jt_ref.abs().max()))
    lhs = float(torch.dot(op.apply(v).double(), w.double()))
    rhs = float(torch.sum(v.double() * jt.double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_kept_points_and_geometry_build_their_plans_once():
    """A ``ShardedPoints`` passed in place of the points serves two fields
    and two backward passes over one set of K7ᵀ plans, with the values
    and gradients of fresh points; a kept ``ShardedGridGeometry`` gives
    the paired Hermite form the values and gradients of a fresh one, and
    keeps its plans."""
    _, _, grid, tf = world()
    rng = np.random.default_rng(12)
    pts = torch.from_numpy(rng.uniform((-210, -210, -20), (210, 210, 820),
                                       (400, 3)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=400).astype(np.float32))
    mesh = gs.grid_mesh(CPU8)
    kept = gs.ShardedPoints(mesh, grid, pts)
    plans = None
    for field in (tf, 2.0 * tf):
        f = field.clone().requires_grad_(True)
        sf = gs.shard_field(mesh, f)
        v_k = gs.interp_sharded(mesh, sf, grid, kept)
        v_f = gs.interp_sharded(mesh, sf, grid, pts)
        assert torch.equal(v_k, v_f)
        (g_k,) = torch.autograd.grad(torch.dot(v_k, cv), f)
        (g_f,) = torch.autograd.grad(torch.dot(v_f, cv), f)
        assert torch.equal(g_k, g_f)
        plans = plans or kept.plans()
        assert kept.plans() is plans

    _, _, grid, tm = chapman_world()
    o, d, rng = slant_rays(9, 24)
    _, tb = bundles(o, d)
    geo = gs.ShardedGridGeometry(mesh, grid, tb, 2, 0, "hermite")
    y = torch.from_numpy(rng.normal(size=(12, 2)).astype(np.float32))
    for scale in (1.0, 1.01):
        f = (scale * tm).requires_grad_(True)
        sf = gs.shard_field(mesh, f)
        a = gs.dtec_paired_hermite_sharded(mesh, sf, grid, tb, 2, 0,
                                           geometry=geo)
        b = gs.dtec_paired_hermite_sharded(mesh, sf, grid, tb, 2, 0)
        assert a.shape == (12, 2) and torch.equal(a, b)
        (g_a,) = torch.autograd.grad(torch.sum(a * y), f)
        (g_b,) = torch.autograd.grad(torch.sum(b * y), f)
        assert torch.equal(g_a, g_b)
    assert geo.pts._plans is not None and geo.ends._plans is not None


def test_tec_forms_are_the_operators_forward_and_transpose():
    """Each sharded TEC form is its ``ShardedGridDtecLinear``'s g0, and
    its autograd gradient is the operator's Jᵀ, bitwise: one J and Jᵀ
    over the sharded grid."""
    _, _, grid, tm = chapman_world()
    o, d, rng = slant_rays(10, 24)
    _, tb = bundles(o, d)
    mesh = gs.grid_mesh(CPU8)
    for form, nd, quad in ((gs.tec_sharded, None, "simpson"),
                           (gs.dtec_paired_sharded, 4, "simpson"),
                           (gs.tec_hermite_sharded, None, "hermite"),
                           (gs.dtec_paired_hermite_sharded, 4, "hermite")):
        f = tm.clone().requires_grad_(True)
        sf = gs.shard_field(mesh, f)
        out = form(mesh, sf, grid, tb) if nd is None else form(
            mesh, sf, grid, tb, nd, 0)
        op = gs.ShardedGridDtecLinear(mesh, sf, grid, tb, nd, 0, quad)
        assert torch.equal(out.reshape(-1), op.g0)
        y = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        (g,) = torch.autograd.grad(torch.sum(out * y), f)
        assert torch.equal(g, op.apply_t(y))
