"""Parity of the port's transposes and linearised dTEC operator (plain
PyTorch versions on the CPU) with the JAX package on the same
numpy-seeded inputs: ``rows_value``'s autograd backward against
``jax.vjp`` of ``rows_value_p`` (its hand-written transpose), the zp
value+gradient transpose against ``jax.vjp`` of
``boxspline.interp_rows_with_grad``, ``prefilter_transpose`` against
``jax.linear_transpose``, and J / Jᵀ against ``solvers._dtec_operator``.
Also the row plans the K3 and K1eᵀ kernels reduce over, and the gather
probe's plain version.

Tolerances: transposes 1e-5·max|out| (f32 sums in another order;
measured ≤ 1.2e-7); operators 1e-4·max|out| and the adjoint identity
1e-4 relative (PRECISION.md; measured ≤ 2e-6 and ≤ 1e-6).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import boxspline as jbox, tricubic as jtri
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox, tricubic as ttri
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import rays as trays
from ionotomo_tpu_torch.probes import gather as tgather

from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _rows_inputs(k, l, n=600, rows=70, nz=14, seed=0):
    """Random rows_value inputs; every point repeats its first row index
    once (the duplicates clamping makes at the grid's xy edges)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, nz)).astype(np.float32)
    ri = rng.integers(0, rows, (n, k)).astype(np.int32)
    ri[:, k - 1] = ri[:, 0]
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    zi = (rng.integers(0, nz - l + 1, (n, 1)) + np.arange(l)).astype(np.int32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    ct = rng.normal(size=(n,)).astype(np.float32)
    return table, ri, wxy, zi, wz, ct


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)],
                         ids=["zp", "cubic"])
def test_rows_value_backward_matches_jax_vjp(k, l, xy_first):
    table, ri, wxy, zi, wz, ct = _rows_inputs(k, l)
    _, vjp = jax.vjp(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    leaf = torch.from_numpy(table).requires_grad_(True)
    out = ttri.rows_value(leaf, *map(torch.from_numpy, (ri, wxy, zi, wz)),
                          xy_first=xy_first)
    (got,) = torch.autograd.grad(out, leaf, torch.from_numpy(ct))
    assert _rel_err(got, want) <= 1e-5
    direct = ttri.rows_value_transpose(
        *map(torch.from_numpy, (ct, ri, wxy, zi, wz)), table.shape)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)],
                         ids=["zp", "cubic"])
def test_rows_value_weight_gradients_match_jax_vjp(k, l, xy_first):
    """Gradients with respect to the weights wxy and wz (and the table
    beside them) through the plain twin and autograd, against ``jax.vjp``
    of the reference's ``rows_value`` (its derived-AD fallback)."""
    table, ri, wxy, zi, wz, ct = _rows_inputs(k, l, n=300, seed=7)
    # the reference's impl clamps no index: keep every index in range
    ri = np.clip(ri, 0, table.shape[0] - 1)
    zi = np.clip(zi, 0, table.shape[1] - 1)
    _, vjp = jax.vjp(lambda t, a, b: jtri.rows_value(
        t, jnp.asarray(ri), a, jnp.asarray(zi), b, xy_first=xy_first),
        *map(jnp.asarray, (table, wxy, wz)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (table, wxy, wz)]
    out = ttri.rows_value(leaves[0], torch.from_numpy(ri), leaves[1],
                          torch.from_numpy(zi), leaves[2], xy_first)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, g, w in zip(("table", "wxy", "wz"), got, want):
        assert _rel_err(g, w) <= 1e-5, name
    # a weight alone needing a gradient takes the same route
    (g_wz,) = torch.autograd.grad(ttri.rows_value(
        torch.from_numpy(table), torch.from_numpy(ri), torch.from_numpy(wxy),
        torch.from_numpy(zi), leaves[2], xy_first), leaves[2],
        torch.from_numpy(ct))
    assert _rel_err(g_wz, want[2]) <= 1e-5


def _reduce_by_plan(plan, contributions, n_rows, nz):
    """What the K3 / K1eᵀ kernels compute from a plan: each row sums the
    contributions of its pairs in the plan's order. ``contributions(p)``
    gives the (z, value) list of flat pair p."""
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    out = np.zeros((n_rows, nz), np.float32)
    for r in range(n_rows):
        for p in order[offsets[r]:offsets[r + 1]]:
            for z, c in contributions(int(p)):
                if 0 <= z < nz:
                    out[r, z] += c
    return out


def test_row_plan_groups_pairs_by_row_in_order():
    table, ri, wxy, zi, wz, ct = _rows_inputs(8, 3, n=200, rows=30)
    ri[0, 2] = 99                         # outside the table: dropped
    plan = ttri.build_row_plan(torch.from_numpy(ri), 30)
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    assert plan.order.dtype == plan.offsets.dtype == torch.int32
    assert offsets[0] == 0 and offsets[-1] == ri.size - 1
    for r in range(30):
        group = order[offsets[r]:offsets[r + 1]]
        assert np.all(ri.reshape(-1)[group] == r)
        assert np.all(np.diff(group) > 0)

    def contributions(p):
        n, k = divmod(p, 8)
        return [(zi[n, l], ct[n] * wxy[n, k] * wz[n, l]) for l in range(3)]

    got = _reduce_by_plan(plan, contributions, 30, table.shape[1])
    want = ttri.rows_value_transpose_ref(
        *map(torch.from_numpy, (ct, ri, wxy, zi, wz)), (30, table.shape[1]))
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _zp_grid_points(n=800, seed=0):
    jg = JGrid.from_bounds((-100.0, -80.0, 0.0), (100.0, 90.0, 500.0),
                           (10, 11, 12))
    rng = np.random.default_rng(seed)
    pts = edge_case_points(jg.shape, np.asarray(jg.origin),
                           np.asarray(jg.spacing), n, rng)
    return jg, convert.grid_from_numpy(jg, device="cpu"), pts, rng


def test_zp_value_grad_transpose_matches_jax_vjp():
    """Boundary points included: there the 8 rows of a point repeat."""
    jg, tg, pts, rng = _zp_grid_points()
    n = pts.shape[0]
    coef = rng.normal(size=(110, 12)).astype(np.float32)
    cv = rng.normal(size=(n,)).astype(np.float32)
    cg = rng.normal(size=(n, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda c: jbox.interp_rows_with_grad(
        c, jg, jnp.asarray(pts)), jnp.asarray(coef))
    want = np.asarray(vjp((jnp.asarray(cv), jnp.asarray(cg)))[0])
    got = tbox.interp_rows_with_grad_transpose(
        tg, *map(torch.from_numpy, (pts, cv, cg)))
    assert _rel_err(got, want) <= 1e-5


def test_endpoint_plan_reduces_to_the_transpose():
    """The K1eᵀ plan: pair p = n·8 + t is translate t < 7 of point n, and
    reducing its contributions per row gives the transpose."""
    _, tg, pts, rng = _zp_grid_points(n=200, seed=1)
    n = pts.shape[0]
    tp = torch.from_numpy(pts)
    cv = rng.normal(size=(n,)).astype(np.float32)
    cg = rng.normal(size=(n, 3)).astype(np.float32)
    plan = tbox.endpoint_plan(tg, tp)
    assert plan.order.shape == (n * tbox.ZP_LIVE_TRANSLATES,)
    bx, by, bz, u, v, w = tbox._neighborhood(tg, tp)
    _, _, wxy, wu, wv = tbox._xy_weights(u, v, with_grad=True)
    qb, dqb = tbox._qb_weights(w).numpy(), tbox._qb_dweights(w).numpy()
    sp = tg.spacing.numpy()
    wxy, wu, wv, bz = wxy.numpy(), wu.numpy(), wv.numpy(), bz.numpy()

    def contributions(p):
        i, t = divmod(p, plan.stride)
        gx, gy, gz = cg[i] / sp
        return [(bz[i] - 1 + l,
                 wxy[i, t] * (cv[i] * qb[i, l] + gz * dqb[i, l])
                 + wu[i, t] * gx * qb[i, l] + wv[i, t] * gy * qb[i, l])
                for l in range(3)]

    got = _reduce_by_plan(plan, contributions, 110, 12)
    want = tbox.interp_rows_with_grad_transpose_ref(
        tg, tp, torch.from_numpy(cv), torch.from_numpy(cg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("shape", [(9, 7, 11), (3, 4, 5)])
def test_prefilter_transpose_matches_jax_linear_transpose(order, shape):
    rng = np.random.default_rng(order)
    y = rng.normal(size=shape).astype(np.float32)
    lt = jax.linear_transpose(lambda f: jbox.prefilter(f, order),
                              jnp.zeros(shape, jnp.float32))
    want = np.asarray(lt(jnp.asarray(y))[0])
    got = tbox.prefilter_transpose(torch.from_numpy(y), order)
    assert _rel_err(got, want) <= 1e-5


NA, ND = 5, 4


def _operator_world(seed=0):
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-80, 80, (NA, 2)),
                           np.zeros((NA, 1))], -1)
    zen = rng.uniform(0.05, 0.45, ND)
    az = rng.uniform(0, 2 * np.pi, ND)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    jg = jchapman.grid_enclosing_rays(ants, dirs, max_length_km=900.0,
                                      shape=(14, 15, 16), h_min_km=0.0)
    m0 = (np.asarray(jchapman.log_parametrize(jchapman.chapman_field(jg)))
          + 0.2 * rng.normal(size=jg.shape)).astype(np.float32)
    o, d = jrays.make_ray_batch(ants, dirs)
    jb = jrays.sample_straight_rays(o, d, max_length_km=900.0, n_samples=33)
    tb = trays.RayBundle(torch.from_numpy(np.array(jb.points)),
                         torch.from_numpy(np.array(jb.ds)))
    return jg, convert.grid_from_numpy(jg, device="cpu"), jb, tb, m0, rng


@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_linear_operator_matches_jax(quadrature):
    jg, tg, jb, tb, m0, rng = _operator_world()
    x = rng.normal(size=jg.shape).astype(np.float32)
    y = rng.normal(size=(NA * ND,)).astype(np.float32)
    @jax.jit
    def reference(m, x, y):
        apply, applyt, g0 = jsolvers._dtec_operator(
            jg, jb, ND, 0, m, quadrature=quadrature, interp="zp")
        return apply(x), applyt(y), g0

    want_jx, want_jty, g0 = reference(*map(jnp.asarray, (m0, x, y)))
    op = ttec.dtec_paired_linear(torch.from_numpy(m0), tg, tb, ND, 0,
                                 quadrature, "zp")
    assert _rel_err(op.g0, g0) <= 1e-4
    jx = op.apply(torch.from_numpy(x))
    jty = op.apply_t(torch.from_numpy(y))
    assert _rel_err(jx, want_jx) <= 1e-4
    assert _rel_err(jty, want_jty) <= 1e-4
    lhs = float(np.dot(jx.numpy().astype(np.float64), y))
    rhs = float(np.sum(x.astype(np.float64) * jty.numpy()))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    # the plain operator is the same computation on CPU tensors
    plain = ttec.dtec_paired_linear_ref(torch.from_numpy(m0), tg, tb, ND, 0,
                                        quadrature, "zp")
    np.testing.assert_array_equal(plain.apply(torch.from_numpy(x)).numpy(),
                                  jx.numpy())
    np.testing.assert_array_equal(plain.apply_t(torch.from_numpy(y)).numpy(),
                                  jty.numpy())


def test_linear_operator_g0_is_the_forward():
    jg, tg, jb, tb, m0, _ = _operator_world(seed=1)
    op = ttec.dtec_paired_linear(torch.from_numpy(m0), tg, tb, ND, 0,
                                 "hermite", "zp")
    fwd = ttec.dtec_paired_q(torch.from_numpy(m0), tg, tb, ND, 0, "hermite",
                             "zp")
    np.testing.assert_array_equal(op.g0.numpy(), fwd.reshape(-1).numpy())


def test_log_ne_at_matches_jax():
    jg, tg, jb, tb, m0, _ = _operator_world(seed=2)
    pts = np.array(jb.points)[:, ::4].reshape(NA, ND, -1, 3)
    want = np.asarray(jtec.log_ne_at(jnp.asarray(m0), jg, jnp.asarray(pts),
                                     "zp"))
    got = ttec.log_ne_at(torch.from_numpy(m0), tg, torch.from_numpy(pts),
                         "zp")
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * np.abs(m0).max()


@pytest.mark.parametrize("rows", [8, 256])
def test_vector_gather_plain_matches_take_along_axis(rows):
    """The probe's gather on the CPU against what the JAX probe's Pallas
    kernel computes (``jnp.take_along_axis(axis=0)``): bitwise."""
    table, idx = tgather.probe_inputs(rows, 128, "cpu")
    want = np.asarray(jnp.take_along_axis(jnp.asarray(table.numpy()),
                                          jnp.asarray(idx.numpy()), axis=0))
    np.testing.assert_array_equal(tgather.vector_gather(table, idx).numpy(),
                                  want)


def test_gather_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tgather.main() != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA"):
        tgather.probe("cpu", rows=8)
