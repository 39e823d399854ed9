"""K1's redesign checked on the CPU: the z-tap-packed zp table and the
evaluator that reads it, and the ray order, against the port's plain
evaluator and tracer and the JAX package's ``core.boxspline``.

The packed evaluator (``pack_z_taps_ref`` + ``interp_rows_with_grad_
packed_ref``) contracts in zp_eval.cuh's order, as its unpacked twin
``interp_rows_with_grad_taps_ref`` does, so the two agree bit for bit;
both, and the plain K1e (``interp_rows_with_grad_ref``, the dense z
band), are held to the reference's ``interp_rows_with_grad`` at
edge-case and random points with the tolerances of
``test_torch_boxspline.py`` (5e-7·max|coef|, over the smallest spacing
for the gradient). A ray order changes which rays share a warp and
nothing else: the plain zp tracer over permuted rays gives the permuted
outputs bit for bit. One module-scoped world on its own
``np.random.default_rng``; grids of 16³-20³.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import boxspline as jbox
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert, kernels
from ionotomo_tpu_torch.configs import make_rays
from ionotomo_tpu_torch.core import boxspline as tbox
from ionotomo_tpu_torch.geometry import fermat, rays
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

SHAPE = (16, 18, 20)
ORIGIN = (-512.0, -576.0, 0.0)
SPACING = (64.0, 64.0, 64.0)          # dyadic: u±v = 0 points exact


@pytest.fixture(scope="module")
def world():
    """JAX grid, port grid, a prefiltered random field's table (numpy)
    and two point sets."""
    rng = np.random.default_rng(71)
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    tg = convert.grid_from_numpy(jg, device="cpu")
    field = rng.normal(size=SHAPE).astype(np.float32)
    coef = np.array(jbox.prefilter(jnp.asarray(field)))
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    points = {
        "edge_case": edge_case_points(SHAPE, ORIGIN, SPACING, 4000, rng),
        "random": (np.asarray(ORIGIN) + rng.uniform(0, 1, (4000, 3)) * hi
                   ).astype(np.float32),
    }
    return jg, tg, field, coef.reshape(-1, SHAPE[2]), points


def test_pack_holds_each_bases_three_taps_and_a_zero(world):
    *_, table, _ = world
    packed = tbox.pack_z_taps_ref(torch.from_numpy(table)).numpy()
    nz = SHAPE[2]
    assert packed.shape == (nz - 2, table.shape[0], 4)
    for b in range(1, nz - 1):
        np.testing.assert_array_equal(packed[b - 1, :, :3],
                                      table[:, b - 1:b + 2])
        assert not packed[b - 1, :, 3].any()


@pytest.mark.parametrize("where", ["edge_case", "random"])
def test_packed_evaluator_is_bitwise_the_taps_twin_and_matches_jax(world,
                                                                   where):
    jg, tg, _, table, points = world
    pts = points[where]
    tt, tp = torch.from_numpy(table), torch.from_numpy(pts)
    v, g = tbox.interp_rows_with_grad_taps_ref(tt, tg, tp)
    pv, pg = tbox.interp_rows_with_grad_packed_ref(
        tbox.pack_z_taps_ref(tt), tg, tp)
    assert torch.equal(pv, v) and torch.equal(pg, g)
    jv, jgr = jbox.interp_rows_with_grad(jnp.asarray(table), jg,
                                         jnp.asarray(pts))
    tol = 5e-7 * np.abs(table).max()
    for val, grad in ((pv, pg), tbox.interp_rows_with_grad_ref(tt, tg, tp)):
        np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgr), rtol=0,
                                   atol=tol / min(SPACING))


@pytest.mark.parametrize("keep_path", [False, True])
def test_a_ray_order_leaves_the_plain_zp_tracer_bitwise(world, keep_path):
    """Leapfrog over the zp model, the plain tracer, rays in their own
    order and in ``ray_order``: the same endpoints (or paths) and TEC per
    ray, bit for bit."""
    _, tg, field, _, _ = world
    m = torch.from_numpy(field) * 0.1 - 3.0
    ants, dirs = make_rays(12, 10)
    o, d = rays.make_ray_batch(torch.from_numpy(ants), torch.from_numpy(dirs))
    perm = kernels.ray_order(o, d, tg).long()
    assert sorted(perm.tolist()) == list(range(o.shape[0]))
    kw = dict(n_steps=24, keep_path=keep_path, method="leapfrog",
              interp="zp")
    b, t = fermat.trace_rays_ref(m, tg, o, d, 150e6, 1000.0, **kw)
    bp, tp = fermat.trace_rays_ref(m, tg, o[perm], d[perm], 150e6, 1000.0,
                                   **kw)
    assert torch.equal(bp.points, b.points[perm])
    assert torch.equal(tp, t[perm])
