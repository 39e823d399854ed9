"""K1c's redesign checked on the CPU: the z-tap-packed table and the
evaluator that reads it, and the ray order, against the port's plain
evaluator and tracer and the JAX package's ``core.tricubic``.

The packed evaluator (``pack_z_taps_ref`` + ``interp_rows_with_grad_
packed_ref``) contracts in cubic_eval.cuh's order, as its unpacked twin
``interp_rows_with_grad_taps_ref`` does, so the two agree bit for bit;
both, and the plain K5 (``interp_rows_with_grad_ref``, the dense z band),
are held to the reference's ``interp_rows_with_grad`` at edge-case and
random points with the tolerances of ``test_torch_tricubic.py``
(1e-5·max|field|, over the smallest spacing for the gradient). A ray order changes which rays share
a warp and nothing else: the plain tracer over permuted rays gives the
permuted outputs bit for bit. One module-scoped world on its own
``np.random.default_rng``; grids of 16³-20³.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert, kernels
from ionotomo_tpu_torch.configs import make_rays
from ionotomo_tpu_torch.core import tricubic as ttri
from ionotomo_tpu_torch.geometry import fermat, rays
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

SHAPE = (16, 18, 20)
ORIGIN = (-400.0, -400.0, 0.0)
SPACING = (50.0, 45.0, 57.0)


@pytest.fixture(scope="module")
def world():
    """JAX grid, port grid, a random field (numpy) and two point sets."""
    rng = np.random.default_rng(61)
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    tg = convert.grid_from_numpy(jg, device="cpu")
    field = rng.normal(size=SHAPE).astype(np.float32)
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    points = {
        "edge_case": edge_case_points(SHAPE, ORIGIN, SPACING, 4000, rng),
        "random": (np.asarray(ORIGIN) + rng.uniform(0, 1, (4000, 3)) * hi
                   ).astype(np.float32),
    }
    return jg, tg, field, points


def test_pack_holds_each_bases_four_clamped_taps(world):
    _, _, field, _ = world
    f2d = field.reshape(-1, SHAPE[2])
    packed = ttri.pack_z_taps_ref(torch.from_numpy(f2d)).numpy()
    nz = SHAPE[2]
    assert packed.shape == (nz - 1, f2d.shape[0], 4)
    for b in range(nz - 1):
        taps = [max(b - 1, 0), b, b + 1, min(b + 2, nz - 1)]
        np.testing.assert_array_equal(packed[b], f2d[:, taps])


@pytest.mark.parametrize("where", ["edge_case", "random"])
def test_packed_evaluator_is_bitwise_the_plain_one_and_matches_jax(world,
                                                                   where):
    jg, tg, field, points = world
    pts = points[where]
    f2d = field.reshape(-1, SHAPE[2])
    tf, tp = torch.from_numpy(f2d), torch.from_numpy(pts)
    v, g = ttri.interp_rows_with_grad_taps_ref(tf, tg, tp)
    pv, pg = ttri.interp_rows_with_grad_packed_ref(
        ttri.pack_z_taps_ref(tf), tg, tp)
    assert torch.equal(pv, v) and torch.equal(pg, g)
    jv, jgr = jtri.interp_rows_with_grad(jnp.asarray(f2d), jg,
                                         jnp.asarray(pts))
    tol = 1e-5 * np.abs(field).max()
    for val, grad in ((pv, pg), ttri.interp_rows_with_grad_ref(tf, tg, tp)):
        np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgr), rtol=0,
                                   atol=tol / min(SPACING))


def _config2_rays(tg, n_ants=12, n_dirs=10):
    ants, dirs = make_rays(n_ants, n_dirs)
    return rays.make_ray_batch(torch.from_numpy(ants), torch.from_numpy(dirs))


def test_ray_order_groups_directions_and_sorts_by_its_keys(world):
    """A permutation, non-decreasing in the plain keys, and each
    direction's rays contiguous (the key puts the direction first)."""
    _, tg, _, _ = world
    o, d = _config2_rays(tg)
    order = kernels.ray_order(o, d, tg)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(o.shape[0]))
    key = kernels.ray_order_keys_ref(o, d, tg)
    assert bool((torch.diff(key[order.long()]) >= 0).all())
    k_dir = order.long() % 10           # ray r = antenna * n_dirs + k
    changes = int((torch.diff(k_dir) != 0).sum())
    assert changes == 9


def test_a_ray_order_leaves_the_plain_tracer_bitwise(world):
    """Leapfrog over the tricubic model, the plain tracer, rays in their
    own order and in ``ray_order``: the same endpoints and TEC per ray,
    bit for bit."""
    _, tg, field, _ = world
    m = torch.from_numpy(field) - 3.0
    o, d = _config2_rays(tg)
    perm = kernels.ray_order(o, d, tg).long()
    kw = dict(n_steps=24, keep_path=False, method="leapfrog", interp="cubic")
    b, t = fermat.trace_rays_ref(m, tg, o, d, 150e6, 1000.0, **kw)
    bp, tp = fermat.trace_rays_ref(m, tg, o[perm], d[perm], 150e6, 1000.0,
                                   **kw)
    assert torch.equal(bp.points, b.points[perm])
    assert torch.equal(tp, t[perm])
