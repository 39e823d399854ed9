"""K2's redesign checked on the CPU: the point order a ray geometry keeps
for the row-gather value map, against the port's plain version and the
JAX package's ``tricubic.rows_value``.

The order (``kernels.point_order``: the points sorted by their stencil's
base cell, by row then z; a geometry keeps it with the inputs permuted
into it, ``tricubic.PointOrder``) changes which points share a warp and
nothing else, so the plain version over the ordered points, scattered
back, is the unordered result bit for bit, at zp's shape (K=8, L=3, xy
first) and cubic's (K=16, L=4, z first), on edge-case and on random
points; both are held to the reference with
``test_torch_rows_value.py``'s tolerance (1e-6·Σ|w_xy||w_z||T| per
point). One module-scoped world on its own ``np.random.default_rng``; a
16×18×20 grid.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu_torch import kernels
from ionotomo_tpu_torch.core import boxspline as tbox
from ionotomo_tpu_torch.core import tricubic as ttri
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

SHAPE = (16, 18, 20)
ORIGIN = (-512.0, -256.0, 0.0)
SPACING = (64.0, 32.0, 64.0)          # dyadic: lattice points exact
MODELS = {"zp": (tbox, True), "cubic": (ttri, False)}
N_EDGE = 3000                         # the world's edge-case points first
POINTS = {"edge_case": slice(0, N_EDGE), "random": slice(N_EDGE, None)}


@pytest.fixture(scope="module")
def world():
    """The port's grid, a random (nx*ny, nz) table and the set-up of
    edge-case and random points on both models."""
    rng = np.random.default_rng(83)
    grid = Grid3D.create(ORIGIN, SPACING, SHAPE, device="cpu")
    table = rng.normal(size=(SHAPE[0] * SHAPE[1], SHAPE[2])).astype(
        np.float32)
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    pts = np.concatenate([
        edge_case_points(SHAPE, ORIGIN, SPACING, N_EDGE, rng),
        (np.asarray(ORIGIN) + rng.uniform(0, 1, (3000, 3)) * hi)]
    ).astype(np.float32)
    setups = {name: mod.row_setup(grid, torch.from_numpy(pts))
              for name, (mod, _) in MODELS.items()}
    return grid, torch.from_numpy(table), pts, setups


def _setup(world, model, points):
    return tuple(t[POINTS[points]].contiguous()
                 for t in world[3][model])


def _points(world, points):
    return torch.from_numpy(world[2][POINTS[points]])


@pytest.mark.parametrize("points", list(POINTS))
@pytest.mark.parametrize("model", list(MODELS))
def test_point_order_is_a_repeatable_permutation_by_its_keys(world, model,
                                                             points):
    mod, _ = MODELS[model]
    grid, pts = world[0], _points(world, points)
    ri, wxy, zi, wz = _setup(world, model, points)
    base = mod.BASE_TRANSLATE
    order = kernels.point_order(pts, grid, mod.POINT_RULE, mod.base_cell)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(ri.shape[0]))
    assert torch.equal(order, kernels.point_order(pts, grid, mod.POINT_RULE,
                                                  mod.base_cell))
    key = kernels.point_order_keys_ref(ri, zi, base, SHAPE)
    assert bool((torch.diff(key[order.long()]) >= 0).all())
    # the model's order, its inputs permuted
    po = mod.point_order(grid, pts, ri, wxy, zi, wz)
    assert torch.equal(po.order, order) and po.of(ri, wxy, zi, wz)
    perm = order.long()
    for got, t in zip((po.ri, po.wxy, po.zi, po.wz), (ri, wxy, zi, wz)):
        assert got.is_contiguous() and torch.equal(got, t[perm])


@pytest.mark.parametrize("model", list(MODELS))
def test_point_order_keys_are_the_base_cell(world, model):
    """The key is the stencil's base cell (the cell the point lies in,
    clamped as each model clamps it), row-major."""
    grid, _, pts, setups = world
    mod, _ = MODELS[model]
    ri, _, zi, _ = setups[model]
    t = torch.from_numpy(pts)
    if model == "zp":
        bx, by, bz = tbox._neighborhood(grid, t)[:3]
    else:
        idx, _ = ttri._neighborhood(grid, t)
        bx, by, bz = idx[:, 0, 1], idx[:, 1, 1], idx[:, 2, 1]
    nx, ny, nz = SHAPE
    want = ((bx.long() * ny + by.long()) * nz + bz.long()).numpy()
    got = kernels.point_order_keys_ref(ri, zi, mod.BASE_TRANSLATE,
                                       SHAPE).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("points", list(POINTS))
@pytest.mark.parametrize("model", list(MODELS))
def test_ordered_gather_scattered_back_is_bitwise_and_matches_jax(
        world, model, points):
    table = world[1]
    mod, xy_first = MODELS[model]
    grid, pts = world[0], _points(world, points)
    ri, wxy, zi, wz = _setup(world, model, points)
    want = ttri.rows_value_ref(table, ri, wxy, zi, wz, xy_first)
    perm = kernels.point_order(pts, grid, mod.POINT_RULE,
                               mod.base_cell).long()
    got = torch.empty_like(want)
    got[perm] = ttri.rows_value_ref(table, ri[perm], wxy[perm], zi[perm],
                                    wz[perm], xy_first)
    assert torch.equal(got, want)
    # the CPU dispatch takes the plain version and leaves the order aside
    po = ttri.build_point_order(grid, pts, mod.POINT_RULE, mod.base_cell,
                                ri, wxy, zi, wz)
    assert torch.equal(ttri.rows_value(table, ri, wxy, zi, wz, xy_first,
                                       order=po), want)
    j = np.asarray(jtri.rows_value(*(jnp.asarray(a.numpy()) for a in
                                     (table, ri, wxy, zi, wz)),
                                   xy_first=xy_first))
    taps = table[ri.long()[:, :, None], zi.long()[:, None, :]]
    scale = (wxy.abs()[:, :, None] * wz.abs()[:, None, :]
             * taps.abs()).sum((1, 2)).numpy()
    assert np.all(np.abs(got.numpy() - j) <= 1e-6 * scale)


@pytest.mark.parametrize("model", list(MODELS))
def test_rows_value_takes_only_the_order_of_its_own_points(world, model):
    """A ``PointOrder`` goes with the tensors it was built from: given
    with equal copies of them, or with another point set of the same
    size, ``rows_value`` raises rather than gather the order's points."""
    mod, xy_first = MODELS[model]
    table = world[1]
    ri, wxy, zi, wz = _setup(world, model, "edge_case")
    po = mod.point_order(world[0], _points(world, "edge_case"), ri, wxy, zi,
                         wz)
    assert torch.equal(ttri.rows_value(table, ri, wxy, zi, wz, xy_first,
                                       order=po),
                       ttri.rows_value_ref(table, ri, wxy, zi, wz, xy_first))
    other = _setup(world, model, "random")
    for args in ((ri.clone(), wxy, zi, wz), other):
        assert not po.of(*args)
        with pytest.raises(ValueError, match="PointOrder of other"):
            ttri.rows_value(table, *args, xy_first, order=po)


def test_a_geometry_keeps_no_point_order_on_the_cpu(world):
    """The order is built at the first unbatched gather, on CUDA only; the
    CPU's plain operators take none."""
    from ionotomo_tpu_torch.forward import tec
    from ionotomo_tpu_torch.geometry import rays

    grid = world[0]
    o = torch.tensor([[0.0, 0.0, 0.0], [100.0, 50.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.3, 0.0, 0.9539392]])
    rb = rays.sample_straight_rays(o, d, n_samples=9, max_length_km=900.0)
    geo = tec.DtecGeometry(grid, rb, None, None, "hermite", "zp")
    assert geo.point_order() is None and geo.row_plan is None
