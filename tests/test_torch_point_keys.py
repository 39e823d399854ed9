"""The point order's keys made from the points, and K6q's three-lane
contraction, checked on the CPU.

The key kernel (``kernels.point_order_keys``) recomputes each point's
stencil base cell from the points by the model's own rule; its plain
version (``kernels.point_order_keys_plain`` over the model's
``base_cell``, which its set-up shares) must be bitwise the key the
model's set-up holds in its rows (``kernels.point_order_keys_ref`` over
``row_setup``: the base row ri[:, base] and z tap zi[:, 1]) for cubic, zp
and zpc, on and off lattice nodes, at exact halves (round half to even),
outside the grid on every side, in the last cell, with NaN and infinite
coordinates, on a dyadic 12 × 9 × 7 grid and a non-dyadic 16 × 18 × 20
one; so the ``PointOrder`` is bitwise the one the rows' keys give.

K6q runs three lanes a point, ten points a warp: lane l of a point loads
z tap l of the 9 rows, two rounds of shuffles hand lane a the taps of x
plane a, and the point's lanes sum the planes in ``quad_contract``'s
order. A numpy emulation of that warp, lane by lane (the coordinates'
load and shuffles, the idle lanes, each lane's own taps, the shuffles'
source lanes and the taps each sends, the planes' exchange, the lanes
that write), is bitwise ``interp_rows_with_grad_taps_ref`` at whole and
ragged warps, so a tap routed to the wrong lane fails here; and within
``test_torch_triquadratic.py``'s tolerance (5e-7·max|coef| the value,
over the smallest spacing the gradient) of the JAX
``interp_rows_with_grad``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import triquadratic as jquad
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert, kernels
from ionotomo_tpu_torch.core import (boxspline, tricubic, triquadratic,
                                     zpcubic)
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

MODELS = {"cubic": tricubic, "zp": boxspline, "zpc": zpcubic}
GRIDS = {
    # dyadic: lattice nodes and exact halves are exact in f32
    "dyadic_12x9x7": ((12, 9, 7), (-96.0, -40.0, 0.0), (16.0, 8.0, 32.0)),
    "non_dyadic_16x18x20": ((16, 18, 20), (-151.3, 7.7, 60.1),
                            (9.7, 13.1, 41.3)),
}


def _points(shape, origin, spacing, seed):
    """Edge-case points (uniform in and around the grid, lattice nodes,
    half-lattice points, the boundary cells) and, in index space: every
    side's outside, the last cell and its far face, exact halves of each
    axis, NaN and infinite coordinates."""
    rng = np.random.default_rng(seed)
    nn = np.asarray(shape, np.float64)
    t = [rng.uniform(-3.0, nn + 2.0, (400, 3))]
    for d in range(3):
        for side in (-2.5, -0.5, nn[d] - 0.5, nn[d] + 1.5):
            u = rng.uniform(0, nn - 1, (20, 3))
            u[:, d] = side
            t.append(u)
    t.append(nn - 1 - rng.uniform(0, 1, (50, 3)))           # the last cell
    t.append(np.tile(nn - 1, (1, 1)))                         # its far face
    halves = rng.integers(0, nn - 1, (60, 3)) + 0.5
    t.append(halves)
    odd = np.array([[np.nan, 1.0, 1.0], [1.0, np.nan, 1.0],
                    [1.0, 1.0, np.nan], [np.nan] * 3,
                    [np.inf, 1.0, -np.inf], [-np.inf, np.inf, 2.0]])
    t.append(odd)
    pts = np.asarray(origin) + np.concatenate(t) * np.asarray(spacing)
    return np.concatenate([
        edge_case_points(shape, origin, spacing, 800, rng),
        pts.astype(np.float32)])


@pytest.fixture(scope="module", params=list(GRIDS))
def world(request):
    shape, origin, spacing = GRIDS[request.param]
    grid = Grid3D.create(origin, spacing, shape, device="cpu")
    pts = torch.from_numpy(_points(shape, origin, spacing, 5))
    return grid, pts


@pytest.mark.parametrize("model", list(MODELS))
def test_plain_keys_are_the_set_up_rows_bitwise(world, model):
    """The key from the points is the base row and z tap of the model's
    own set-up, for every point."""
    grid, pts = world
    mod = MODELS[model]
    ri, _, zi, _ = mod.row_setup(grid, pts)
    want = kernels.point_order_keys_ref(ri, zi, mod.BASE_TRANSLATE,
                                        grid.shape)
    got = kernels.point_order_keys_plain(pts, grid, mod.base_cell)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    assert int(got.min()) >= 0 and int(got.max()) < n_rows * nz


@pytest.mark.parametrize("model", list(MODELS))
def test_point_order_is_the_rows_keyed_order_bitwise(world, model):
    """The model's ``PointOrder`` (keys from the points) is the stable
    sort of the rows' keys, its inputs permuted into it."""
    grid, pts = world
    mod = MODELS[model]
    setup = mod.row_setup(grid, pts)
    ri, _, zi, _ = setup
    want = torch.sort(kernels.point_order_keys_ref(
        ri, zi, mod.BASE_TRANSLATE, grid.shape), stable=True).indices
    po = mod.point_order(grid, pts, *setup)
    assert torch.equal(po.order, want.to(torch.int32))
    assert po.of(*setup)
    for got, t in zip((po.ri, po.wxy, po.zi, po.wz), setup):
        # the bits: the weights of a NaN point are NaN
        assert torch.equal(got.view(torch.int32), t[want].view(torch.int32))


def test_the_rules_are_the_models_own():
    assert {m.POINT_RULE for m in MODELS.values()} == set(kernels.POINT_RULES)
    for name, mod in MODELS.items():
        assert mod.POINT_RULE == name


def test_the_key_kernel_refuses_cpu_tensors():
    shape, origin, spacing = GRIDS["dyadic_12x9x7"]
    grid = Grid3D.create(origin, spacing, shape, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.point_order_keys(torch.zeros((4, 3)), grid, "cubic")


# --- K6q's three lanes a point ----------------------------------------------

SHAPE = (16, 16, 16)
ORIGIN = (-1.0, 0.5, 2.0)
SPACING = (0.5, 0.25, 0.125)


@pytest.fixture(scope="module")
def quad_world():
    rng = np.random.default_rng(62)
    field = rng.normal(size=SHAPE).astype(np.float32)
    coef = np.array(jquad.prefilter(jnp.asarray(field)))
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    hi = np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    pts = np.concatenate([
        (np.asarray(ORIGIN) + rng.uniform(0, 1, (600, 3)) * hi),
        edge_case_points(SHAPE, ORIGIN, SPACING, 1600, rng)]
    ).astype(np.float32)
    return dict(coef2d=coef.reshape(-1, SHAPE[2]), jg=jg,
                tg=convert.grid_from_numpy(jg, device="cpu"), pts=pts,
                cmax=float(np.abs(coef).max()))


def _pick3(k, x):
    """pick3(k, x[0], x[1], x[2]) of each lane."""
    return np.where(k == 0, x[0], np.where(k == 1, x[1], x[2]))


def _k6q_warps(table, grid, points):
    """quad_value_grad_lanes_kernel emulated lane by lane in f32: (W, 32)
    lanes, ten points a warp. Returns (value (N,), grad (N, 3)) as the
    lanes write them, NaN where no lane wrote."""
    n = points.shape[0]
    flat = points.numpy().reshape(-1)
    idx, frac, row_idx = triquadratic._row_neighborhood(grid, points)
    taps = table[row_idx.long()[:, :, None], idx[:, 2].long()[:, None, :]
                 ].reshape(-1, 3, 3, 3).numpy()          # (N, x, y, z tap)
    w = [triquadratic._qb_weights(frac[:, d]).numpy() for d in range(3)]
    dw = [triquadratic._qb_dweights(frac[:, d]).numpy() for d in range(3)]
    lane = np.arange(32)[None, :]
    first = np.arange(-(-n // 10))[:, None] * 10
    count = np.minimum(10, n - first)
    idle = lane >= 3 * count
    q = np.where(idle, 0, lane)
    pt = q // 3
    a = q - 3 * pt
    l0 = 3 * pt

    def shfl(x, src):                   # __shfl_sync of every lane
        return np.take_along_axis(x, src, axis=1)

    f = np.where(idle, np.float32(0), flat[np.minimum(3 * first + lane,
                                                      3 * n - 1)])
    p = first + pt                       # each lane's point
    for d in range(3):                   # the coordinates' shuffles
        assert np.array_equal(shfl(f, l0 + d).view(np.int32),
                              flat[3 * p + d].view(np.int32))
    # own[..., pa, b]: this lane's z tap a of row (pa, b)
    own = np.take_along_axis(taps[p], a[..., None, None, None],
                             axis=-1)[..., 0]
    t = np.zeros(own.shape[:2] + (3, 3), np.float32)             # [b][l]
    for b in range(3):
        col = [own[..., pa, b] for pa in range(3)]
        mine = _pick3(a, col)
        r1 = shfl(_pick3((a + 2) % 3, col), l0 + (a + 1) % 3)
        r2 = shfl(_pick3((a + 1) % 3, col), l0 + (a + 2) % 3)
        t[..., b, 0] = np.where(a == 0, mine, np.where(a == 1, r2, r1))
        t[..., b, 1] = np.where(a == 1, mine, np.where(a == 2, r2, r1))
        t[..., b, 2] = np.where(a == 2, mine, np.where(a == 0, r2, r1))
    zero = np.zeros(own.shape[:2], np.float32)
    czy, czy_dy, czy_dz = zero, zero, zero           # quad_plane
    for b in range(3):
        cz, cz_d = zero, zero
        for l in range(3):
            cz = cz + t[..., b, l] * w[2][p, l]
            cz_d = cz_d + t[..., b, l] * dw[2][p, l]
        czy = czy + cz * w[1][p, b]
        czy_dy = czy_dy + cz * dw[1][p, b]
        czy_dz = czy_dz + cz_d * w[1][p, b]
    v, dx, dy, dz = zero, zero, zero, zero           # quad_add_plane
    for k in range(3):
        s, s_dy, s_dz = (shfl(x, l0 + k) for x in (czy, czy_dy, czy_dz))
        v = v + s * w[0][p, k]
        dx = dx + s * dw[0][p, k]
        dy = dy + s_dy * w[0][p, k]
        dz = dz + s_dz * w[0][p, k]
    sp = grid.spacing.numpy()
    g = np.stack([dx / sp[0], dy / sp[1], dz / sp[2]])
    value = np.full(n, np.nan, np.float32)
    grad = np.full(3 * n, np.nan, np.float32)
    live = ~idle
    lead = live & (a == 0)
    value[p[lead]] = v[lead]
    grad[(3 * first + lane)[live]] = _pick3(a, g)[live]
    return torch.from_numpy(value), torch.from_numpy(grad.reshape(n, 3))


@pytest.mark.parametrize("n", [1, 7, 10, 11, 29, None])
def test_k6q_lanes_are_the_taps_twin_bitwise(quad_world, n):
    """K6q's warp, emulated lane by lane, at one point, ragged and whole
    warps and all 2,200 points: every value and gradient component
    written, bitwise ``interp_rows_with_grad_taps_ref``."""
    table = torch.from_numpy(quad_world["coef2d"])
    pts = torch.from_numpy(quad_world["pts"][:n])
    grid = quad_world["tg"]
    v, g = _k6q_warps(table, grid, pts)
    want_v, want_g = triquadratic.interp_rows_with_grad_taps_ref(table, grid,
                                                                 pts)
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(g.view(torch.int32), want_g.view(torch.int32))


def test_k6q_lanes_match_jax(quad_world):
    """The emulated warp against the JAX ``interp_rows_with_grad``."""
    table = torch.from_numpy(quad_world["coef2d"])
    v, g = _k6q_warps(table, quad_world["tg"],
                      torch.from_numpy(quad_world["pts"]))
    jv, jgr = jquad.interp_rows_with_grad(jnp.asarray(quad_world["coef2d"]),
                                          quad_world["jg"], jnp.asarray(
                                              quad_world["pts"]))
    tol = 5e-7 * quad_world["cmax"]
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / min(SPACING))
