"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda`` and skipped without one. This file imports no jax, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.) Sizes are small;
``chip_smoke.py`` checks the same at the main path's sizes.
"""
import numpy as np
import pytest
import torch

from ionotomo_tpu_torch import kernels
from ionotomo_tpu_torch.core import (boxspline, linalg, triquadratic,
                                     tricubic, zpcubic)
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.forward import tec
from ionotomo_tpu_torch.geometry import fermat, rays
from ionotomo_tpu_torch.inversion import priors, solvers
from ionotomo_tpu_torch.models import chapman
from ionotomo_tpu_torch.probes import gather

from ionotomo_tpu_torch.testing import (CUBIC_SOLVE_KERNELS,
                                        SERVING_KERNELS, SOLVE_KERNELS,
                                        edge_case_points, off_boundary)

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda", 0)


def _world(dev, n=24, seed=0):
    grid = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                              (n, n, n), device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(grid.meshgrid()).to(dev)
    for _ in range(3):
        k = torch.from_numpy(rng.uniform(-1, 1, 3) * 2 * np.pi
                             / np.array([300., 300., 400.])).float().to(dev)
        m = m + 0.2 * torch.sin(pts @ k + float(rng.uniform(0, 2 * np.pi)))
    return grid, m.contiguous()


def _rays(dev, n, seed=1):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-150, 150, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.6, n)
    az = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_zp_value_grad_matches_plain(dev):
    """K1e. Tolerance 1e-5·max|table| (value), over min spacing (grad)."""
    grid, m = _world(dev)
    coef = boxspline.prefilter(m).reshape(-1, grid.shape[2])
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        -450, 1150, (5000, 3)).astype(np.float32)).to(dev)
    before = kernels.launches["zp_value_grad"]
    v, g = boxspline.interp_rows_with_grad(coef, grid, pts)
    assert kernels.launches["zp_value_grad"] == before + 1
    vr, gr = boxspline.interp_rows_with_grad_ref(coef, grid, pts)
    tol = 1e-5 * float(coef.abs().max())
    assert float((v - vr).abs().max()) <= tol
    assert float((g - gr).abs().max()) <= tol / float(grid.spacing.min())


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)])
def test_rows_value_fwd_matches_plain(dev, k, l, xy_first):
    """K2 at the zp and cubic shapes. Tolerance 1e-5·Σ|w||T|."""
    rng = np.random.default_rng(4)
    n, rows_n, nz = 4000, 300, 20
    t = lambda a: torch.from_numpy(a).to(dev)
    table = t(rng.normal(size=(rows_n, nz)).astype(np.float32))
    ri = t(rng.integers(0, rows_n, (n, k)).astype(np.int32))
    zi = t((rng.integers(0, nz - l + 1, (n, 1))
            + np.arange(l)).astype(np.int32))
    wxy = t(rng.normal(size=(n, k)).astype(np.float32))
    wz = t(rng.normal(size=(n, l)).astype(np.float32))
    got = tricubic.rows_value(table, ri, wxy, zi, wz, xy_first)
    want = tricubic.rows_value_ref(table, ri, wxy, zi, wz, xy_first)
    scale = (wxy.abs()[:, :, None] * wz.abs()[:, None, :]
             * table[ri.long()[:, :, None], zi.long()[:, None, :]].abs()
             ).sum((1, 2))
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def _k2_case(dev, case, model):
    """(table, grid shape, setup) of a K2 check: the edge-case points of a
    random 24³ table, 3000 points of one cell (a skewed row) among 1000
    random ones, or points along a 6 × 6 × 1024 grid's z axis."""
    rng = np.random.default_rng(12)
    shape = (6, 6, 1024) if case == "nz1024" else (24, 24, 24)
    grid = Grid3D.create((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape,
                         device=dev)
    n_rows, nz = shape[0] * shape[1], shape[2]
    table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                             .astype(np.float32)).to(dev)
    if case == "edge_case":
        pts = edge_case_points(shape, (0.0,) * 3, (1.0,) * 3, 20000, rng)
    else:
        pts = rng.uniform(-1.0, np.asarray(shape, float), (1000, 3))
        if case == "skewed_row":
            pts = np.concatenate([pts, 7.25 + rng.uniform(0, 0.5,
                                                          (3000, 3))])
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    return table, grid, pts, model.row_setup(grid, pts)


@pytest.mark.parametrize("case", ["edge_case", "skewed_row", "nz1024"])
@pytest.mark.parametrize("model", [boxspline, tricubic, zpcubic],
                         ids=["zp", "cubic", "zpc"])
def test_rows_value_fwd_in_any_order_is_bitwise(dev, case, model):
    """K2 in ray order, over the model's point order and over a random
    order (each with its inputs permuted into it) bitwise K2's generic
    kernel in ray order (reached through inputs off a 16-byte boundary),
    which is within 1e-5·Σ|w||T| of the plain version; the order's keys
    and the permuted inputs bitwise their plain versions, each launch
    counted; a point order on the generic kernel refused."""
    table, grid, pts, (ri, wxy, zi, wz) = _k2_case(dev, case, model)
    shape = grid.shape
    xy_first = model is not tricubic
    want = kernels.rows_value_fwd(table, *map(off_boundary, (ri, wxy, zi,
                                                             wz)), xy_first)
    plain = tricubic.rows_value_ref(table, ri, wxy, zi, wz, xy_first)
    scale = (wxy.abs()[:, :, None] * wz.abs()[:, None, :]
             * table[ri.long()[:, :, None], zi.long()[:, None, :]].abs()
             ).sum((1, 2))
    assert bool(((want - plain).abs() <= 1e-5 * scale).all())
    assert torch.equal(kernels.rows_value_fwd(table, ri, wxy, zi, wz,
                                              xy_first), want)
    before = dict(kernels.launches)
    po = model.point_order(grid, pts, ri, wxy, zi, wz)
    for name in ("point_order_keys", "permute_points"):
        assert kernels.launches[name] == before[name] + 1, name
    assert torch.equal(
        kernels.point_order_keys(pts, grid, model.POINT_RULE),
        kernels.point_order_keys_ref(ri, zi, model.BASE_TRANSLATE, shape))
    perm = po.order.long()
    for got, t in zip((po.ri, po.wxy, po.zi, po.wz), (ri, wxy, zi, wz)):
        assert torch.equal(got, t[perm])
    before = kernels.launches["rows_value_fwd"]
    assert torch.equal(tricubic.rows_value(table, ri, wxy, zi, wz, xy_first,
                                           order=po), want)
    assert kernels.launches["rows_value_fwd"] == before + 1
    rand = torch.randperm(ri.shape[0], generator=torch.Generator()
                          .manual_seed(5)).to(torch.int32).to(dev)
    moved = kernels.permute_points(rand, ri, wxy, zi, wz)
    assert torch.equal(kernels.rows_value_fwd(table, *moved, xy_first, rand),
                       want)
    with pytest.raises(ValueError, match="a point order needs"):
        kernels.rows_value_fwd(table, *map(off_boundary, moved), xy_first,
                               rand)


@pytest.mark.parametrize("grid_case", ["dyadic_12x9x7", "non_dyadic_40x36x33",
                                       "config_128"])
@pytest.mark.parametrize("model", [boxspline, tricubic, zpcubic],
                         ids=["zp", "cubic", "zpc"])
def test_point_order_keys_from_the_points_are_the_set_up_rows(dev, model,
                                                              grid_case):
    """The key kernel, which reads the points, bitwise the key the model's
    set-up holds in its rows (``point_order_keys_ref`` of ``row_setup`` on
    the card) and its plain version, at edge-case points (lattice nodes,
    halves, outside every side, the boundary cells) with NaN and infinite
    coordinates, a ragged count; the points off a 16-byte boundary give
    the same keys; one launch a call."""
    shape, origin, spacing = {
        "dyadic_12x9x7": ((12, 9, 7), (-96.0, -40.0, 0.0), (16.0, 8.0, 32.0)),
        "non_dyadic_40x36x33": ((40, 36, 33), (-151.3, 7.7, 60.1),
                                (9.7, 13.1, 41.3)),
        "config_128": ((128, 128, 128), (-400.0, -400.0, 0.0),
                       (800 / 127, 800 / 127, 1100 / 127))}[grid_case]
    rng = np.random.default_rng(44)
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    odd = (np.asarray(origin) + np.array(
        [[np.nan, 1.0, 1.0], [1.0, np.nan, 1.0], [1.0, 1.0, np.nan],
         [np.inf, 1.0, -np.inf], [-np.inf, np.inf, 2.0]])
        * np.asarray(spacing)).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([
        edge_case_points(shape, origin, spacing, 70001, rng), odd])).to(dev)
    ri, _, zi, _ = model.row_setup(grid, pts)
    want = kernels.point_order_keys_ref(ri, zi, model.BASE_TRANSLATE, shape)
    before = kernels.launches["point_order_keys"]
    got = kernels.point_order_keys(pts, grid, model.POINT_RULE)
    assert kernels.launches["point_order_keys"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(kernels.point_order_keys_plain(pts, grid,
                                                      model.base_cell), want)
    assert torch.equal(kernels.point_order_keys(
        off_boundary(pts), grid, model.POINT_RULE), want)


@pytest.mark.parametrize("n", [1, 7, 1240, 20000, 100003])
def test_quad_value_grad_three_lanes_are_bitwise(dev, n):
    """K6q (three lanes a point, ten points a warp) at edge-case points,
    whole and ragged warps: within 1e-5·max|table| of the plain version
    (the gradient over the smallest spacing); each point's output bitwise
    the same wherever its warp places it (the points reversed, and each
    of the first 40 alone) and on a table off a 16-byte boundary; one
    launch a call."""
    grid, m = _world(dev)
    table = triquadratic.prefilter(m).reshape(-1, grid.shape[2])
    pts, _ = _edge_points(dev, grid, n, 33)
    pts = pts[:n].contiguous()
    before = kernels.launches["quad_value_grad"]
    v0, g0 = kernels.quad_value_grad(table, grid, pts)
    assert kernels.launches["quad_value_grad"] == before + 1
    tol = 1e-5 * float(table.abs().max())
    vr, gr = triquadratic.interp_rows_with_grad_ref(table, grid, pts)
    assert float((v0 - vr).abs().max()) <= tol
    assert float((g0 - gr).abs().max()) <= tol / float(grid.spacing.min())
    v, g = kernels.quad_value_grad(table, grid, pts.flip(0).contiguous())
    assert torch.equal(v.flip(0), v0) and torch.equal(g.flip(0), g0)
    for i in range(min(n, 40)):
        v, g = kernels.quad_value_grad(table, grid, pts[i:i + 1].contiguous())
        assert torch.equal(v, v0[i:i + 1]) and torch.equal(g, g0[i:i + 1])
    v, g = kernels.quad_value_grad(off_boundary(table), grid, pts)
    assert torch.equal(v, v0) and torch.equal(g, g0)


@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_leapfrog_zp_matches_plain(dev, keep_path):
    """K1 against the plain tracer: 1e-3 km on the path, 1e-5 relative
    on the TEC."""
    grid, m = _world(dev)
    o, d = _rays(dev, 500)
    kw = dict(n_steps=64, keep_path=keep_path, method="leapfrog",
              interp="zp")
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, **kw)
    assert b.points.shape == br.points.shape
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


def test_trace_rk4_runs_k1e_and_matches_plain(dev):
    """rk4 on CUDA on zp is one launch of K1r, which evaluates the field
    in the kernel: K1e, the evaluator the per-stage loop launched 4 times
    a step, launches no more."""
    grid, m = _world(dev)
    o, d = _rays(dev, 200)
    kw = dict(n_steps=16, keep_path=True, method="rk4", interp="zp")
    before = dict(kernels.launches)
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    assert kernels.launches["zp_value_grad"] == before["zp_value_grad"]
    assert kernels.launches["trace_rk4_zp"] == before["trace_rk4_zp"] + 1
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, **kw)
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


def test_serving_slice_matches_cpu_and_is_deterministic(dev):
    """make_ray_batch → trace_rays → dtec_paired_q on the card, twice
    (bitwise equal), against the same slice on CPU tensors."""
    grid, m = _world(dev)
    o, d = _rays(dev, 8, seed=5)
    ants, dirs = o[:6], d[:5]

    def slice_(m, grid, ants, dirs):
        orig, dv = rays.make_ray_batch(ants, dirs)
        rb, _ = fermat.trace_rays(m, grid, orig, dv, 150e6, 1000.0,
                                  n_steps=64, keep_path=True,
                                  method="leapfrog", interp="zp")
        return tec.dtec_paired_q(m, grid, rb, dirs.shape[0], 0, "hermite",
                                 "zp")

    kernels.reset_launches()
    a = slice_(m, grid, ants, dirs)
    b = slice_(m, grid, ants, dirs)
    assert all(kernels.launches[name] > 0 for name in SERVING_KERNELS)
    assert torch.equal(a, b)
    c = slice_(m.cpu(), grid.to("cpu"), ants.cpu(), dirs.cpu())
    assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(c.abs().max())


@pytest.mark.parametrize("k,l", [(8, 3), (16, 4)])
def test_rows_value_backward_matches_plain(dev, k, l):
    """K3 through rows_value's autograd backward, against the plain
    index_add_ version; duplicate rows within a point included. Bitwise
    equal across two calls. Tolerance 1e-5·max|out|."""
    rng = np.random.default_rng(6)
    n, rows_n, nz = 6000, 300, 20
    t = lambda a: torch.from_numpy(a).to(dev)
    ri_np = rng.integers(0, rows_n, (n, k)).astype(np.int32)
    ri_np[:, 1] = ri_np[:, 0]
    ri, table = t(ri_np), t(rng.normal(size=(rows_n, nz)).astype(np.float32))
    zi = t((rng.integers(0, nz - l + 1, (n, 1))
            + np.arange(l)).astype(np.int32))
    wxy = t(rng.normal(size=(n, k)).astype(np.float32))
    wz = t(rng.normal(size=(n, l)).astype(np.float32))
    ct = t(rng.normal(size=(n,)).astype(np.float32))
    leaf = table.clone().requires_grad_(True)
    out = tricubic.rows_value(leaf, ri, wxy, zi, wz, k == 8)
    before = kernels.launches["rows_value_bwd"]
    (g1,) = torch.autograd.grad(out, leaf, ct, retain_graph=True)
    (g2,) = torch.autograd.grad(out, leaf, ct)
    assert kernels.launches["rows_value_bwd"] == before + 2
    want = tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz,
                                             (rows_n, nz))
    assert torch.equal(g1, g2)
    assert float((g1 - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_zp_value_grad_transpose_matches_plain(dev):
    """K1eᵀ against the plain version at points in, on and outside the
    grid (repeated rows at the edges). Bitwise across two calls."""
    grid, _ = _world(dev)
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(edge_case_points(
        grid.shape, grid.origin.cpu().numpy(), grid.spacing.cpu().numpy(),
        20000, rng)).to(dev)
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    before = kernels.launches["zp_value_grad_bwd"]
    a = boxspline.interp_rows_with_grad_transpose(grid, pts, cv, cg)
    b = boxspline.interp_rows_with_grad_transpose(grid, pts, cv, cg)
    assert kernels.launches["zp_value_grad_bwd"] == before + 2
    want = boxspline.interp_rows_with_grad_transpose_ref(grid, pts, cv, cg)
    assert torch.equal(a, b)
    assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _segment_case(case, k, l, n_rows=60, nz=20, seed=8):
    """rows_value inputs (numpy) whose plan stresses the segments:
    "one_row": every pair on row 0 (points clamped onto a corner row);
    "boundaries": rows holding 0, C−1, C, C+1, 2C and 3C+5 pairs of the
    default chunk C, the rest of the pairs outside the table;
    "scattered_z": z taps that are not consecutive, so a batch's z are not
    sorted and the kernel adds lane by lane."""
    rng = np.random.default_rng(seed)
    c = tricubic.SEGMENT_PAIRS
    if case == "boundaries":
        flat = np.repeat([1, 2, 3, 4, 5, 6], [c - 1, c, c + 1, 2 * c,
                                               3 * c + 5, 1])
        flat = np.concatenate([flat, np.full(-flat.size % k, n_rows)])
        rng.shuffle(flat)
        ri = flat.reshape(-1, k).astype(np.int32)
    else:
        ri = rng.integers(0, n_rows, (3000, k)).astype(np.int32)
        if case == "one_row":
            ri[:] = 0
    n = ri.shape[0]
    zi = (rng.integers(0, nz - l + 1, (n, 1)) + np.arange(l)).astype(np.int32)
    if case == "scattered_z":
        zi = rng.integers(0, nz, (n, l)).astype(np.int32)
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    ct = rng.normal(size=(n,)).astype(np.float32)
    return ct, ri, wxy, zi, wz, (n_rows, nz)


@pytest.mark.parametrize("case", ["one_row", "boundaries", "scattered_z"])
@pytest.mark.parametrize("k,l", [(8, 3), (16, 4)])
def test_rows_value_bwd_segments_match_plain(dev, case, k, l):
    """K3 over segmented plans: within 1e-4·max|out| of the plain version,
    bitwise equal across two calls, its counters back at zero after each
    call, and a second plan of the same pairs gives the same bits."""
    ct, ri, wxy, zi, wz, shape = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in _segment_case(case, k, l))
    plan = tricubic.build_row_plan(ri, shape[0], zi[:, 0])

    def k3(p):
        return kernels.rows_value_bwd(ct, p, wxy, zi, wz, shape[1])

    a = k3(plan)
    assert not plan.counters.any()
    b = k3(plan)
    assert not plan.counters.any()
    assert torch.equal(a, b)
    assert torch.equal(a, k3(tricubic.build_row_plan(ri, shape[0],
                                                     zi[:, 0])))
    want = tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz, shape)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_reduce_kernels_refuse_a_plan_of_another_stream(dev):
    """K3 and K1eᵀ take a plan only on the stream it was built on (two
    streams would share its counters): another stream raises, and the
    plan's own stream still gives the same bits."""
    ct, ri, wxy, zi, wz, shape = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in _segment_case("one_row", 8, 3))
    plan = tricubic.build_row_plan(ri, shape[0], zi[:, 0])
    grid, _ = _world(dev)
    pts = torch.from_numpy(edge_case_points(
        grid.shape, grid.origin.cpu().numpy(), grid.spacing.cpu().numpy(),
        2000, np.random.default_rng(10))).to(dev)
    cv, cg = pts[:, 0].contiguous(), pts.flip(1).contiguous()
    eplan = boxspline.endpoint_plan(grid, pts)

    def calls():
        return (kernels.rows_value_bwd(ct, plan, wxy, zi, wz, shape[1]),
                kernels.zp_value_grad_bwd(grid, pts, cv, cg, eplan))

    a = calls()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        with pytest.raises(ValueError, match="another CUDA stream"):
            kernels.rows_value_bwd(ct, plan, wxy, zi, wz, shape[1])
        with pytest.raises(ValueError, match="another CUDA stream"):
            kernels.zp_value_grad_bwd(grid, pts, cv, cg, eplan)
    b = calls()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("chunk", [tricubic.SEGMENT_PAIRS, 7, 1])
def test_zp_value_grad_bwd_segments_match_plain(dev, chunk):
    """K1eᵀ at points clamped onto a grid corner (a few rows hold every
    pair) beside edge-case points, over plans cut into segments of 256,
    7 and 1 pairs: within 1e-4·max|out| of the plain version, bitwise
    equal across calls and plans, counters back at zero."""
    grid, _ = _world(dev)
    rng = np.random.default_rng(9)
    origin, spacing = grid.origin.cpu().numpy(), grid.spacing.cpu().numpy()
    pts = edge_case_points(grid.shape, origin, spacing, 8000, rng)
    corner = pts.copy()
    corner[:, :2] = origin[:2] - 50.0 - np.abs(corner[:, :2])
    pts = torch.from_numpy(np.concatenate([corner, pts])).to(dev)
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    bx, by, bz, u, v, _ = boxspline._neighborhood(grid, pts)
    dx, dy, _ = boxspline._xy_weights(u, v, with_grad=False)
    ri = boxspline._row_index(bx, by, dx, dy, grid)
    n_rows = grid.shape[0] * grid.shape[1]

    def plan():
        return tricubic.build_row_plan(ri, n_rows, bz - 1,
                                       boxspline.ZP_LIVE_TRANSLATES, chunk)

    p = plan()
    a = boxspline.interp_rows_with_grad_transpose(grid, pts, cv, cg, p)
    assert not p.counters.any()
    b = boxspline.interp_rows_with_grad_transpose(grid, pts, cv, cg, p)
    c = boxspline.interp_rows_with_grad_transpose(grid, pts, cv, cg, plan())
    assert torch.equal(a, b) and torch.equal(a, c)
    want = boxspline.interp_rows_with_grad_transpose_ref(grid, pts, cv, cg)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("rows,m,width", [
    (8, 8, 128), (300, 300, 128), (300, 77, 128), (16384, 16384, 128),
    (300, 77, 1), (8, 300, 7), (4097, 300, 129), (4097, 300, 130),
    (4097, 5000, 16), (60000, 3000, 8)])
def test_vector_gather_matches_torch_gather(dev, rows, m, width):
    """KG bitwise equal to torch.gather, one counted launch a call, at the
    probe's width and (16384, 16384), at ragged widths, with more or
    fewer index rows than table rows and at a tall narrow table; indices
    out of range against torch.gather on the clamped indices."""
    rng = np.random.default_rng(rows + m + width)
    table = torch.from_numpy(rng.normal(size=(rows, width))
                             .astype(np.float32)).to(dev)
    idx = rng.integers(0, rows, (m, width)).astype(np.int32)
    idx[0, :] = -3
    idx[-1, ::2] = rows + 5
    idx = torch.from_numpy(idx).to(dev)
    before = kernels.launches["vector_gather"]
    got = gather.vector_gather(table, idx)
    assert kernels.launches["vector_gather"] == before + 1
    assert torch.equal(got, gather.vector_gather_ref(
        table, idx.clamp(0, rows - 1)))


@pytest.mark.parametrize("aligned", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("n", [1, 1003])
@pytest.mark.parametrize("order", ["sorted", "random"])
@pytest.mark.parametrize("k,l", [(16, 4), (8, 3)])
def test_permute_points_is_a_row_gather(dev, k, l, order, n, aligned):
    """The permute bitwise t[order] for each of ri, wxy, zi, wz, at the
    cubic and zp shapes, in an order sorted by random keys with ties and
    in a random one, at one point and at a count no tile divides, with
    inputs on and off a 16-byte boundary; one counted launch a call."""
    rng = np.random.default_rng(k * n + l)
    ri = torch.from_numpy(rng.integers(0, 10 ** 6, (n, k)).astype(np.int32))
    zi = torch.from_numpy(rng.integers(0, 10 ** 6, (n, l)).astype(np.int32))
    wxy = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    wz = torch.from_numpy(rng.normal(size=(n, l)).astype(np.float32))
    setup = [t.to(dev) for t in (ri, wxy, zi, wz)]
    if not aligned:
        setup = [off_boundary(t) for t in setup]
    if order == "sorted":
        keys = torch.from_numpy(rng.integers(0, max(1, n // 4), n))
        perm = torch.sort(keys, stable=True).indices
    else:
        perm = torch.from_numpy(rng.permutation(n))
    perm = perm.to(torch.int32).to(dev)
    before = kernels.launches["permute_points"]
    got = kernels.permute_points(perm, *setup)
    assert kernels.launches["permute_points"] == before + 1
    for a, t in zip(got, setup):
        assert torch.equal(a, t[perm.long()])


def _solve_world(dev, n=20, na=8, nd=6):
    rng = np.random.default_rng(11)
    ants = np.concatenate([rng.uniform(-80, 80, (na, 2)),
                           np.zeros((na, 1))], -1)
    zen = rng.uniform(0.05, 0.45, nd)
    az = rng.uniform(0, 2 * np.pi, nd)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, max_length_km=900.0,
                                       shape=(n, n, n), h_min_km=0.0,
                                       device=dev)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    o, d = rays.make_ray_batch(torch.from_numpy(ants).float().to(dev),
                               torch.from_numpy(dirs).float().to(dev))
    rb = rays.sample_straight_rays(o, d, 900.0, 33)
    pert = torch.from_numpy(rng.normal(size=(n, n, n)).astype(np.float32))
    m_true = m_prior + 0.1 * pert.to(dev)
    d_obs = tec.dtec_paired_q(m_true, grid, rb, nd, 0, "hermite", "zp")
    cov = priors.GPCovariance.create(grid, sigma=0.3, length_scale=90.0,
                                     kind="von_karman")
    return grid, rb, d_obs, m_prior, cov, nd


def test_linear_operator_matches_plain_on_card(dev):
    """J and Jᵀ on the kernels against the same operator on the plain
    versions, both on the card: 1e-4·max; the adjoint identity 1e-4."""
    grid, rb, _, m_prior, _, nd = _solve_world(dev)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32)
                         ).to(dev)
    y = torch.from_numpy(rng.normal(size=(rb.num_rays,)).astype(np.float32)
                         ).to(dev)
    for q in ("hermite", "simpson"):
        op = tec.dtec_paired_linear(m_prior, grid, rb, nd, 0, q, "zp")
        ref = tec.dtec_paired_linear_ref(m_prior, grid, rb, nd, 0, q, "zp")
        jx, jty = op.apply(x), op.apply_t(y)
        rx, rty = ref.apply(x), ref.apply_t(y)
        assert float((jx - rx).abs().max()) <= 1e-4 * float(rx.abs().max())
        assert float((jty - rty).abs().max()) <= 1e-4 * float(
            rty.abs().max())
        lhs, rhs = float(torch.dot(jx.double(), y.double())), float(
            torch.sum(x.double() * jty.double()))
        assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


def test_dtec_paired_over_on_card_is_the_linearisation_g0(dev):
    """``tec.dtec_paired_over`` on cubic Simpson (steepest's objectives):
    one field and a member axis of 3 bit for bit the ``g0`` of the
    operator linearised about them over the same geometry, the member axis
    one K2b launch with its pack; within 1e-4·max of the CPU forward (the
    tolerance of the operator tests)."""
    grid, rb, _, m_prior, _, nd = _solve_world(dev)
    geo = tec.DtecGeometry(grid, rb, nd, 0, "simpson", "cubic")
    rng = np.random.default_rng(13)
    ms = m_prior[None] + 0.2 * torch.from_numpy(
        rng.normal(size=(3,) + grid.shape).astype(np.float32)).to(dev)
    one = tec.dtec_paired_over(ms[0], geo)
    assert torch.equal(one, tec.dtec_paired_linear(
        ms[0], grid, rb, nd, 0, "simpson", "cubic", geometry=geo).g0)
    before = dict(kernels.launches)
    batched = tec.dtec_paired_over(ms, geo)
    torch.cuda.synchronize()
    for name in ("rows_value_fwd_batched", "pack_members"):
        assert kernels.launches[name] == before[name] + 1
    assert torch.equal(batched, tec.dtec_paired_linear(
        ms, grid, rb, nd, 0, "simpson", "cubic", geometry=geo).g0)
    cpu_geo = tec.DtecGeometry(grid.to("cpu"), rays.RayBundle(
        rb.points.cpu(), rb.ds.cpu()), nd, 0, "simpson", "cubic")
    want = tec.dtec_paired_over(ms.cpu(), cpu_geo)
    assert float((batched.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_small_solve_is_bitwise_reproducible(dev):
    """map_gauss_newton on the kernels, twice: bitwise equal m, every
    kernel of the path launched, and close to the plain-version solve."""
    grid, rb, d_obs, m_prior, cov, nd = _solve_world(dev)
    noise = 0.01 * float(d_obs.std())
    kw = dict(num_directions=nd, gn_iters=2, cg_iters=8, interp="zp")
    kernels.reset_launches()
    a = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov, **kw)
    b = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov, **kw)
    for name in SOLVE_KERNELS:
        assert kernels.launches[name] > 0, name
    assert torch.equal(a.m, b.m)
    assert bool(torch.isfinite(a.m).all())
    plain = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov,
                                     linearize=tec.dtec_paired_linear_ref,
                                     **kw)
    assert abs(float(a.residual_norm) - float(plain.residual_norm)) \
        <= 1e-2 * float(plain.residual_norm)


def test_cg_over_the_kernel_operator_waits_for_no_sync(dev):
    """CG over the whitened normal operator of the kernel path with
    ``torch.cuda.set_sync_debug_mode("error")``: no step of the loop (J,
    Jᵀ, the prior's FFTs, the Krylov updates) makes the host wait."""
    grid, rb, d_obs, m_prior, cov, nd = _solve_world(dev)
    op = tec.dtec_paired_linear(m_prior, grid, rb, nd, 0, "hermite", "zp")

    def matvec(x):
        v = cov.apply_sqrt(x.reshape(grid.shape))
        return x + cov.apply_sqrt(op.apply_t(op.apply(v))).reshape(-1)

    rhs = cov.apply_sqrt(op.apply_t(d_obs.reshape(-1))).reshape(-1)
    want, _ = linalg.cg(matvec, rhs, max_iters=6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = linalg.cg(matvec, rhs, max_iters=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


# --- the tricubic field model: K5, K5ᵀ, K1c and K4 through K3 -------------


def _edge_points(dev, grid, n, seed):
    rng = np.random.default_rng(seed)
    pts = edge_case_points(grid.shape, grid.origin.cpu().numpy(),
                           grid.spacing.cpu().numpy(), n, rng)
    return torch.from_numpy(pts).to(dev), rng


def test_cubic_value_grad_matches_plain(dev):
    """K5 at points in, on and outside the grid. Tolerance 1e-5·max|table|
    (value), over min spacing (gradient)."""
    grid, m = _world(dev)
    table = m.reshape(-1, grid.shape[2])
    pts, _ = _edge_points(dev, grid, 20000, 20)
    before = kernels.launches["cubic_value_grad"]
    v, g = tricubic.interp_rows_with_grad(table, grid, pts)
    assert kernels.launches["cubic_value_grad"] == before + 1
    vr, gr = tricubic.interp_rows_with_grad_ref(table, grid, pts)
    tol = 1e-5 * float(table.abs().max())
    assert float((v - vr).abs().max()) <= tol
    assert float((g - gr).abs().max()) <= tol / float(grid.spacing.min())
    # K2 at the cubic shape through interp_rows gives the same value
    assert float((tricubic.interp_rows(table, grid, pts) - vr).abs().max()) \
        <= tol


@pytest.mark.parametrize("chunk", [tricubic.SEGMENT_PAIRS, 7])
def test_cubic_value_grad_transpose_matches_plain(dev, chunk):
    """K5ᵀ at edge-case points and points clamped onto a grid corner (a
    few rows hold every pair; rows and taps repeat there), over plans cut
    into segments of 256 and 7 pairs: within 1e-4·max|out| of the plain
    version, bitwise equal across calls and plans, counters back at zero,
    and the adjoint identity with K5 to 1e-4."""
    grid, m = _world(dev)
    pts, rng = _edge_points(dev, grid, 8000, 21)
    corner = pts.clone()
    corner[:, :2] = grid.origin[:2] - 50.0 - corner[:, :2].abs()
    pts = torch.cat([corner, pts]).contiguous()
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    idx, _, ri = tricubic._row_neighborhood(grid, pts)
    n_rows = grid.shape[0] * grid.shape[1]

    def plan():
        return tricubic.build_row_plan(ri, n_rows, idx[:, 2, 1], chunk=chunk,
                                       occupied_rows=True)

    p = plan()
    before = kernels.launches["cubic_value_grad_bwd"]
    a = tricubic.interp_rows_with_grad_transpose(grid, pts, cv, cg, p)
    assert kernels.launches["cubic_value_grad_bwd"] == before + 1
    assert not p.counters.any()
    b = tricubic.interp_rows_with_grad_transpose(grid, pts, cv, cg, p)
    c = tricubic.interp_rows_with_grad_transpose(grid, pts, cv, cg, plan())
    assert torch.equal(a, b) and torch.equal(a, c)
    want = tricubic.interp_rows_with_grad_transpose_ref(grid, pts, cv, cg)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())
    table = m.reshape(n_rows, -1)
    v, g = tricubic.interp_rows_with_grad(table, grid, pts)
    lhs = float((v.double() * cv.double()).sum()
                + (g.double() * cg.double()).sum())
    rhs = float((a.double() * table.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


@pytest.mark.parametrize("chunk", [tricubic.SEGMENT_PAIRS, 7])
def test_cubic_value_grad_transpose_adds_into_a_table(dev, chunk):
    """The accumulating K5ᵀ: table + Eᵀ at the touched cells, rounded as
    table + (Eᵀ into zeros), bitwise; every other cell untouched, bitwise;
    bitwise equal across calls; within 1e-4·max of table + the plain
    version."""
    grid, m = _world(dev)
    pts, rng = _edge_points(dev, grid, 6000, 23)
    corner = pts[:2000].clone()
    corner[:, :2] = grid.origin[:2] - 50.0
    pts = torch.cat([corner, pts]).contiguous()
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    idx, _, ri = tricubic._row_neighborhood(grid, pts)
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    p = tricubic.build_row_plan(ri, n_rows, idx[:, 2, 1], chunk=chunk,
                                occupied_rows=True)
    table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                             .astype(np.float32)).to(dev)
    alone = kernels.cubic_value_grad_bwd(torch.zeros_like(table), grid, pts,
                                         cv, cg, p)
    a = kernels.cubic_value_grad_bwd(table.clone(), grid, pts, cv, cg, p)
    b = kernels.cubic_value_grad_bwd(table.clone(), grid, pts, cv, cg, p)
    assert not p.counters.any()
    assert torch.equal(a, b)
    touched = torch.zeros(grid.num_voxels, dtype=torch.bool, device=dev)
    touched[tricubic.interp_weights(grid, pts)[0].reshape(-1).long()] = True
    touched = touched.reshape(n_rows, nz)
    assert torch.equal(a[touched], (table + alone)[touched])
    assert torch.equal(a[~touched], table[~touched])
    want = table + tricubic.interp_rows_with_grad_transpose_ref(grid, pts,
                                                                cv, cg)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_cubic_apply_t_adds_k5t_into_k3s_table(dev):
    """Jᵀ on cubic is K3's table with K5ᵀ added in place: bitwise what
    K3's table + K5ᵀ into zeros gives, with one launch of each."""
    grid, rb, _, m_prior, _, nd = _solve_world(dev)
    op = tec.dtec_paired_linear(m_prior, grid, rb, nd, 0, "hermite", "cubic")
    rng = np.random.default_rng(24)
    y = torch.from_numpy(rng.normal(size=(rb.num_rays,)).astype(np.float32)
                         ).to(dev)
    kernels.reset_launches()
    got = op.apply_t(y)
    assert kernels.launches["rows_value_bwd"] == 1
    assert kernels.launches["cubic_value_grad_bwd"] == 1
    y3 = y.reshape(op.na, op.nd)
    ct_ne, ct_d0 = tec._paired_hermite_ne_t(y3, op.w, op.rays, op.i0)
    k3 = op._rows_t(op.ne * ct_ne.reshape(-1))
    ct_d = torch.cat([ct_d0, -ct_d0], dim=-1) * op.ne_e
    e = tricubic.interp_rows_with_grad_transpose(
        grid, op.ends, ct_d * op.slope, ct_d[..., None] * op.t_hat,
        op.end_plan)
    assert torch.equal(got, (k3 + e).reshape(grid.shape))


@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_leapfrog_cubic_packed_and_ordered_is_unpacked(dev, keep_path):
    """K1c as the tracer calls it (rays sorted, table packed) against the
    unpacked evaluator in ray order: bitwise equal per ray, also under a
    random order and other block sizes; the pack bitwise
    ``pack_z_taps_ref`` and the sort keys bitwise ``ray_order_keys_ref``,
    each launch counted."""
    grid, m = _world(dev)
    o, d = _rays(dev, 700)
    table = m.reshape(-1, grid.shape[2])
    kw = fermat._step_constants(150e6, 1000.0, 48)
    want = kernels.trace_leapfrog_cubic_with(
        table, grid, o, d, 48, keep_path, packed=None, order=None,
        threads=128, **kw)
    got = kernels.trace_leapfrog_cubic(table, grid, o, d, 48, keep_path,
                                       **kw)
    before = dict(kernels.launches)
    packed = kernels.pack_z_taps(table, grid)
    perm = torch.randperm(700, generator=torch.Generator().manual_seed(3)
                          ).to(torch.int32).to(dev)
    other = kernels.trace_leapfrog_cubic_with(
        table, grid, o, d, 48, keep_path, packed=packed, order=perm,
        threads=64, **kw)
    assert torch.equal(packed, tricubic.pack_z_taps_ref(table))
    order = kernels.ray_order(o, d, grid)
    key = kernels.ray_order_keys_ref(o, d, grid)
    assert torch.equal(kernels.ray_order_keys(o, d, grid), key)
    added = {"pack_z_taps": 1, "trace_leapfrog_cubic": 1,
             "ray_order_keys": 2}
    for name, n in added.items():
        assert kernels.launches[name] == before[name] + n, name
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(700, device=dev))
    assert bool((torch.diff(key[order.long()]) >= 0).all())
    for out in (got, other):
        for a, b in zip(out, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("n_rays", ["small", "below", "sorted"])
@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_leapfrog_zp_packed_and_ordered_is_unpacked(dev, keep_path,
                                                          n_rays):
    """K1 as the tracer calls it (a small batch and one just below the
    threshold as they are, one past it sorted and over the packed table)
    against the unpacked evaluator in ray order: bitwise equal per ray,
    also under a random order and other block sizes; the pack bitwise
    ``pack_z_taps_ref``, each launch counted."""
    grid, m = _world(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"small": 700,
         "below": kernels.TRACE_ZP_RAYS_PER_SM * sms - 300,
         "sorted": kernels.TRACE_ZP_RAYS_PER_SM * sms + 300}[n_rays]
    o, d = _rays(dev, n)
    coef = boxspline.prefilter(m).reshape(-1, grid.shape[2]).contiguous()
    kw = fermat._step_constants(150e6, 1000.0, 40)
    want = kernels.trace_leapfrog_zp_with(
        coef, grid, o, d, 40, keep_path, packed=None, order=None,
        threads=128, **kw)
    before = dict(kernels.launches)
    got = kernels.trace_leapfrog_zp(coef, grid, o, d, 40, keep_path, **kw)
    added = {"pack_zp_taps": int(n_rays == "sorted"), "trace_leapfrog_zp": 1,
             "ray_order_keys": int(n_rays == "sorted")}
    for name, k in added.items():
        assert kernels.launches[name] == before[name] + k, name
    packed = kernels.pack_zp_taps(coef, grid)
    assert torch.equal(packed, boxspline.pack_z_taps_ref(coef))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3)
                          ).to(torch.int32).to(dev)
    others = [kernels.trace_leapfrog_zp_with(
        coef, grid, o, d, 40, keep_path, packed=pk, order=order,
        threads=threads, **kw)
        for pk, order, threads in ((packed, perm, 64), (None, perm, 256),
                                   (packed, None, 32))]
    for out in (got, *others):
        for a, b in zip(out, want):
            assert (a is None and b is None) or torch.equal(a, b)


def test_trace_leapfrog_zp_packed_on_a_tall_grid_is_unpacked(dev):
    """K1 on a 6 × 6 × 1024 grid (1022 z bases packed): the packed and
    sorted call bitwise the unpacked evaluator, and within the plain
    tracer's tolerances."""
    grid = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                              (6, 6, 1024), device=dev)
    m = chapman.log_parametrize(chapman.chapman_field(grid)).contiguous()
    coef = boxspline.prefilter(m).reshape(-1, 1024).contiguous()
    o, d = _rays(dev, 300)
    kw = fermat._step_constants(150e6, 1000.0, 32)
    want = kernels.trace_leapfrog_zp_with(
        coef, grid, o, d, 32, True, packed=None, order=None, threads=128,
        **kw)
    packed = kernels.pack_zp_taps(coef, grid)
    assert torch.equal(packed, boxspline.pack_z_taps_ref(coef))
    got = kernels.trace_leapfrog_zp_with(
        coef, grid, o, d, 32, True, packed=packed,
        order=kernels.ray_order(o, d, grid), threads=64, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    b, t = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, n_steps=32,
                                 keep_path=True, method="leapfrog",
                                 interp="zp")
    assert float((got[2] - b.points).abs().max()) <= 1e-3
    assert float(((got[1] - t).abs() / t.abs()).max()) <= 1e-5


@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_leapfrog_cubic_matches_plain(dev, keep_path):
    """K1c against the plain tracer, the default field model: 1e-3 km on
    the path, 1e-5 relative on the TEC; bitwise equal across two calls."""
    grid, m = _world(dev)
    o, d = _rays(dev, 500)
    kw = dict(n_steps=64, keep_path=keep_path, method="leapfrog")
    before = kernels.launches["trace_leapfrog_cubic"]
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    b2, t2 = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    assert kernels.launches["trace_leapfrog_cubic"] == before + 2
    assert torch.equal(b.points, b2.points) and torch.equal(t, t2)
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, **kw)
    assert b.points.shape == br.points.shape
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


def test_trace_cubic_over_dense_clip_matches_plain(dev):
    """K1c at 8 MHz, where rays reflect and the over-dense clip zeroes
    ∇n: 5e-2 km on the path and 2e-5 relative on the TEC, the bounds the
    plain tracer is held to against the reference there."""
    grid, m = _world(dev)
    o, d = _rays(dev, 300)
    kw = dict(n_steps=32, keep_path=True, method="leapfrog", interp="cubic")
    b, t = fermat.trace_rays(m, grid, o, d, 8e6, 1000.0, **kw)
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 8e6, 1000.0, **kw)
    assert float((b.points - br.points).abs().max()) <= 5e-2
    assert float(((t - tr).abs() / tr.abs()).max()) <= 2e-5


def test_trace_rk4_cubic_runs_k5(dev):
    """rk4 on cubic is one launch of K1r, K5's evaluator inside the
    kernel: K5, which the per-stage loop launched 4 times a step and once
    for p0, launches no more."""
    grid, m = _world(dev)
    o, d = _rays(dev, 200)
    kw = dict(n_steps=16, keep_path=True, method="rk4", interp="cubic")
    before = dict(kernels.launches)
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    assert kernels.launches["cubic_value_grad"] == before["cubic_value_grad"]
    assert (kernels.launches["trace_rk4_cubic"]
            == before["trace_rk4_cubic"] + 1)
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, **kw)
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


@pytest.mark.parametrize("interp", ["cubic", "zp"])
def test_tec_linear_adjoint_runs_k3_and_matches_index_add(dev, interp):
    """K4 as K3: ``tec_linear_adjoint`` launches K3 over the model's row
    plan, is bitwise equal across calls, satisfies the adjoint identity
    with ``tec_linear`` (1e-4) and, on cubic, matches ``index_add_`` of
    the 64 stencil weights per sample (1e-4·max)."""
    grid, m = _world(dev)
    o, d = _rays(dev, 300)
    rb = rays.sample_straight_rays(o, d, 1000.0, 33)
    rng = np.random.default_rng(22)
    y = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32)).to(dev)
    before = kernels.launches["rows_value_bwd"]
    a = tec.tec_linear_adjoint(y, grid, rb, interp)
    b = tec.tec_linear_adjoint(y, grid, rb, interp)
    assert kernels.launches["rows_value_bwd"] == before + 2
    assert torch.equal(a, b)
    x = torch.exp(m)
    lhs = float(torch.dot(tec.tec_linear(x, grid, rb, interp).double(),
                          y.double()))
    rhs = float((x.double() * a.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    if interp == "cubic":
        idx, w64 = tricubic.interp_weights(grid, rb.points.reshape(-1, 3))
        wq = rays.simpson_weights(33, torch.float32, dev)
        coef = (y[:, None] * wq[None, :] * rb.ds[:, None]
                * (1e3 / 1e13)).reshape(-1)
        want = torch.zeros(grid.num_voxels, device=dev).index_add_(
            0, idx.reshape(-1).long(), (w64 * coef[:, None]).reshape(-1))
        assert float((a.reshape(-1) - want).abs().max()) \
            <= 1e-4 * float(want.abs().max())


def test_cubic_solve_is_bitwise_reproducible(dev):
    """map_gauss_newton on the default model, all cubic and with the zp
    inner Jacobian, each twice: bitwise equal m, every kernel of the path
    launched, and close to the plain-version solve."""
    grid, rb, d_obs, m_prior, cov, nd = _solve_world(dev)
    noise = 0.01 * float(d_obs.std())
    # with the zp inner Jacobian the cubic operator gives only g0 and J
    for inner, names in ((None, CUBIC_SOLVE_KERNELS),
                         ("zp", ("cubic_value_grad",) + SOLVE_KERNELS)):
        kw = dict(num_directions=nd, gn_iters=2, cg_iters=8,
                  interp_inner=inner)
        kernels.reset_launches()
        a = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov,
                                     **kw)
        b = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov,
                                     **kw)
        for name in names:
            assert kernels.launches[name] > 0, name
        assert torch.equal(a.m, b.m)
        assert bool(torch.isfinite(a.m).all())
        plain = solvers.map_gauss_newton(
            grid, rb, d_obs, noise, m_prior, cov,
            linearize=tec.dtec_paired_linear_ref, **kw)
        assert abs(float(a.residual_norm) - float(plain.residual_norm)) \
            <= 1e-2 * float(plain.residual_norm)


# --- the zpc and triquadratic models: K6z, K6zᵀ, K6q, K1z, K1q -------------


@pytest.mark.parametrize("n", [1003, 20000])
@pytest.mark.parametrize("model", [zpcubic, triquadratic],
                         ids=["zpc", "quadratic"])
def test_value_grad_k6_matches_plain(dev, model, n):
    """K6z and K6q at a ragged count of edge-case points (in, on and
    outside the grid, in the boundary cells): within 1e-5·max|table| of
    the plain version (value; over min spacing the gradient) and of its
    twin in the kernel's order, one launch each, bitwise twice."""
    grid, m = _world(dev)
    name = {zpcubic: "zpc_value_grad", triquadratic: "quad_value_grad"}[model]
    table = (zpcubic.prefilter(m) if model is zpcubic
             else triquadratic.prefilter(m)).reshape(-1, grid.shape[2])
    pts, _ = _edge_points(dev, grid, n, 30)
    before = kernels.launches[name]
    v, g = model.interp_rows_with_grad(table, grid, pts)
    v2, g2 = model.interp_rows_with_grad(table, grid, pts)
    assert kernels.launches[name] == before + 2
    assert torch.equal(v, v2) and torch.equal(g, g2)
    tol = 1e-5 * float(table.abs().max())
    for ref in (model.interp_rows_with_grad_ref,
                model.interp_rows_with_grad_taps_ref):
        vr, gr = ref(table, grid, pts)
        assert float((v - vr).abs().max()) <= tol
        assert float((g - gr).abs().max()) <= tol / float(grid.spacing.min())
    # the value gather (K2 at the model's shape) gives the same value
    assert float((model.interp_rows(table, grid, pts) - v).abs().max()) \
        <= tol


@pytest.mark.parametrize("n", [1, 1240, 20000, 131072])
def test_zpc_value_grad_kept_design_is_one_thread_a_point(dev, n):
    """K6z as kept: one thread a point, so a point's value and gradient do
    not depend on the launch it is in. At edge-case points from 1 to past
    config 4's 20,000: bitwise the same points evaluated in ragged chunks
    (33, 1000 and the rest) and in reverse order."""
    grid, m = _world(dev)
    table = zpcubic.prefilter(m).reshape(-1, grid.shape[2])
    pts, _ = _edge_points(dev, grid, n, 31)
    n = pts.shape[0]
    v, g = kernels.zpc_value_grad(table, grid, pts)
    a = min(33, n)
    b = min(1000, n - a)
    parts = [kernels.zpc_value_grad(table, grid, c.contiguous())
             for c in torch.split(pts, [a, b, n - a - b]) if c.shape[0]]
    assert torch.equal(torch.cat([a for a, _ in parts]), v)
    assert torch.equal(torch.cat([b for _, b in parts]), g)
    vr, gr = kernels.zpc_value_grad(table, grid, pts.flip(0).contiguous())
    assert torch.equal(vr.flip(0), v) and torch.equal(gr.flip(0), g)


@pytest.mark.parametrize("chunk", [tricubic.SEGMENT_PAIRS, 7])
def test_zpc_value_grad_transpose_adds_into_a_table(dev, chunk):
    """The accumulating K6zᵀ at edge-case points and points clamped onto a
    grid corner, over plans of segments of 256 and 7 pairs: table + Eᵀ
    at the touched cells, rounded as table + (Eᵀ into zeros), bitwise;
    every other cell untouched; bitwise equal across calls; within
    1e-4·max of table + the plain version; counters back at zero; the
    adjoint identity with K6z to 1e-4."""
    grid, m = _world(dev)
    pts, rng = _edge_points(dev, grid, 6000, 31)
    corner = pts[:2000].clone()
    corner[:, :2] = grid.origin[:2] - 50.0
    pts = torch.cat([corner, pts]).contiguous()
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    p = zpcubic.endpoint_plan(grid, pts, chunk=chunk)
    table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                             .astype(np.float32)).to(dev)
    before = kernels.launches["zpc_value_grad_bwd"]
    alone = zpcubic.interp_rows_with_grad_transpose_add_(
        torch.zeros_like(table), grid, pts, cv, cg, p)
    a = zpcubic.interp_rows_with_grad_transpose_add_(table.clone(), grid,
                                                     pts, cv, cg, p)
    b = kernels.zpc_value_grad_bwd(table.clone(), grid, pts, cv, cg, p)
    assert kernels.launches["zpc_value_grad_bwd"] == before + 3
    assert not p.counters.any()
    assert torch.equal(a, b)
    flat, _ = zpcubic.value_grad_transpose_terms(grid, pts, cv, cg)
    touched = torch.zeros(n_rows * nz, dtype=torch.bool, device=dev)
    touched[flat] = True
    touched = touched.reshape(n_rows, nz)
    assert torch.equal(a[touched], (table + alone)[touched])
    assert torch.equal(a[~touched], table[~touched])
    want = table + zpcubic.interp_rows_with_grad_transpose_ref(grid, pts,
                                                               cv, cg)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())
    coef = zpcubic.prefilter(m).reshape(n_rows, nz)
    v, g = zpcubic.interp_rows_with_grad(coef, grid, pts)
    lhs = float((v.double() * cv.double()).sum()
                + (g.double() * cg.double()).sum())
    rhs = float((alone.double() * coef.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


@pytest.fixture(scope="module")
def first_k6zt():
    """The library built as K6zᵀ was first designed (one warp a used
    segment, ``row_reduce::add_segment_into``; ``-DK6ZT_SEGMENT_CHAIN=1``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    from ionotomo_tpu_torch.kernels import build
    return build.open_library(
        build.build(defines=("K6ZT_SEGMENT_CHAIN=1",))["path"])


def _k6zt_layout(dev, grid, layout, rng):
    """Endpoints of a layout: "clustered" (start points repeated on a few
    antennas, as a bundle's, and far endpoints), "random" (1,001) and
    "many" (60,001) uniform, "one_row" (3,001 points over one xy cell: one
    row of many segments)."""
    lo = grid.origin.cpu().numpy()
    hi = lo + grid.spacing.cpu().numpy() * (np.asarray(grid.shape) - 1)
    if layout in ("random", "many"):
        pts = rng.uniform(lo, hi, (1001 if layout == "random" else 60001, 3))
    elif layout == "one_row":
        pts = np.tile((lo + hi) / 2, (3001, 1))
        pts[:, 2] = rng.uniform(lo[2], hi[2], 3001)
    else:
        ants = np.concatenate([rng.uniform(lo[:2] / 3, hi[:2] / 3, (7, 2)),
                               np.zeros((7, 1))], 1)
        starts = np.repeat(ants, 33, 0)
        far = rng.uniform(lo, hi, (7 * 33, 3))
        far[:, 2] = rng.uniform(0.8, 1.0, 7 * 33) * hi[2]
        pts = np.concatenate([starts, far])
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


@pytest.mark.parametrize("chunk", [tricubic.SEGMENT_PAIRS, 7])
@pytest.mark.parametrize("layout", ["clustered", "random", "one_row",
                                    "many"])
def test_zpc_value_grad_transpose_tasks_are_the_first_design(
        dev, first_k6zt, layout, chunk):
    """K6zᵀ over its task list (whole short rows a warp, each segment of a
    long row a warp) bitwise the first design over the same plan (one
    warp a used segment) and across two calls, on antenna-clustered,
    random (an odd count) and one-row endpoints, at segments of 256 and 7
    pairs, and 60,001 random endpoints of a 96³ grid (more tasks than
    the grid has warps: those past it shared out by the counter); also
    with a task a segment (``task_pairs=0``); within 1e-4·max of table +
    the plain version; counters back at zero."""
    from ionotomo_tpu_torch.kernels import build
    grid, _ = _world(dev, n=96 if layout == "many" else 40)
    rng = np.random.default_rng(41)
    pts = _k6zt_layout(dev, grid, layout, rng)
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    cg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    n_rows, nz = grid.shape[0] * grid.shape[1], grid.shape[2]
    table = torch.from_numpy(rng.normal(size=(n_rows, nz))
                             .astype(np.float32)).to(dev)
    plan = zpcubic.endpoint_plan(grid, pts, chunk=chunk)
    one_a_segment = zpcubic.endpoint_plan(grid, pts, chunk=chunk,
                                          task_pairs=0)
    assert int(plan.n_tasks) <= int(plan.row_seg[-1])
    assert int(one_a_segment.n_tasks) == int(plan.row_seg[-1])
    if layout == "many":    # past the grid of 3 blocks of 8 warps an SM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert int(plan.n_tasks) > 32 * sms

    def add(p):
        return kernels.zpc_value_grad_bwd(table.clone(), grid, pts, cv, cg, p)

    a, b, c = add(plan), add(plan), add(one_a_segment)
    default = build.load()
    build._loaded["lib"] = first_k6zt
    try:
        want = add(plan)
    finally:
        build._loaded["lib"] = default
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, want)
    for p in (plan, one_a_segment):
        assert not p.counters.any() and not p.task_counters.any()
    ref = table + zpcubic.interp_rows_with_grad_transpose_ref(grid, pts, cv,
                                                              cg)
    assert float((a - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("n_rays", ["small", "below", "above", "sorted"])
@pytest.mark.parametrize("keep_path", [True, False])
@pytest.mark.parametrize("interp", ["zpc", "quadratic"])
def test_trace_leapfrog_k1z_k1q_packed_and_ordered_is_unpacked(
        dev, interp, keep_path, n_rays):
    """K1z and K1q as the tracer calls them, each at its own threshold and
    blocks (``kernels.SORT_AND_PACK``): 700 rays and one ray below the
    threshold as they are; one ray above it and a ragged batch 300 past it
    sorted and over the packed table (K1c's pack for zpc, K1's for
    quadratic); each bitwise the unpacked evaluator in ray order, also
    under a random order and other block sizes, each launch counted; and
    within the plain tracer's tolerances (1e-3 km, 1e-5 relative TEC)."""
    grid, m = _world(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    zpc = interp == "zpc"
    name = "trace_leapfrog_zpc" if zpc else "trace_leapfrog_quad"
    pack = "pack_z_taps" if zpc else "pack_zp_taps"
    at = kernels.SORT_AND_PACK[name][0] * sms
    n = {"small": 700, "below": at - 1, "above": at + 1,
         "sorted": at + 300}[n_rays]
    o, d = _rays(dev, n)
    table = (zpcubic.prefilter(m) if zpc else triquadratic.prefilter(m)
             ).reshape(-1, grid.shape[2]).contiguous()
    call, with_ = getattr(kernels, name), getattr(kernels, name + "_with")
    kw = fermat._step_constants(150e6, 1000.0, 40)
    want = with_(table, grid, o, d, 40, keep_path, packed=None, order=None,
                 threads=128, **kw)
    before = dict(kernels.launches)
    got = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, n_steps=40,
                            keep_path=keep_path, method="leapfrog",
                            interp=interp)
    sorted_ = int(n_rays in ("above", "sorted"))
    assert kernels.sort_and_pack(name, n, sms)[0] == bool(sorted_)
    for key, k in ((name, 1), (pack, sorted_), ("ray_order_keys", sorted_)):
        assert kernels.launches[key] == before[key] + k, key
    direct = call(table, grid, o, d, 40, keep_path, **kw)
    packed = getattr(kernels, pack)(table, grid)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3)
                          ).to(torch.int32).to(dev)
    others = [with_(table, grid, o, d, 40, keep_path, packed=pk, order=order,
                    threads=threads, **kw)
              for pk, order, threads in ((packed, perm, 64),
                                         (None, perm, 256),
                                         (packed, None, 32))]
    for out in (direct, *others):
        for a, b in zip(out, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, n_steps=40,
                                   keep_path=keep_path, method="leapfrog",
                                   interp=interp)
    assert float((got[0].points - br.points).abs().max()) <= 1e-3
    assert float(((got[1] - tr).abs() / tr.abs()).max()) <= 1e-5


@pytest.mark.parametrize("interp", ["zpc", "quadratic"])
def test_trace_leapfrog_k1z_k1q_refuse_a_block_past_their_budget(dev,
                                                                 interp):
    """Over the packed table K1z and K1q launch at a register budget of
    blocks of at most 256: a block of 512 is refused with a ValueError
    that names the limit, and nothing is launched; over the table as it
    is, 512 a block launches and is bitwise 128 a block."""
    grid, m = _world(dev)
    o, d = _rays(dev, 300)
    zpc = interp == "zpc"
    name = "trace_leapfrog_zpc" if zpc else "trace_leapfrog_quad"
    pack = "pack_z_taps" if zpc else "pack_zp_taps"
    table = (zpcubic.prefilter(m) if zpc else triquadratic.prefilter(m)
             ).reshape(-1, grid.shape[2]).contiguous()
    with_ = getattr(kernels, name + "_with")
    kw = fermat._step_constants(150e6, 1000.0, 8)
    packed = getattr(kernels, pack)(table, grid)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="from 32 to 256"):
        with_(table, grid, o, d, 8, False, packed=packed, order=None,
              threads=512, **kw)
    assert kernels.launches == before
    wide, want = (with_(table, grid, o, d, 8, False, packed=None, order=None,
                        threads=t, **kw) for t in (512, 128))
    assert torch.equal(wide[0], want[0]) and torch.equal(wide[1], want[1])
    assert kernels.launches[name] == before[name] + 2


@pytest.mark.parametrize("interp", ["zpc2", "quadratic"])
def test_trace_rk4_runs_k6(dev, interp):
    """rk4 on zpc and quadratic is one launch of K1r over K6z's or K6q's
    evaluator (the per-stage loop launched K6z or K6q 4 times a step and
    once for p0; now neither), within the plain tracer's tolerances."""
    grid, m = _world(dev)
    o, d = _rays(dev, 200)
    name = "zpc_value_grad" if interp == "zpc2" else "quad_value_grad"
    tracer = "trace_rk4_zpc" if interp == "zpc2" else "trace_rk4_quad"
    kw = dict(n_steps=16, keep_path=True, method="rk4", interp=interp)
    before = dict(kernels.launches)
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    assert kernels.launches[name] == before[name]
    assert kernels.launches[tracer] == before[tracer] + 1
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, **kw)
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


RK4 = {"zp": ("trace_rk4_zp", "pack_zp_taps", "zp"),
       "cubic": ("trace_rk4_cubic", "pack_z_taps", "cubic"),
       "zpc": ("trace_rk4_zpc", "pack_z_taps", "zp"),
       "quadratic": ("trace_rk4_quad", "pack_zp_taps", "zp")}


def _sorted_batch(dev, policy, past=300):
    """Rays a batch needs to be sorted and packed by a K1 call ("zp"), by
    K1c's ("cubic") or by K1s's leapfrog ("split"), or to be packed in ray
    order by K1s's leapfrog ("split_packed"), and ``past`` more (300: a
    ragged batch; −1: the largest batch below the threshold)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = {"zp": kernels.TRACE_ZP_RAYS_PER_SM,
              "cubic": kernels.TRACE_CUBIC_RAYS_PER_SM,
              "split": kernels.SORT_AND_PACK["trace_split"][0],
              "split_packed": kernels.SPLIT_PACKED_RAYS_PER_SM}[policy]
    return per_sm * sms + past


@pytest.mark.parametrize("n_rays", ["small", "below", "sorted"])
@pytest.mark.parametrize("keep_path", [True, False])
@pytest.mark.parametrize("interp", sorted(RK4))
def test_trace_rk4_packed_and_ordered_is_unpacked(dev, interp, keep_path,
                                                  n_rays):
    """K1r on each model as ``trace_rays(method="rk4")`` calls it (701
    rays and the largest batch below the model's threshold as they are; a
    ragged batch past it sorted and over the packed table, at K1r's
    block), one launch and no evaluator kernel, bitwise the unpacked
    evaluator in ray order, also under a random order and other block
    sizes; within the plain tracer's tolerances (1e-3 km, 1e-5 relative
    TEC)."""
    name, pack, policy = RK4[interp]
    grid, m = _world(dev)
    n = {"small": 701, "below": _sorted_batch(dev, policy, -1),
         "sorted": _sorted_batch(dev, policy)}[n_rays]
    o, d = _rays(dev, n)
    from ionotomo_tpu_torch.core.field_models import field_model
    table = field_model(interp).table(m, grid).contiguous()
    with_ = getattr(kernels, name + "_with")
    kw = fermat._step_constants(150e6, 1000.0, 24)
    want = with_(table, grid, o, d, 24, keep_path, packed=None, order=None,
                 threads=128, **kw)
    before = dict(kernels.launches)
    got = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, n_steps=24,
                            keep_path=keep_path, method="rk4", interp=interp)
    sorted_ = int(n_rays == "sorted")
    packs = 1 if policy == "cubic" else sorted_
    for key, k in ((name, 1), (pack, packs), ("ray_order_keys", sorted_),
                   ("zp_value_grad", 0), ("cubic_value_grad", 0),
                   ("zpc_value_grad", 0), ("quad_value_grad", 0)):
        assert kernels.launches[key] == before[key] + k, key
    packed = getattr(kernels, pack)(table, grid)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3)
                          ).to(torch.int32).to(dev)
    others = [with_(table, grid, o, d, 24, keep_path, packed=pk, order=order,
                    threads=threads, **kw)
              for pk, order, threads in ((packed, perm, 64),
                                         (None, perm, 256),
                                         (packed, None, 32))]
    for out in others:
        for a, b in zip(out, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].points[:, -1], want[0])
    br, tr = fermat.trace_rays_ref(m, grid, o, d, 150e6, 1000.0, n_steps=24,
                                   keep_path=keep_path, method="rk4",
                                   interp=interp)
    assert got[0].points.shape == br.points.shape
    assert float((got[0].points - br.points).abs().max()) <= 1e-3
    assert float(((got[1] - tr).abs() / tr.abs()).max()) <= 1e-5


SPLIT = {"single": {},
         "layers_curved": dict(layers=chapman.DEFAULT_LAYERS, curved=True,
                               cos_chi=0.6, plasmasphere_n0=1e10)}


@pytest.mark.parametrize("n_rays", ["small", "packed", "sorted"])
@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("case", sorted(SPLIT))
def test_trace_split_matches_plain(dev, case, method, n_rays):
    """K1s (leapfrog and rk4; a single layer, and three layers on the
    curved Earth with the solar factor and the plasmasphere) as
    ``trace_rays_split`` calls it: one launch; leapfrog at its own call
    (the table as it is for a small batch, packed from
    ``SPLIT_PACKED_RAYS_PER_SM`` rays an SM, sorted too past its
    ``SORT_AND_PACK`` threshold), rk4 at K1c's (packed, sorted past K1c's
    threshold); bitwise the unpacked general form in ray order; against
    ``trace_rays_split_ref`` within 1e-3 km on the path and 1e-5 relative
    on the TEC."""
    grid, m = _world(dev)
    policy = "cubic" if method == "rk4" else "split"
    n = {"small": 700, "packed": _sorted_batch(dev, "split_packed"),
         "sorted": _sorted_batch(dev, policy)}[n_rays]
    o, d = _rays(dev, n)
    bg = chapman.background_ne_fn(**SPLIT[case])
    keep_path = n_rays == "small"
    args = (m, grid, o, d, 150e6, bg, 1000.0)
    kw = dict(n_steps=24, keep_path=keep_path, method=method)
    before = dict(kernels.launches)
    b, t = fermat.trace_rays_split(*args, **kw)
    sorted_ = int(n_rays == "sorted")
    packed = int(method == "rk4" or n_rays != "small")
    for key, k in (("trace_split", 1), ("pack_z_taps", packed),
                   ("ray_order_keys", sorted_), ("cubic_value_grad", 0)):
        assert kernels.launches[key] == before[key] + k, key
    pert = fermat.split_perturbation(m, grid, bg).contiguous()
    c = fermat._step_constants(150e6, 1000.0, 24)
    want = kernels.trace_split_with(
        pert, grid, o, d, 24, keep_path, packed=None, order=None,
        threads=128, rk4=method == "rk4", background=bg.kernel_params(dev),
        form="general", **c)
    assert torch.equal(t, want[1])
    assert torch.equal(b.points[:, -1], want[0])
    br, tr = fermat.trace_rays_split_ref(*args, **kw)
    assert b.points.shape == br.points.shape
    assert float((b.points - br.points).abs().max()) <= 1e-3
    assert float(((t - tr).abs() / tr.abs()).max()) <= 1e-5


@pytest.mark.parametrize("layout", ["sorted", "packed", "as_is"])
@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("cos_chi", [None, 0.4])
def test_trace_split_one_layer_form_is_the_general_form(dev, cos_chi,
                                                        method, layout):
    """K1s's one-layer background (``ChapmanLayer``: ``background_ne_fn()``
    and a cos χ variant) bitwise its general form (``ChapmanBackground``)
    on the same single layer, path kept, over the packed table in the ray
    order, over it in ray order, and over the table as it is; the
    one-layer form refused for a background it does not describe."""
    grid, m = _world(dev)
    n = 700
    o, d = _rays(dev, n, seed=5)
    bg = chapman.background_ne_fn(cos_chi=cos_chi)
    params = bg.kernel_params(dev)
    assert kernels.split_form(params) == "layer"
    pert = fermat.split_perturbation(m, grid, bg).contiguous()
    c = fermat._step_constants(150e6, 1000.0, 24)
    packed = (None if layout == "as_is"
              else kernels.pack_z_taps(pert, grid))
    order = kernels.ray_order(o, d, grid) if layout == "sorted" else None
    out = {form: kernels.trace_split_with(
        pert, grid, o, d, 24, True, packed=packed, order=order, threads=64,
        rk4=method == "rk4", background=params, form=form, **c)
        for form in ("layer", "general")}
    for a, b in zip(out["layer"], out["general"]):
        assert torch.equal(a, b)
    multi = chapman.background_ne_fn(layers=chapman.DEFAULT_LAYERS)
    with pytest.raises(ValueError, match="no form 'layer'"):
        kernels.trace_split_with(
            pert, grid, o, d, 24, False, packed=packed, order=order,
            threads=64, rk4=method == "rk4",
            background=multi.kernel_params(dev), form="layer", **c)


def test_trace_rays_stochastic_is_a_loop_of_the_kernel(dev):
    """The beam's n_paths × R rays in one call of K1 are bitwise the
    per-path traces of the same kernel, whatever the order the call sorts
    them in (8 paths of R rays, R such that the flattened batch is past
    K1's threshold, sorted and packed, and each path below it)."""
    grid, m = _world(dev)
    r = _sorted_batch(dev, "zp") // 8 + 1
    o, d = _rays(dev, r, seed=4)
    gen = torch.Generator(device=dev).manual_seed(7)
    eps = torch.randn((7, r, 2), generator=gen, device=dev)
    kw = dict(n_steps=32, method="leapfrog", interp="zp")
    before = dict(kernels.launches)
    mu, sd, end = fermat.trace_rays_stochastic(m, grid, o, d, 150e6, eps,
                                               n_paths=8, **kw)
    for key in ("trace_leapfrog_zp", "pack_zp_taps", "ray_order_keys"):
        assert kernels.launches[key] == before[key] + 1, key
    d_all = fermat.beam_directions(d, eps, 8, (299792.458 / 150e6
                                               / 1000.0) ** 0.5)
    tec, ends = [], []
    for p in range(8):
        b, t = fermat.trace_rays(m, grid, o, d_all[p], 150e6, 1000.0,
                                 keep_path=False, **kw)
        tec.append(t)
        ends.append(b.points[:, -1])
    tec, ends = torch.stack(tec), torch.stack(ends)
    assert torch.equal(mu, tec.mean(0))
    assert torch.equal(sd, tec.std(0, correction=0))
    assert torch.equal(end, torch.sqrt(((ends - ends.mean(0)[None]) ** 2)
                                       .sum(-1).mean(0)))


def test_zpc_operator_and_inner_solve_on_card(dev):
    """The linearised operator on zpc (K2 at K=8, L=4 over the geometry's
    point order, K3, K6z, K6zᵀ) against the plain-version operator
    (1e-4·max) and by the adjoint identity (1e-4); map_gauss_newton on
    cubic with the zpc2 inner Jacobian twice bitwise equal, its kernels
    launched, within 1 % of the plain-version solve's residual."""
    grid, rb, d_obs, m_prior, cov, nd = _solve_world(dev)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=grid.shape).astype(np.float32)
                         ).to(dev)
    y = torch.from_numpy(rng.normal(size=(rb.num_rays,)).astype(np.float32)
                         ).to(dev)
    kernels.reset_launches()
    op = tec.dtec_paired_linear(m_prior, grid, rb, nd, 0, "hermite", "zpc2")
    jx, jty = op.apply(x), op.apply_t(y)
    for name in ("rows_value_fwd", "rows_value_bwd", "zpc_value_grad",
                 "zpc_value_grad_bwd", "point_order_keys"):
        assert kernels.launches[name] > 0, name
    ref = tec.dtec_paired_linear_ref(m_prior, grid, rb, nd, 0, "hermite",
                                     "zpc2")
    for a, b in ((jx, ref.apply(x)), (jty, ref.apply_t(y))):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    lhs = float(torch.dot(jx.double(), y.double()))
    rhs = float((x.double() * jty.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    noise = 0.01 * float(d_obs.std())
    kw = dict(num_directions=nd, gn_iters=2, cg_iters=8, interp_inner="zpc2")
    a = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov, **kw)
    b = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov, **kw)
    assert torch.equal(a.m, b.m) and bool(torch.isfinite(a.m).all())
    plain = solvers.map_gauss_newton(grid, rb, d_obs, noise, m_prior, cov,
                                     linearize=tec.dtec_paired_linear_ref,
                                     **kw)
    assert abs(float(a.residual_norm) - float(plain.residual_norm)) \
        <= 1e-2 * float(plain.residual_norm)


# --- the member axis: K2b and K3b ------------------------------------------


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)])
@pytest.mark.parametrize("n_members", [1, 3, 8, 11])
def test_rows_value_fwd_batched_is_k2_per_member(dev, k, l, xy_first,
                                                 n_members):
    """K2b (the pack of the tables, then the gather): member b bitwise
    equal to K2 on table[b]; within 1e-5·Σ|w||T| of the plain version."""
    rng = np.random.default_rng(40)
    n, rows_n, nz = 4000, 300, 20
    t = lambda a: torch.from_numpy(a).to(dev)
    table = t(rng.normal(size=(n_members, rows_n, nz)).astype(np.float32))
    ri = t(rng.integers(0, rows_n, (n, k)).astype(np.int32))
    zi = t((rng.integers(0, nz - l + 1, (n, 1))
            + np.arange(l)).astype(np.int32))
    wxy = t(rng.normal(size=(n, k)).astype(np.float32))
    wz = t(rng.normal(size=(n, l)).astype(np.float32))
    before = dict(kernels.launches)
    got = tricubic.rows_value(table, ri, wxy, zi, wz, xy_first)
    assert kernels.launches["rows_value_fwd_batched"] == \
        before["rows_value_fwd_batched"] + 1
    assert kernels.launches["pack_members"] == before["pack_members"] + 1
    assert kernels.launches["rows_value_fwd"] == before["rows_value_fwd"]
    assert got.shape == (n_members, n)
    for b in range(n_members):
        assert torch.equal(got[b], kernels.rows_value_fwd(
            table[b], ri, wxy, zi, wz, xy_first))
    want = tricubic.rows_value_ref(table, ri, wxy, zi, wz, xy_first)
    scale = (wxy.abs()[:, :, None] * wz.abs()[:, None, :]
             * table[:, ri.long()[:, :, None], zi.long()[:, None, :]].abs()
             ).sum((2, 3))
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("case", ["one_row", "boundaries", "scattered_z"])
@pytest.mark.parametrize("k,l", [(8, 3), (16, 4)])
@pytest.mark.parametrize("n_members", [1, 3, 8, 11])
def test_rows_value_bwd_batched_is_k3_per_member(dev, case, k, l, n_members):
    """K3b over one shared plan (a skewed row, segment boundaries, unsorted
    z; 11 members is two passes of the 8-member group): member b bitwise
    equal to K3 on ct[b] over the same plan, bitwise equal across two
    calls, counters at zero, within 1e-4·max|out| of the plain version
    (``index_add_`` along the table axis); each call one pack, one reduce
    and one fold."""
    ct1, ri, wxy, zi, wz, shape = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in _segment_case(case, k, l))
    rng = np.random.default_rng(41)
    ct = torch.from_numpy(rng.normal(size=(n_members, ct1.shape[0]))
                          .astype(np.float32)).to(dev)
    plan = tricubic.build_row_plan(ri, shape[0], zi[:, 0])
    before = dict(kernels.launches)
    a = tricubic.rows_value_transpose(ct, ri, wxy, zi, wz, shape, plan)
    assert not plan.counters.any()
    b = tricubic.rows_value_transpose(ct, ri, wxy, zi, wz, shape, plan)
    assert not plan.counters.any()
    for name in ("rows_value_bwd_batched", "pack_members",
                 "fold_member_rows"):
        assert kernels.launches[name] == before[name] + 2, name
    assert kernels.launches["rows_value_bwd"] == before["rows_value_bwd"]
    assert a.shape == (n_members,) + tuple(shape)
    assert torch.equal(a, b)
    for m in range(n_members):
        assert torch.equal(a[m], kernels.rows_value_bwd(
            ct[m].contiguous(), plan, wxy, zi, wz, shape[1]))
    want = tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz, shape)
    assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_rows_value_bwd_batched_takes_the_widest_rows(dev):
    """K3b at nz = MAX_NZ_REDUCE with 11 members: 8 member rows of 4 KB a
    warp are past the 48 KB a block gets by default, so the reduce opts in
    to more shared memory with fewer warps a block; member b still bitwise
    K3 on ct[b]."""
    nz = kernels.MAX_NZ_REDUCE
    ct1, ri, wxy, zi, wz, shape = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in _segment_case("boundaries", 8, 3, nz=nz))
    rng = np.random.default_rng(45)
    ct = torch.from_numpy(rng.normal(size=(11, ct1.shape[0]))
                          .astype(np.float32)).to(dev)
    plan = tricubic.build_row_plan(ri, shape[0], zi[:, 0])
    got = kernels.rows_value_bwd_batched(ct, plan, wxy, zi, wz, nz)
    for m in range(11):
        assert torch.equal(got[m], kernels.rows_value_bwd(
            ct[m].contiguous(), plan, wxy, zi, wz, nz))


@pytest.mark.parametrize("n_members", [1, 3, 8, 11])
def test_pack_and_fold_are_bitwise_their_plain_versions(dev, n_members):
    """The member-innermost pack of K2b and K3b, and K3b's fold of rows of
    several segments (over the skewed row's plan, random partial rows
    with random z spans: some empty, some whole rows, some at z = 0 and
    nz − 1; NaN outside every span, which the fold must not read):
    bitwise their plain versions; the fold leaves rows of one segment as
    they were and launches once."""
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.normal(size=(n_members, 1000))
                         .astype(np.float32)).to(dev)
    packed = kernels.pack_members(x)
    assert torch.equal(packed, tricubic.pack_members_ref(x))
    assert torch.equal(tricubic.unpack_members_ref(packed, n_members), x)
    _, ri, _, zi, _, shape = _segment_case("boundaries", 8, 3)
    plan = tricubic.build_row_plan(torch.from_numpy(ri).to(dev), shape[0],
                                   torch.from_numpy(zi[:, 0]).to(dev))
    nz = shape[1]
    lo = rng.integers(0, nz, plan.n_seg_max)
    hi = lo + rng.integers(-2, nz, plan.n_seg_max)      # some empty
    hi = np.minimum(hi, nz - 1)
    lo[::7], hi[::7] = 0, nz - 1
    spans_np = np.stack([lo, hi], -1).astype(np.int32)
    covered = ((np.arange(nz) >= lo[:, None])
               & (np.arange(nz) <= hi[:, None]))
    parts_np = rng.normal(size=(n_members, plan.n_seg_max, nz)).astype(
        np.float32)
    parts_np[:, ~covered] = np.nan
    parts = torch.from_numpy(parts_np).to(dev)
    spans = torch.from_numpy(spans_np).to(dev)
    out = torch.from_numpy(rng.normal(size=(n_members,) + tuple(shape))
                           .astype(np.float32)).to(dev)
    before = kernels.launches["fold_member_rows"]
    got = kernels.fold_member_rows(parts, plan, out.clone(), spans)
    assert kernels.launches["fold_member_rows"] == before + 1
    assert torch.equal(got, tricubic.fold_member_rows_ref(parts, plan,
                                                          out.clone(), spans))
    assert not torch.isnan(got).any()
    single = (plan.row_seg[1:] - plan.row_seg[:-1]) == 1
    assert torch.equal(got[:, single], out[:, single])


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("n_members", [1, 3, 8, 9])
def test_zp_value_grad_batched_is_k1e_per_member(dev, n_members, lanes,
                                                 monkeypatch):
    """The batched K1e, one launch over the tables' pack, at each number
    of lanes a point its rule can pick (8 or 4, reached through the
    rule's threshold): member b bitwise K1e on table[b] at edge-case points (in
    and around the grid, lattice and half-lattice points, u±v = 0, the
    boundary cells); within 1e-5·max|table| (value; over the smallest
    spacing, gradient) of the plain version; the same with the pack
    handed in."""
    rng = np.random.default_rng(45)
    shape, origin, spacing = (12, 14, 16), (-3.0, -2.0, 0.0), (0.5, 0.25,
                                                             1.0)
    grid = Grid3D.create(origin, spacing, shape, device=dev)
    pts = torch.from_numpy(edge_case_points(shape, origin, spacing, 4000,
                                            rng)).to(dev)
    sms = kernels.sm_count(dev)
    items = pts.shape[0] * -(-n_members // 8)
    monkeypatch.setattr(kernels, "ZP_BATCHED_EIGHT_LANES_PER_SM",
                        1 << 30 if lanes == 8 else 0)
    assert kernels.zp_batched_lanes(items, sms) == lanes
    table = torch.from_numpy(rng.normal(size=(n_members, 12 * 14, 16))
                             .astype(np.float32)).to(dev)
    before = dict(kernels.launches)
    v, g = kernels.zp_value_grad_batched(table, grid, pts)
    assert kernels.launches["zp_value_grad_batched"] == \
        before["zp_value_grad_batched"] + 1
    assert kernels.launches["pack_members"] == before["pack_members"] + 1
    assert kernels.launches["zp_value_grad"] == before["zp_value_grad"]
    assert v.shape == (n_members, pts.shape[0])
    assert g.shape == (n_members, pts.shape[0], 3)
    for b in range(n_members):
        v1, g1 = kernels.zp_value_grad(table[b], grid, pts)
        assert torch.equal(v[b], v1) and torch.equal(g[b], g1)
    vr, gr = boxspline.interp_rows_with_grad_batched_ref(table, grid, pts)
    tol = 1e-5 * float(table.abs().max())
    assert float((v - vr).abs().max()) <= tol
    assert float((g - gr).abs().max()) <= tol / min(spacing)
    packed = kernels.pack_members(table.view(n_members, -1))
    v2, g2 = kernels.zp_value_grad_batched(table, grid, pts, packed)
    assert torch.equal(v2, v) and torch.equal(g2, g)


def test_member_pack_is_shared_by_k2b_and_the_batched_k1e(dev):
    """``tricubic.member_pack`` bitwise a fresh ``pack_members`` and its
    plain version; K2b and the batched K1e over it bitwise without it;
    one application of the zp operator with a member axis packs the
    tangent once and launches K2b and the batched K1e once each, the
    unbatched K1e never, and agrees with B one-member operators within
    1e-5·max (R and E are bitwise per member; the quadrature's sums over
    a batch take another order in cuBLAS: 2e-6·max measured)."""
    grid, rb, _, m_prior, _, nd = _solve_world(dev)
    rng = np.random.default_rng(46)
    b = 3
    m0s = m_prior + 0.1 * torch.from_numpy(
        rng.normal(size=(b,) + grid.shape).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.normal(size=(b,) + grid.shape)
                          .astype(np.float32)).to(dev)
    geo = tec.DtecGeometry(grid, rb, nd, 0, "hermite", "zp")
    t = boxspline.prefilter(xs).reshape(b, -1, grid.shape[2]).contiguous()
    pack = tricubic.member_pack(t)
    assert torch.equal(pack.packed, kernels.pack_members(t.view(b, -1)))
    assert torch.equal(pack.packed, tricubic.pack_members_ref(t.view(b, -1)))
    assert torch.equal(
        tricubic.rows_value(t, geo.ri, geo.wxy, geo.zi, geo.wz, True,
                            pack=pack),
        tricubic.rows_value(t, geo.ri, geo.wxy, geo.zi, geo.wz, True))
    for got, want in zip(
            boxspline.interp_rows_with_grad_batched(t, grid, geo.ends, pack),
            kernels.zp_value_grad_batched(t, grid, geo.ends)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="MemberPack of another tensor"):
        boxspline.interp_rows_with_grad_batched(t.clone(), grid, geo.ends,
                                                pack)
    op = tec.dtec_paired_linear(m0s, grid, rb, nd, 0, "hermite", "zp",
                                geometry=geo)
    before = dict(kernels.launches)
    jx = op.apply(xs)
    after = {k: v - before[k] for k, v in kernels.launches.items()}
    assert after["pack_members"] == 1
    assert after["rows_value_fwd_batched"] == 1
    assert after["zp_value_grad_batched"] == 1
    assert after["zp_value_grad"] == 0
    for m in range(b):
        one = tec.dtec_paired_linear(m0s[m], grid, rb, nd, 0, "hermite",
                                     "zp", geometry=geo)
        for got, want in ((op.g0[m], one.g0), (jx[m], one.apply(xs[m]))):
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())


def test_rows_value_batched_autograd_and_stream_refusal(dev):
    """rows_value with a (B, R, nz) table: the autograd backward is K3b;
    K3b refuses a plan built on another stream."""
    ct1, ri, wxy, zi, wz, shape = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
        for a in _segment_case("one_row", 8, 3))
    rng = np.random.default_rng(42)
    n = ct1.shape[0]
    ct = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32)).to(dev)
    leaf = torch.zeros((4,) + tuple(shape), device=dev, requires_grad=True)
    out = tricubic.rows_value(leaf, ri, wxy, zi, wz, True)
    before = kernels.launches["rows_value_bwd_batched"]
    (g,) = torch.autograd.grad(out, leaf, ct)
    assert kernels.launches["rows_value_bwd_batched"] == before + 1
    want = tricubic.rows_value_transpose_ref(ct, ri, wxy, zi, wz, shape)
    assert float((g - want).abs().max()) <= 1e-4 * float(want.abs().max())
    plan = tricubic.build_row_plan(ri, shape[0], zi[:, 0])
    other = torch.cuda.Stream(dev)
    with torch.cuda.stream(other):
        with pytest.raises(ValueError, match="another CUDA stream"):
            kernels.rows_value_bwd_batched(ct, plan, wxy, zi, wz, shape[1])
    torch.cuda.synchronize()


def _rows_ad_case(dev, k, l, n=3000, rows_n=300, nz=20, b=None, seed=44):
    """rows_value's arguments (table, ri, wxy, zi, wz) and a tangent of
    each float one on the card, every index in range; with ``b``, each
    argument also with a leading member axis of b (``(plain, batched)``
    pairs)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)

    def draw(lead=()):
        return (rng.normal(size=lead + (rows_n, nz)).astype(np.float32),
                rng.integers(0, rows_n, lead + (n, k)).astype(np.int32),
                rng.normal(size=lead + (n, k)).astype(np.float32),
                (rng.integers(0, nz - l + 1, lead + (n, 1))
                 + np.arange(l)).astype(np.int32),
                rng.normal(size=lead + (n, l)).astype(np.float32))
    one = tuple(map(t, draw()))
    tans = tuple(map(t, (draw()[i] for i in (0, 2, 4))))
    return one, tans, (None if b is None else tuple(map(t, draw((b,)))))


@pytest.mark.parametrize("batched", [False, True])
def test_rows_value_table_jvp_launches_k2(dev, batched):
    """``torch.func.jvp`` with a tangent of the table alone: the primal and
    the tangent each one K2 launch (K2b for a (B, R, nz) table), the
    tangent bitwise ``rows_value`` of the tangent table on the card and
    within 1e-5·max of the CPU plain twin's."""
    (table, ri, wxy, zi, wz), (dt, _, _), _ = _rows_ad_case(dev, 8, 3)
    if batched:
        table = torch.stack([table, 2.0 * table, -table])
        dt = torch.stack([dt, -dt, 0.5 * dt])
    name = "rows_value_fwd_batched" if batched else "rows_value_fwd"
    before = kernels.launches[name]
    out, tan = torch.func.jvp(
        lambda tb: tricubic.rows_value(tb, ri, wxy, zi, wz, True),
        (table,), (dt,))
    assert kernels.launches[name] == before + 2
    assert torch.equal(tan, tricubic.rows_value(dt, ri, wxy, zi, wz, True))
    cpu = [x.cpu() for x in (dt, ri, wxy, zi, wz)]
    want = tricubic.rows_value_ref(*cpu, True)
    assert float((tan.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)],
                         ids=["zp", "cubic"])
def test_rows_value_weight_derivatives_match_the_plain_twin(dev, k, l,
                                                            xy_first):
    """Weights that need a gradient or carry a tangent: the plain twin and
    autograd on the card against the same on the CPU (reverse mode in
    table, wxy, wz; ``torch.func.jvp`` with weight and mixed tangents),
    within 1e-5·max; no K2 or K3 launch (the reference's derived-AD
    fallback has no kernel)."""
    args, (dt, dwxy, dwz), _ = _rows_ad_case(dev, k, l)
    rng = np.random.default_rng(45)
    ct = torch.from_numpy(rng.normal(size=args[1].shape[0])
                          .astype(np.float32)).to(dev)

    def grads(on):
        a = [x.to(on) for x in args]
        leaves = [a[i].clone().requires_grad_(True) for i in (0, 2, 4)]
        out = tricubic.rows_value(leaves[0], a[1], leaves[1], a[3],
                                  leaves[2], xy_first)
        return torch.autograd.grad(out, leaves, ct.to(on))

    def jvps(on):
        a = [x.to(on) for x in args]
        fn = (lambda tb, p, q: tricubic.rows_value(tb, a[1], p, a[3], q,
                                                   xy_first))
        mixed = torch.func.jvp(fn, (a[0], a[2], a[4]),
                               tuple(x.to(on) for x in (dt, dwxy, dwz)))
        weights = torch.func.jvp(lambda p: fn(a[0], p, a[4]), (a[2],),
                                 (dwxy.to(on),))
        return (*mixed, *weights)

    before = {n: kernels.launches[n] for n in ("rows_value_fwd",
                                               "rows_value_bwd")}
    on_card = grads(dev) + jvps(dev)
    assert all(kernels.launches[n] == before[n] for n in before)
    for got, want in zip(on_card, grads("cpu") + jvps("cpu")):
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.parametrize("in_axes", [
    (None, None, 0, None, 0), (0, None, 0, None, None), (None, 0, None, 0, None),
    (0, 0, 0, 0, 0)], ids=lambda a: "".join("b" if x == 0 else "." for x in a))
def test_rows_value_partial_batching_matches_the_plain_twin(dev, in_axes):
    """A member axis of B = 3 on some of (table, ri, wxy, zi, wz): one K2
    launch a member on the card, within 1e-5·max of the CPU plain twin
    member by member."""
    one, _, many = _rows_ad_case(dev, 16, 4, b=3)
    args = tuple(m if ax == 0 else o for o, m, ax in zip(one, many, in_axes))
    before = kernels.launches["rows_value_fwd"]
    got = tricubic.rows_value(*args, False)
    assert kernels.launches["rows_value_fwd"] == before + 3
    for b in range(3):
        want = tricubic.rows_value_ref(
            *((a[b] if ax == 0 else a).cpu() for a, ax in zip(args, in_axes)),
            False)
        assert float((got[b].cpu() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def _filter_world(dev, nt=2, n=16, na=5, nd=4, seed=43):
    """A small time-evolving world on the card, every input a CUDA tensor
    (so a filter call copies nothing from the host)."""
    from ionotomo_tpu_torch.models.frozen_flow import advect_periodic

    grid, m_bg = _world(dev, n=n, seed=seed)
    o, d = _rays(dev, max(na, nd), seed=seed)
    orig, dv = rays.make_ray_batch(o[:na], d[:nd])
    rb = rays.sample_straight_rays(orig, dv, n_samples=33)
    rb_in = rays.sample_straight_rays(orig, dv, n_samples=17)
    wind = torch.tensor([0.3, 0.1, 0.0], device=dev)
    rng = np.random.default_rng(seed)
    pert = torch.from_numpy(0.2 * rng.normal(size=grid.shape)
                            .astype(np.float32)).to(dev)
    cov = priors.GPCovariance.create(grid, sigma=0.3, length_scale=150.0,
                                     kind="sqexp")
    pert = cov.apply_sqrt(pert)
    d_seq = torch.stack([tec.dtec_paired_q(
        m_bg + advect_periodic(pert, grid, wind * (30.0 * t)), grid, rb, nd,
        0, "hermite", "zp") for t in range(nt)])
    noise = 0.01 * d_seq.std()

    def seq(b):
        return rays.RayBundle(b.points.expand(nt, *b.points.shape),
                              b.ds.expand(nt, *b.ds.shape))

    return dict(grid=grid, m_bg=m_bg, cov=cov, wind=wind, d_seq=d_seq,
                noise=noise, rays=seq(rb), inner=seq(rb_in), nd=nd)


@pytest.mark.parametrize("adapt", [0, 1])
def test_kalman_filter_step_waits_for_no_sync(dev, adapt):
    """After a first call has built the geometry (its plans) and the
    kernels, a whole ``kalman_filter`` call (mixed fidelity; with and
    without wind adaptation, whose k×k solve must not check its status on
    the host) runs under ``set_sync_debug_mode("error")``: the time loop
    reads nothing back. It launches ``KALMAN_KERNELS`` and no member-axis
    kernel (wind adaptation applies J to its 3 tangents as a batch: K2b),
    and is bitwise equal to the first call."""
    from ionotomo_tpu_torch.inversion.kalman import kalman_filter
    from ionotomo_tpu_torch.testing import KALMAN_KERNELS

    w = _filter_world(dev)
    cache = {}

    def run():
        return kalman_filter(
            w["grid"], w["rays"], w["d_seq"], w["noise"], w["m_bg"],
            w["cov"], w["wind"], 30.0, w["nd"], cg_iters=4, fade=0.95,
            interp="zp", rays_inner_seq=w["inner"],
            wind_adapt_iters=adapt, geometry_cache=cache)

    first = run()
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in KALMAN_KERNELS)
    assert (kernels.launches["rows_value_fwd_batched"] > 0) == bool(adapt)
    assert kernels.launches["rows_value_bwd_batched"] == 0
    assert torch.equal(first.m_seq, second.m_seq)
    assert torch.isfinite(second.m_seq).all()
    assert (second.post_residuals < second.residuals).all()


def test_ensemble_filter_step_waits_for_no_sync_and_runs_member_kernels(dev):
    """The ensemble filter under ``set_sync_debug_mode("error")`` after a
    first call: it launches ``ENKF_KERNELS``, the unbatched K2, K3 and
    K1e not at all, the endpoint transpose a multiple of B times; bitwise
    equal to the first call, and chunked = one call bitwise."""
    from ionotomo_tpu_torch.inversion.kalman import ensemble_kalman_filter
    from ionotomo_tpu_torch.testing import ENKF_KERNELS

    w = _filter_world(dev)
    b, nt = 3, w["d_seq"].shape[0]
    rng = np.random.default_rng(44)
    init = torch.from_numpy(rng.normal(size=(b,) + w["grid"].shape)
                            .astype(np.float32)).to(dev)
    obs = torch.from_numpy(rng.normal(size=(nt, b, w["d_seq"][0].numel()))
                           .astype(np.float32)).to(dev)
    cache = {}

    def run(t0=0, t1=nt, **kw):
        sl = lambda s: rays.RayBundle(s.points[t0:t1], s.ds[t0:t1])
        return ensemble_kalman_filter(
            w["grid"], sl(w["rays"]), w["d_seq"][t0:t1], w["noise"],
            w["m_bg"], w["cov"], w["wind"], 30.0, w["nd"], obs, n_members=b,
            cg_iters=4, interp="zp", rays_inner_seq=sl(w["inner"]),
            inflation=1.1, geometry_cache=cache, **kw)

    first = run(init_noise=init)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run(init_noise=init)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in ENKF_KERNELS)
    assert kernels.launches["rows_value_fwd"] == 0
    assert kernels.launches["rows_value_bwd"] == 0
    assert kernels.launches["zp_value_grad"] == 0
    assert kernels.launches["zp_value_grad_bwd"] % b == 0
    assert torch.equal(first.ensemble, second.ensemble)
    a = run(0, 1, init_noise=init)
    c = run(1, nt, ens0=a.ensemble, advect_first=True, m_clim=w["m_bg"],
            step_offset=1)
    assert torch.equal(second.ensemble, c.ensemble)
    assert torch.isfinite(second.std_seq).all()


@pytest.fixture(scope="module")
def predict_world():
    """A small ``predict`` world: ``data.synth`` at 8 antennas x 4
    directions x 2 timesteps on 16³ (the DataPack on the host, its truth
    as the Solution, the grid on the CPU)."""
    from ionotomo_tpu_torch.data.synth import generate_example_datapack
    from ionotomo_tpu_torch.inversion.solution import Solution

    dp, truth = generate_example_datapack(
        n_antennas=8, n_directions=4, n_times=2, grid_shape=(16, 16, 16),
        n_samples=33, device="cpu")
    return dp, Solution(truth["grid"], truth["m"])


@pytest.mark.parametrize("form", ["straight", "straight_rm", "bent_rm",
                                  "bent_zp_rm"])
def test_predict_on_card_matches_cpu(dev, predict_world, form):
    """``predict`` on the card against the same call on the CPU: dTEC
    within 1e-3·max|dTEC|, dRM within 1e-4·max|RM| of the rays of
    timestep 0 (RM, not dRM: dRM is a difference of nearly equal
    numbers), the form's kernels launched, two calls bitwise equal."""
    from ionotomo_tpu_torch import __main__ as cli
    from ionotomo_tpu_torch.forward import rm
    from ionotomo_tpu_torch.models.geomagnetic import dipole_b_enu_fn
    from ionotomo_tpu_torch.testing import PREDICT_FORMS

    dp, sol = predict_world
    kw, launched = PREDICT_FORMS[form]
    kw = dict(kw, samples=33, n_steps=32)
    kernels.reset_launches()
    got = cli.predict(dp, sol, device=dev, **kw)
    assert all(kernels.launches[k] > 0 for k in launched), kernels.launches
    again = cli.predict(dp, sol, device=dev, **kw)
    want = cli.predict(dp, sol, device="cpu", **kw)
    assert np.array_equal(got.dtec, again.dtec)
    scale = np.abs(want.dtec).max()
    assert np.abs(got.dtec - want.dtec).max() <= 1e-3 * scale
    if kw.get("rm"):
        assert np.array_equal(got.drm, again.drm)
        a = dp.to_device_arrays()
        m0 = torch.from_numpy(sol.m[0])
        rb = cli.predict_rays(m0, sol.grid, torch.from_numpy(
            a["antennas_enu"]), torch.from_numpy(a["directions_enu"][0]),
            dp.frequency_hz, kw.get("bent", False), 33, n_steps=32,
            interp=kw.get("interp", "cubic"))
        rm_max = float(rm.rotation_measure(
            m0, sol.grid, rb, dipole_b_enu_fn(dp.array.enu_frame,
                                              device="cpu")).abs().max())
        assert np.abs(got.drm - want.drm).max() <= 1e-4 * rm_max
        assert (got.drm[dp.ref_antenna] == 0).all()


def test_checked_on_card(dev):
    """``utils.debugging.checked`` on the card: a NaN made there raises
    with the operation's name, an out-of-bounds index tensor raises
    before it launches (no device assert), and on clean input the checked
    call returns the unchecked result bitwise."""
    from ionotomo_tpu_torch.utils.debugging import checked

    with pytest.raises(FloatingPointError, match="primitive: log"):
        checked(torch.log)(torch.tensor([1.0, -1.0], device=dev))
    x = torch.arange(3.0, device=dev)
    with pytest.raises(IndexError, match="out-of-bounds indexing"):
        checked(lambda v, i: v[i])(x, torch.tensor([5], device=dev))
    grid, m = _world(dev)
    o, d = _rays(dev, 40)
    rb = rays.sample_straight_rays(o, d, 1000.0, 65)

    def f(field):
        return tec.dtec_paired_q(field, grid, rb, 8, 0, "hermite", "cubic")

    assert torch.equal(checked(f)(m), f(m))


# --- the multi-device layer: K7, K7ᵀ and the sharded paths, S shards on
# --- one card -----------------------------------------------------------


def _sharded_points(dev, grid, n, seed):
    """Random points in and around the grid, the edge cases of
    ``edge_case_points`` and points on every x-plane (every shard seam)
    and beyond both x edges."""
    from ionotomo_tpu_torch.testing import edge_case_points

    rng = np.random.default_rng(seed)
    o, s = grid.origin.cpu().numpy(), grid.spacing.cpu().numpy()
    up = o + s * (np.asarray(grid.shape) - 1)
    xs = o[0] + s[0] * np.arange(grid.shape[0])
    seams = np.stack([np.concatenate([np.repeat(xs, 4), [o[0] - 500.0,
                                                         up[0] + 500.0]]),
                      rng.uniform(o[1] - 50, up[1] + 50, 4 * len(xs) + 2),
                      rng.uniform(o[2] - 50, up[2] + 50, 4 * len(xs) + 2)],
                     -1)
    pts = np.concatenate([
        rng.uniform(o - 60, up + 60, (n, 3)),
        edge_case_points(grid.shape, o, s, n, rng), seams])
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


@pytest.mark.parametrize("lanes", [None, 1, 4])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_cubic_sharded_sums_to_k5_bitwise(dev, n_shards, lanes,
                                          monkeypatch):
    """K7 value and value + gradient over S shards of one card, summed in
    shard order, equal K5 on the whole table bit for bit (one owner a
    point), one-shot and over a ``ShardedPoints``' orders (the owned
    points in cell order; the value at the lanes a point
    ``kernels.k7_lanes`` picks, and at one and four by its threshold),
    one launch a shard either way; each shard's ordered form bitwise its
    one-shot form, and within 1e-6·max|table| of its plain version."""
    from ionotomo_tpu_torch.parallel import grid_sharding as gs

    if lanes is not None:
        monkeypatch.setattr(kernels, "K7_QUAD_POINTS_PER_SM",
                            -1 if lanes == 1 else 1 << 30)
    grid, m = _world(dev, n=32)
    pts = _sharded_points(dev, grid, 4000, 5)
    mesh = gs.grid_mesh([dev] * n_shards)
    sf = gs.shard_field(mesh, m)
    kept = gs.ShardedPoints(mesh, grid, pts)
    if lanes is not None:
        assert all(o.lanes == lanes for o in kept.orders())
    v5, g5 = kernels.cubic_value_grad(m.reshape(-1, 32), grid, pts)
    for shards in (gs.ShardedPoints(mesh, grid, pts, ordered=False), kept):
        before = kernels.launches["cubic_sharded_value_grad"]
        v, g = shards.eval(sf, True)
        assert (kernels.launches["cubic_sharded_value_grad"]
                == before + n_shards)
        before = kernels.launches["cubic_sharded_value"]
        vv = shards.eval(sf, False)
        assert kernels.launches["cubic_sharded_value"] == before + n_shards
        assert (torch.equal(v, v5) and torch.equal(g, g5)
                and torch.equal(vv, v5))
    tol = 1e-6 * float(m.abs().max())
    for s, order in enumerate(kept.orders()):
        kv, kg = kernels.cubic_sharded_value_grad(sf.slab2d(s), grid,
                                                  sf.x0(s), sf.loc, pts)
        ov, og = kernels.cubic_sharded_value_grad(sf.slab2d(s), grid,
                                                  sf.x0(s), sf.loc, pts,
                                                  order)
        assert torch.equal(ov, kv) and torch.equal(og, kg)
        assert torch.equal(kernels.cubic_sharded_value(
            sf.slab2d(s), grid, sf.x0(s), sf.loc, pts, order), kv)
        rv, rg = gs.sharded_value_grad_ref(sf.slab2d(s), grid, sf.x0(s),
                                           sf.loc, pts)
        assert float((kv - rv).abs().max()) <= tol
        assert float((kg - rg).abs().max()) <= tol / float(grid.spacing.min())


@pytest.mark.parametrize("tasks", [None, 1, 2])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("case", ["pileup", "corner", "empty", "sizes"])
def test_cubic_sharded_transpose_at_the_task_cases(dev, case, grad, tasks,
                                                   monkeypatch):
    """K7ᵀ at the task list's cases (``tests/test_torch_k7_tasks.py``: a
    pile-up of 100 rays sharing a point at z = 0, the clamped corner of
    ≥ 10⁴ entries in one cell, a shard that owns nothing, cells of 1, 32,
    33, 64 and 65 entries), at the tasks a warp ``kernels.k7t_tasks``
    picks and at 1 and 2 by its threshold, bitwise its plain version,
    twice alike, one launch a call (none where the shard owns nothing),
    its large cells' counters left at zero."""
    from ionotomo_tpu_torch.parallel import grid_sharding as gs

    from .test_torch_k7_tasks import GRID, point_set

    if tasks is not None:
        monkeypatch.setattr(kernels, "K7T_PAIR_TASKS_PER_SM",
                            1 << 30 if tasks == 1 else 0)

    pts, x0, loc = point_set(case)
    grid = GRID.to(dev)
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    n = pts.shape[0]
    g = torch.Generator(device=dev).manual_seed(7)
    cv = torch.randn(n, generator=g, device=dev)
    cg = torch.randn((n, 3), generator=g, device=dev) if grad else None
    plan = gs.sharded_plan(grid, pts, x0, loc)
    assert tasks is None or plan.tasks_per_warp == tasks
    base = torch.randn(plan.slab_cells, generator=g, device=dev)
    name = ("cubic_sharded_value_grad_bwd" if grad
            else "cubic_sharded_value_bwd")
    before = kernels.launches[name]
    got = gs._shard_transpose_add_(base.clone(), plan, grid, cv, cg)
    again = gs._shard_transpose_add_(base.clone(), plan, grid, cv, cg)
    assert kernels.launches[name] == before + (0 if case == "empty" else 2)
    want = gs.sharded_transpose_ref(base.clone(), plan, grid, cv, cg)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not bool(plan.counters.any())


@pytest.mark.parametrize("grad", [False, True])
def test_cubic_sharded_transpose_is_its_plain_version(dev, grad):
    """K7ᵀ adding into a random slab equals its plain version (the same
    pairwise tree in passes) bit for bit, at every shard of 8 (the edge
    shards hold the clamped outside points), twice alike; the sharded
    autograd gradient within 2e-6 of the plain K5ᵀ."""
    from ionotomo_tpu_torch.parallel import grid_sharding as gs

    grid, m = _world(dev, n=32)
    pts = _sharded_points(dev, grid, 4000, 6)
    n = pts.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    cv = torch.randn(n, generator=g, device=dev)
    cg = torch.randn((n, 3), generator=g, device=dev) if grad else None
    mesh = gs.grid_mesh([dev] * 8)
    sf = gs.shard_field(mesh, m)
    name = ("cubic_sharded_value_grad_bwd" if grad
            else "cubic_sharded_value_bwd")
    for s in range(8):
        plan = gs.sharded_plan(grid, pts, sf.x0(s), sf.loc)
        base = torch.randn(plan.slab_cells, generator=g, device=dev)
        before = kernels.launches[name]
        got = gs._shard_transpose_add_(base.clone(), plan, grid, cv, cg)
        again = gs._shard_transpose_add_(base.clone(), plan, grid, cv, cg)
        assert kernels.launches[name] == before + 2
        want = gs.sharded_transpose_ref(base.clone(), plan, grid, cv, cg)
        assert torch.equal(got, want) and torch.equal(got, again)
    f = m.clone().requires_grad_(True)
    sf = gs.shard_field(mesh, f)
    if grad:
        val, gr = gs.interp_sharded_with_grad(mesh, sf, grid, pts)
        loss = torch.dot(val, cv) + torch.sum(gr * cg)
    else:
        loss = torch.dot(gs.interp_sharded(mesh, sf, grid, pts), cv)
    (got,) = torch.autograd.grad(loss, f)
    want = tricubic.interp_rows_with_grad_transpose_ref(
        grid, pts, cv, cg if grad else torch.zeros((n, 3), device=dev))
    assert float((got.reshape(-1, 32) - want).abs().max()) \
        <= 2e-6 * float(want.abs().max())


def test_ray_sharded_operator_on_card(dev):
    """The ray-sharded Hermite operator over 4 shards of one card: J
    bitwise the unsharded operator's (the per-sample values gathered in
    ray order, the quadrature whole), Jᵀ within 3e-6 of its largest
    entry; two calls of Jᵀ alike."""
    from ionotomo_tpu_torch.parallel import sharding as sm

    grid, m = _world(dev)
    o, d = _rays(dev, 64)
    rb = rays.sample_straight_rays(o, d, n_samples=33)
    srb = sm.shard_rays(sm.ray_mesh([dev] * 4), rb)
    op = tec.dtec_paired_linear(m, grid, rb, 8, 0, "hermite", "cubic")
    sop = tec.dtec_paired_linear(m, grid, srb, 8, 0, "hermite", "cubic")
    g = torch.Generator(device=dev).manual_seed(1)
    v = torch.randn(grid.shape, generator=g, device=dev)
    w = torch.randn(64, generator=g, device=dev)
    assert torch.equal(op.g0, sop.g0) and torch.equal(op.apply(v),
                                                      sop.apply(v))
    jt, ref = sop.apply_t(w), op.apply_t(w)
    assert torch.equal(jt, sop.apply_t(w))
    assert float((jt - ref).abs().max()) <= 3e-6 * float(ref.abs().max())


def test_member_groups_of_one_run_the_member_kernels(dev):
    """The member-parallel filter with 4 members over 4 groups of one
    card: each group's update runs K2b and K3b (and their pack) at B = 1;
    the filter within 2e-3 of the ensemble's departure of the unsharded
    one, twice alike."""
    from ionotomo_tpu_torch.inversion.kalman import (ensemble_kalman_filter,
                                                     initial_ensemble,
                                                     member_parallel_enkf)
    from ionotomo_tpu_torch.parallel import sharding as sm

    w = _filter_world(dev)
    b, nt = 4, w["d_seq"].shape[0]
    rng = np.random.default_rng(45)
    init = torch.from_numpy(rng.normal(size=(b,) + w["grid"].shape)
                            .astype(np.float32)).to(dev)
    obs = torch.from_numpy(rng.normal(size=(nt, b, w["d_seq"][0].numel()))
                           .astype(np.float32)).to(dev)
    args = (w["grid"], w["rays"], w["d_seq"], w["noise"], w["m_bg"],
            w["cov"], w["wind"], 30.0)
    kw = dict(num_directions=w["nd"], obs_noise=obs, n_members=b,
              cg_iters=4, interp="cubic", inflation=1.1)
    base = ensemble_kalman_filter(*args, init_noise=init, **kw)
    ens0 = initial_ensemble(w["grid"], w["cov"], w["m_bg"], init)
    mesh = sm.member_mesh([dev] * 4)
    kernels.reset_launches()
    got = member_parallel_enkf(mesh, *args, ens0=ens0, **kw)
    torch.cuda.synchronize()
    for k in ("rows_value_fwd_batched", "rows_value_bwd_batched",
              "pack_members"):
        assert kernels.launches[k] > 0, k
    assert kernels.launches["rows_value_fwd"] == 0
    again = member_parallel_enkf(mesh, *args, ens0=ens0, **kw)
    assert torch.equal(got.ensemble.gather(), again.ensemble.gather())
    scale = float((base.ensemble - w["m_bg"][None]).abs().max())
    assert float((got.ensemble.gather() - base.ensemble).abs().max()) \
        < 2e-3 * max(scale, 1.0)
    assert float((got.mean_seq - base.mean_seq).abs().max()) \
        < 2e-3 * max(scale, 1.0)
