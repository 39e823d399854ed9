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
from ionotomo_tpu_torch.core import boxspline, linalg, tricubic
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.forward import tec
from ionotomo_tpu_torch.geometry import fermat, rays
from ionotomo_tpu_torch.inversion import priors, solvers
from ionotomo_tpu_torch.models import chapman
from ionotomo_tpu_torch.probes import gather

from ionotomo_tpu_torch.testing import (SERVING_KERNELS, SOLVE_KERNELS,
                                        edge_case_points)

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
    """rk4 on CUDA runs the integrator loop with K1e as the field
    evaluator (4 launches per step)."""
    grid, m = _world(dev)
    o, d = _rays(dev, 200)
    kw = dict(n_steps=16, keep_path=True, method="rk4", interp="zp")
    before = kernels.launches["zp_value_grad"]
    b, t = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0, **kw)
    assert kernels.launches["zp_value_grad"] == before + 1 + 4 * 16
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


@pytest.mark.parametrize("rows,m", [(8, 8), (300, 300), (300, 77)])
def test_vector_gather_matches_torch_gather(dev, rows, m):
    """KG: bitwise equal to torch.gather."""
    table, idx = gather.probe_inputs(rows, 128, dev)
    idx = idx[:m].contiguous()
    before = kernels.launches["vector_gather"]
    got = gather.vector_gather(table, idx)
    assert kernels.launches["vector_gather"] == before + 1
    assert torch.equal(got, gather.vector_gather_ref(table, idx))


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
