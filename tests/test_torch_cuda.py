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
from ionotomo_tpu_torch.core import boxspline, tricubic
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.forward import tec
from ionotomo_tpu_torch.geometry import fermat, rays
from ionotomo_tpu_torch.models import chapman

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
    assert all(n > 0 for n in kernels.launches.values())
    assert torch.equal(a, b)
    c = slice_(m.cpu(), grid.to("cpu"), ants.cpu(), dirs.cpu())
    assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(c.abs().max())
