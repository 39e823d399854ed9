"""Parity of the port's Krylov solvers, GP prior, smoothness operator and
ray-enclosing grid with the JAX package on the same numpy-seeded inputs.

- ``cg``/``lsqr`` on seeded SPD / least-squares systems: x within 1e-5
  relative. The systems are well conditioned
  (30, 10) and solved to convergence: part-way, f32 Krylov iterates of
  the two packages drift apart by ~2e-4 (measured: LSQR at 20-30 of the
  40 iterations it needs) from sums taken in another order;
- ``GPCovariance.create``: the spectrum bitwise equal (the same numpy
  code, one f64→f32 rounding); ``apply*`` within 1e-5·max|out| (cuFFT /
  pocketfft against XLA's FFT);
- ``laplacian`` and ``grid_enclosing_rays``: bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import linalg as jlinalg
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.inversion import priors as jpriors
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import linalg as tlinalg
from ionotomo_tpu_torch.inversion import priors as tpriors
from ionotomo_tpu_torch.models import chapman as tchapman

torch.set_num_threads(2)


def _spd(n=60, cond=30.0, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = (q * np.geomspace(1.0, cond, n)) @ q.T
    return a.astype(np.float32), rng.normal(size=(n,)).astype(np.float32), rng


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


@pytest.mark.parametrize("case", ["cold", "warm_scaled", "preconditioned",
                                  "masked"])
def test_cg_matches_jax(case):
    a, b, rng = _spd()
    x0 = rng.normal(size=b.shape).astype(np.float32)
    diag = np.diag(a).copy()
    kw = dict(max_iters=40, tol=1e-5)
    if case == "warm_scaled":
        kw.update(scale_x0=True)
    if case == "masked":
        kw.update(tol=1e-2)      # converges early; later updates masked
    jkw, tkw = dict(kw), dict(kw)
    if case == "warm_scaled":
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), torch.from_numpy(x0)
    if case == "preconditioned":
        jkw["preconditioner"] = lambda v: v / jnp.asarray(diag)
        tkw["preconditioner"] = lambda v: v / torch.from_numpy(diag)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jx, jinfo = jlinalg.cg(lambda v: jnp.matmul(ja, v, precision="highest"),
                           jnp.asarray(b), **jkw)
    tx, tinfo = tlinalg.cg(lambda v: ta @ v, torch.from_numpy(b), **tkw)
    assert _rel(tx, jx) <= 1e-5
    # the masked stop tests a recursive residual near the f32 floor, so
    # the step it freezes at may differ by one
    assert abs(int(tinfo.iterations) - int(jinfo.iterations)) <= 1
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert abs(float(tinfo.residual_norm) - float(jinfo.residual_norm)) \
        <= 1e-4 * np.linalg.norm(b)
    if case == "masked":
        assert int(tinfo.iterations) < kw["max_iters"]


@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_lsqr_matches_jax(damp):
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(rng.normal(size=(80, 40)))
    v, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    a = ((u * np.geomspace(1.0, 10.0, 40)) @ v.T).astype(np.float32)
    b = rng.normal(size=(80,)).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jx, jinfo = jlinalg.lsqr(lambda x: jnp.matmul(ja, x, precision="highest"),
                             lambda y: jnp.matmul(ja.T, y,
                                                  precision="highest"),
                             jnp.asarray(b), jnp.zeros(40, jnp.float32),
                             damp=damp, max_iters=40)
    tx, tinfo = tlinalg.lsqr(lambda x: ta @ x, lambda y: ta.T @ y,
                             torch.from_numpy(b), torch.zeros(40),
                             damp=damp, max_iters=40)
    assert _rel(tx, jx) <= 1e-5
    assert int(tinfo.iterations) == int(jinfo.iterations)
    lstsq = np.linalg.solve(a.T @ a + damp ** 2 * np.eye(40), a.T @ b)
    assert _rel(tx, lstsq) <= 1e-4
    assert abs(float(tinfo.residual_norm) - float(jinfo.residual_norm)) \
        <= 1e-3 * np.linalg.norm(a.T @ b)


@pytest.mark.parametrize("solver", ["cg", "lsqr"])
def test_krylov_loops_never_read_a_tensor_on_the_host(solver, monkeypatch):
    """The fixed trip count asks nothing of the device: every way a tensor
    reaches the host (item, bool, float, int, tolist, numpy) raises while
    the solver runs, and the result is the one an unguarded run gives."""
    a, b, _ = _spd(n=20)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def solve():
        if solver == "cg":
            return tlinalg.cg(lambda v: ta @ v, tb, max_iters=30, tol=1e-5)
        return tlinalg.lsqr(lambda v: ta @ v, lambda y: ta.T @ y, tb,
                            torch.zeros(20), damp=0.1, max_iters=30)

    def read(*_args, **_kw):
        raise AssertionError("host read inside the Krylov loop")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)
    guarded, _ = solve()
    monkeypatch.undo()
    assert torch.equal(guarded, solve()[0])


def _grids():
    jg = JGrid.from_bounds((-120.0, -90.0, 0.0), (110.0, 100.0, 700.0),
                           (10, 12, 9))
    return jg, convert.grid_from_numpy(jg)


KINDS = [("exponential", 50.0), ("sqexp", 80.0), ("matern32", 60.0),
         ("matern52", 70.0), ("von_karman", 120.0),
         ("matern32", (90.0, 60.0, 30.0)), ("von_karman", (150.0, 90.0, 40.0))]


@pytest.mark.parametrize("kind,length_scale", KINDS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(KINDS)])
def test_gp_spectrum_is_bitwise_the_reference(kind, length_scale):
    jg, tg = _grids()
    jc = jpriors.GPCovariance.create(jg, sigma=0.3, length_scale=length_scale,
                                     kind=kind)
    tc = tpriors.GPCovariance.create(tg, sigma=0.3, length_scale=length_scale,
                                     kind=kind)
    np.testing.assert_array_equal(tc.spectrum.numpy(),
                                  np.asarray(jc.spectrum))
    assert (tc.shape, tc.sigma, tc.length_scale, tc.kind) == \
        (jc.shape, jc.sigma, jc.length_scale, jc.kind)
    carried = convert.gp_covariance_from_numpy(jc)
    np.testing.assert_array_equal(carried.spectrum.numpy(),
                                  tc.spectrum.numpy())
    assert (carried.shape, carried.sigma, carried.length_scale,
            carried.kind) == (tc.shape, tc.sigma, tc.length_scale, tc.kind)


@pytest.mark.parametrize("kind", ["sqexp", "von_karman"])
def test_gp_apply_family_matches_jax(kind):
    jg, tg = _grids()
    jc = jpriors.GPCovariance.create(jg, sigma=0.3, length_scale=90.0,
                                     kind=kind)
    tc = tpriors.GPCovariance.create(tg, sigma=0.3, length_scale=90.0,
                                     kind=kind)
    v = np.random.default_rng(2).normal(size=jg.shape).astype(np.float32)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    for name in ("apply", "apply_sqrt", "apply_inv"):
        want = np.asarray(getattr(jc, name)(jv))
        got = getattr(tc, name)(tv).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    want = float(jc.contract(jv))
    assert abs(float(tc.contract(tv)) - want) <= 1e-5 * abs(want)
    # sample(noise) is apply_sqrt of the given white noise, batched too
    batch = np.stack([v, 2 * v])
    got = tc.sample(torch.from_numpy(batch)).numpy()
    want = np.asarray(jc.apply_sqrt(jv))
    assert np.abs(got[1] - 2 * want).max() <= 2e-5 * np.abs(want).max()


def test_laplacian_is_bitwise_the_reference():
    jg, tg = _grids()
    f = np.random.default_rng(3).normal(size=jg.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tpriors.laplacian(torch.from_numpy(f), tg).numpy(),
        np.asarray(jpriors.laplacian(jnp.asarray(f), jg)))


@pytest.mark.parametrize("h_min_km", [None, 0.0])
def test_grid_enclosing_rays_is_bitwise_the_reference(h_min_km):
    rng = np.random.default_rng(4)
    ants = np.concatenate([rng.uniform(-150, 150, (7, 2)),
                           rng.uniform(0, 1, (7, 1))], -1)
    zen = rng.uniform(0.05, 0.6, 5)
    az = rng.uniform(0, 2 * np.pi, 5)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    jg = jchapman.grid_enclosing_rays(ants, dirs, shape=(16, 12, 20),
                                      h_min_km=h_min_km)
    tg = tchapman.grid_enclosing_rays(ants, dirs, shape=(16, 12, 20),
                                      h_min_km=h_min_km)
    assert tg.shape == jg.shape
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(tg.spacing.numpy(), np.asarray(jg.spacing))
