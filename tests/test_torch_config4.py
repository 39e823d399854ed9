"""The tricubic slice as a whole: ``configs.config4`` and ``configs.config2``
at a small size on the CPU, the config-4 schedule held to the JAX
package's ``map_gauss_newton`` run through the same schedule on the same
world.

The world (16³ grid enclosing 8 × 6 rays, an analytic Chapman × Fourier-
mode truth traced by the callable tracer at 64 steps, 1 % noise drawn by
numpy from a seed, von Kármán prior) is built by the port and carried
across as numpy; its parts are held to the reference in
``test_torch_turbulence.py``. Solvers are compared by norms, not
elementwise (truncated CG amplifies f32 rounding): the final whitened
residual and the held-out dTEC rms within 1e-3 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import rays as jrays
from ionotomo_tpu.inversion import solvers as jsolvers
from ionotomo_tpu.inversion.priors import GPCovariance as JGPCovariance
from ionotomo_tpu_torch import configs

torch.set_num_threads(2)

CG1, CG2 = 8, 5


@pytest.fixture(scope="module")
def world():
    return configs.config4_world(shape=(16, 16, 16), n_ants=8, n_dirs=6,
                                 n_modes=48, trace_steps=64,
                                 heldout=(4, 5, 99), device="cpu")


def _jax_bundle(rb):
    return jrays.RayBundle(points=jnp.asarray(rb.points.numpy()),
                           ds=jnp.asarray(rb.ds.numpy()))


def _jax_schedule(w, interp_inner):
    """``bench/config4.py``'s progressive warm-started schedule through
    the reference solver, on the port's world."""
    jg = JGrid.create(w.grid.origin.numpy(), w.grid.spacing.numpy(),
                      w.grid.shape)
    cov = JGPCovariance.create(jg, sigma=0.3, length_scale=80.0,
                               kind="von_karman")
    d, m_prior = jnp.asarray(w.d_obs.numpy()), jnp.asarray(w.m_prior.numpy())
    kw = dict(num_directions=w.n_dirs, gn_iters=1, quadrature="hermite",
              interp="cubic", warm_start=True, interp_inner=interp_inner)
    r1 = jsolvers.map_gauss_newton(jg, _jax_bundle(w.rays_inner), d, w.noise,
                                   m_prior, cov, cg_iters=CG1, **kw)
    r2 = jsolvers.map_gauss_newton(jg, _jax_bundle(w.rays), d, w.noise,
                                   m_prior, cov, cg_iters=CG2, m0=r1.m,
                                   u0=r1.u_final, **kw)
    ants_h, dirs_h, d_h = w.heldout
    o, dv = jrays.make_ray_batch(ants_h, dirs_h)
    rb_h = jrays.sample_straight_rays(o, dv, n_samples=129)
    g = jtec.dtec_paired(r2.m, jg, rb_h, dirs_h.shape[0], 0, "cubic")
    heldout = float(jnp.sqrt(jnp.mean((g - jnp.asarray(d_h.numpy())) ** 2)))
    return float(r2.residual_norm), heldout, np.asarray(r2.m)


@pytest.mark.parametrize("interp_inner", [None, "zp", "zpc2"],
                         ids=["cubic", "cubic_outer_zp_inner",
                              "cubic_outer_zpc2_inner"])
def test_config4_schedule_matches_jax(world, interp_inner):
    """Residual norm and held-out dTEC rms within 1e-3 relative of the
    reference's; the solve beats the prior on held-out rays; the field
    agrees to 2 % of its departure from the prior."""
    rec = configs.config4(world=world, warmup=False, cg_iters=CG1, cg2=CG2,
                          interp_inner=interp_inner)
    res_j, ho_j, m_j = _jax_schedule(world, interp_inner)
    assert abs(rec["residual_norm"] - res_j) <= 1e-3 * res_j
    assert abs(rec["heldout_dtec_rms_post"] - ho_j) <= 1e-3 * ho_j
    assert rec["heldout_dtec_rms_post"] < rec["heldout_dtec_rms_prior"]
    assert rec["interp"] == "cubic" and rec["interp_inner"] == interp_inner
    assert rec["n_samples"] == 65 and rec["inner_samples"] == 33
    assert rec["last_step_cg_iterations"] == CG2
    res = configs.config4_solve(world, cg_iters=CG1, cg2=CG2,
                                interp_inner=interp_inner)
    dep = np.sqrt(np.mean((m_j - world.m_prior.numpy()) ** 2))
    assert np.sqrt(np.mean((res.m.numpy() - m_j) ** 2)) <= 2e-2 * dep
    assert res.u_final is not None


def test_config4_world_is_what_the_bench_builds(world):
    w = world
    assert tuple(w.d_obs.shape) == (8, 6) and w.n_dirs == 6
    assert bool((w.d_obs[0].abs() <= 3 * 5 * w.noise).all())   # antenna 0
    assert w.rays.num_samples == 65 and w.rays_inner.num_samples == 33
    assert w.rays.num_rays == w.rays_inner.num_rays == 48
    assert w.cov.kind == "von_karman" and w.cov.sigma == 0.3
    ants_h, dirs_h, d_h = w.heldout
    assert ants_h.shape == (4, 3) and dirs_h.shape == (5, 3)
    assert tuple(d_h.shape) == (4, 5) and bool((d_h[0] == 0).all())
    # the truth departs from the prior by the mode sum, amplitude 0.25
    pert = (w.m_true - w.m_prior).numpy()
    assert 0.1 < pert.std() < 0.4
    # a second build from the same seeds gives the same data to the bit
    again = configs.config4_world(shape=(16, 16, 16), n_ants=8, n_dirs=6,
                                  n_modes=48, trace_steps=64,
                                  heldout=(4, 5, 99), device="cpu")
    assert torch.equal(again.d_obs, w.d_obs) and again.noise == w.noise


def test_config4_single_fidelity_schedule_and_metrics(world):
    """``progressive=False``: two Gauss-Newton steps on the full bundle
    with the coarse one as the inner Jacobian; the metrics are finite and
    the covered RMSE does not grow."""
    rec = configs.config4(world=world, warmup=False, progressive=False,
                          cg_iters=6, warm_start=False)
    assert rec["last_step_cg_iterations"] <= 12
    assert np.isfinite([rec[k] for k in (
        "value", "residual_norm", "covered_rmse_prior", "covered_rmse_post",
        "heldout_dtec_rms_prior", "heldout_dtec_rms_post")]).all()
    assert rec["covered_rmse_post"] <= rec["covered_rmse_prior"] * 1.05
    assert rec["heldout_dtec_rms_post"] < rec["heldout_dtec_rms_prior"]


def test_covered_rmse_and_heldout_match_the_bench_helpers(world):
    """``covered_rmse`` and ``heldout_dtec_rms`` against the same formulas
    written with the reference's operators: 1e-4 relative."""
    w = world
    jg = JGrid.create(w.grid.origin.numpy(), w.grid.spacing.numpy(),
                      w.grid.shape)
    m = w.m_prior + 0.05 * torch.from_numpy(np.random.default_rng(61).normal(
        size=w.grid.shape).astype(np.float32))
    cover = jtec.ray_coverage(jg, _jax_bundle(w.rays))
    mask = np.asarray(cover > 0.05 * cover.max())
    e = np.where(mask, m.numpy() - w.m_true.numpy(), 0.0)
    want = float(np.sqrt(np.sum(e * e) / max(mask.sum(), 1)))
    got = configs.covered_rmse(m, w.m_true, w.grid, w.rays)
    assert abs(got - want) <= 1e-4 * want
    ants_h, dirs_h, d_h = w.heldout
    o, dv = jrays.make_ray_batch(ants_h, dirs_h)
    g = jtec.dtec_paired(jnp.asarray(m.numpy()), jg,
                         jrays.sample_straight_rays(o, dv, n_samples=129),
                         5, 0, "cubic")
    want = float(np.sqrt(np.mean((np.asarray(g) - d_h.numpy()) ** 2)))
    got = configs.heldout_dtec_rms(m, w.grid, ants_h, dirs_h, d_h)
    assert abs(got - want) <= 1e-4 * want


def test_config2_small_runs_the_default_model_on_the_cpu():
    rec = configs.config2(shape=(12, 12, 12), n_ants=3, n_dirs=4,
                          n_saturated=1024, n_steps=8, reps=(1, 1),
                          device="cpu")
    assert rec["interp"] == "cubic" and rec["rays_6200"] == 12
    assert rec["rays_saturated"] == 1024
    assert rec["finite_6200"] and rec["finite_saturated"]
    assert rec["bent_rays_per_sec_saturated"] > 0


def test_make_rays_draws_what_the_bench_draws():
    from bench.common import make_rays as bench_make_rays

    for args in ((5, 7), (3, 4, 99)):
        a, d = configs.make_rays(*args)
        ba, bd = bench_make_rays(*args)
        np.testing.assert_array_equal(a, ba)
        np.testing.assert_array_equal(d, bd)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)


def test_configs_default_to_the_card(monkeypatch):
    """No device named and no card: the entry points raise rather than
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.config2(shape=(8, 8, 8), n_saturated=512)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.config4_world(shape=(8, 8, 8), n_ants=2, n_dirs=2)
