"""Parity of the port's analytic and spectral turbulence worlds and of the
closed-form Chapman backgrounds with the JAX package, and of the callable
tracer that generates the inversion configs' data through them.

``FourierModes`` is seeded by numpy in both packages, so its arrays must
be equal to the bit; the mode sum is taken in one (N, K) pass here and by
a scan over the modes there, so values agree to 1e-4·amplitude (the phase
k·x + φ reaches ~10² rad, where one f32 ulp is ~1e-5 rad, and K such
errors of a·√(2/K) each add in quadrature). Every input is drawn from its
own ``np.random.default_rng(seed)``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu.models import chapman as jchapman, turbulence as jturb
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.geometry import fermat as tfermat
from ionotomo_tpu_torch.models import chapman as tchapman, turbulence as tturb

from tests.test_torch_fermat import ray_fan

torch.set_num_threads(2)

AMP, N_MODES, KMAX = 0.25, 96, np.pi / 30.0


def _modes(seed=11):
    jm = jturb.FourierModes(N_MODES, AMP, 120.0, KMAX, seed=seed)
    tm = tturb.FourierModes(N_MODES, AMP, 120.0, KMAX, seed=seed,
                            device="cpu")
    return jm, tm


def _points(seed, n=400):
    return np.random.default_rng(seed).uniform(
        (-200, -200, 0), (200, 200, 600), (n, 3)).astype(np.float32)


def test_fourier_modes_arrays_equal_the_reference_bitwise():
    jm, tm = _modes()
    np.testing.assert_array_equal(tm.ks.numpy(), np.asarray(jm.ks))
    np.testing.assert_array_equal(tm.phases.numpy(), np.asarray(jm.phases))
    assert np.float32(tm.amp) == np.float32(jm.amp)
    carried = convert.fourier_modes_from_numpy(jm.ks, jm.phases, jm.amp,
                                               device="cpu")
    assert torch.equal(carried.ks, tm.ks) and carried.amp == tm.amp
    assert torch.equal(carried.phases, tm.phases)


def test_fourier_modes_value_and_gradient_match_jax():
    """Value to 1e-4·amplitude, gradient to 1e-4·amplitude·k_max."""
    jm, tm = _modes()
    pts = _points(51)
    want = np.asarray(jm.value(jnp.asarray(pts)))
    got = tm.value(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * AMP)
    jv, jg = jm.value_and_grad(jnp.asarray(pts))
    tv, tg = tm.value_and_grad(torch.from_numpy(pts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-4 * AMP)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * AMP * KMAX)
    assert np.abs(got).max() > 0.1 * AMP


def test_fourier_modes_chunked_pass_equals_one_pass():
    """A bound on the (points × modes) block only splits the points."""
    _, tm = _modes()
    pts = torch.from_numpy(_points(52, n=257))
    whole_v, whole_g = tm.value_and_grad(pts)
    small = convert.fourier_modes_from_numpy(tm.ks.numpy(),
                                             tm.phases.numpy(), tm.amp,
                                             device="cpu")
    small.PASS_ELEMENTS = 40 * N_MODES
    v, g = small.value_and_grad(pts)
    np.testing.assert_allclose(v.numpy(), whole_v.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), whole_g.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(small.value(pts).numpy(), whole_v.numpy(),
                               rtol=0, atol=1e-6)


def test_fourier_modes_shifted_matches_jax_and_translates_the_world():
    jm, tm = _modes()
    dx = np.asarray([12.5, -7.0, 3.0], np.float32)
    js, ts = jm.shifted(dx), tm.shifted(dx)
    np.testing.assert_allclose(ts.phases.numpy(), np.asarray(js.phases),
                               rtol=0, atol=1e-5)
    pts = _points(53)
    np.testing.assert_allclose(ts.value(torch.from_numpy(pts)).numpy(),
                               np.asarray(js.value(jnp.asarray(pts))),
                               rtol=0, atol=1e-4 * AMP)
    np.testing.assert_allclose(ts.value(torch.from_numpy(pts + dx)).numpy(),
                               tm.value(torch.from_numpy(pts)).numpy(),
                               rtol=0, atol=2e-4 * AMP)


BACKGROUNDS = {
    "single": {},
    "single_sun": dict(cos_chi=0.4, h_peak_km=300.0),
    "curved": dict(curved=True, site_height_km=0.2),
    "layers": dict(layers=jchapman.DEFAULT_LAYERS, cos_chi=0.7,
                   plasmasphere_n0=1e10),
    "layers_curved": dict(layers=jchapman.DEFAULT_LAYERS, curved=True),
}


@pytest.mark.parametrize("case", sorted(BACKGROUNDS))
def test_background_ne_fn_matches_jax(case):
    """n_e to 5e-6 relative on the flat Earth; ∇n_e (autograd here,
    ``jax.value_and_grad`` under ``vmap`` there) to 2e-5·max|∇n_e|. On the
    curved Earth the altitude is sqrt(r² + (R + z)²) − R in f32, whose
    last bit is 5e-4 km, a relative 5e-5 of n_e at the E layer's 10 km
    scale height and more below it: 5e-4 relative and 2e-4·max|∇n_e|."""
    kw = BACKGROUNDS[case]
    rtol, gtol = (5e-4, 2e-4) if kw.get("curved") else (5e-6, 2e-5)
    pts = _points(54)
    jn, jg = jchapman.background_ne_fn(**kw)(jnp.asarray(pts))
    tkw = dict(kw)
    if "layers" in tkw:
        assert tchapman.DEFAULT_LAYERS == jchapman.DEFAULT_LAYERS
        tkw["layers"] = tchapman.DEFAULT_LAYERS
    tn, tg = tchapman.background_ne_fn(**tkw)(torch.from_numpy(pts))
    assert not tn.requires_grad and not tg.requires_grad
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=rtol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=gtol * np.abs(np.asarray(jg)).max())


def test_background_ne_fn_refuses_a_cos_chi_map():
    with pytest.raises(ValueError, match="scalar cos_chi"):
        tchapman.background_ne_fn(cos_chi=np.ones((4, 4, 1)))


@pytest.mark.parametrize("curved", [False, True])
def test_multi_chapman_field_matches_jax(curved):
    """5e-6 relative on the flat Earth, 5e-4 on the curved one (the f32
    altitude, as in ``test_background_ne_fn_matches_jax``)."""
    jg = JGrid.from_bounds((-300, -300, 60.0), (300, 300, 900.0), (7, 6, 15))
    tg = convert.grid_from_numpy(jg, device="cpu")
    cc = np.random.default_rng(55).uniform(0.0, 1.0, (7, 6, 1)
                                           ).astype(np.float32)
    for cos_chi in (None, 0.3, cc):
        want = np.asarray(jchapman.multi_chapman_field(
            jg, cos_chi=None if cos_chi is None else jnp.asarray(cos_chi),
            plasmasphere_n0=2e10, curved=curved))
        got = tchapman.multi_chapman_field(tg, cos_chi=cos_chi,
                                           plasmasphere_n0=2e10,
                                           curved=curved)
        assert tuple(got.shape) == (7, 6, 15)
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=5e-4 if curved else 5e-6)


def test_analytic_ne_fn_matches_jax():
    """n_e = n_bg·e^{m_pert} to 1e-4·amplitude relative; its gradient to
    1e-4·max|∇n_e|."""
    jm, tm = _modes()
    pts = _points(56)
    jn, jg = jturb.analytic_ne_fn(jm, jchapman.background_ne_fn())(
        jnp.asarray(pts))
    tn, tg = tturb.analytic_ne_fn(tm, tchapman.background_ne_fn())(
        torch.from_numpy(pts))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4 * AMP)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())


def test_turbulent_log_perturbation_on_jax_drawn_noise_matches_jax():
    """The port is fed the white noise the reference draws from its key:
    1e-4·amplitude (two f32 FFTs of different libraries); zero mean and
    the requested rms by construction. A batch is normalised member by
    member."""
    jg = JGrid.from_bounds((-100, -100, 0.0), (100, 100, 400.0), (12, 10, 16))
    tg = convert.grid_from_numpy(jg, device="cpu")
    white = np.asarray(jax.random.normal(jax.random.key(5), jg.shape,
                                         jnp.float32))
    want = np.asarray(jturb.turbulent_log_perturbation(
        jg, amplitude=0.3, outer_scale_km=80.0, seed=5))
    got = tturb.turbulent_log_perturbation(tg, white, amplitude=0.3,
                                           outer_scale_km=80.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 0.3)
    assert abs(float(got.mean())) < 1e-6
    np.testing.assert_allclose(float(got.std(correction=0)), 0.3, rtol=1e-5)
    np.testing.assert_allclose(
        tturb._wavenumbers(tg).numpy(), np.asarray(jturb._wavenumbers(jg)),
        rtol=1e-6)
    both = tturb.turbulent_realizations(tg, np.stack([white, -2 * white]),
                                        amplitude=0.3, outer_scale_km=80.0)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), atol=1e-6)
    np.testing.assert_allclose(both[1].numpy(), -got.numpy(), atol=1e-6)


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
def test_trace_rays_callable_matches_jax(method):
    """The bent trace through the closed-form world (how the inversion
    configs make their data): TEC to 1e-4 relative, endpoints to 1e-3 km."""
    jm, tm = _modes()
    o, d = ray_fan(40, seed=57)
    kw = dict(n_steps=48, keep_path=False, method=method)
    jb, jt = jfermat.trace_rays_callable(
        jturb.analytic_ne_fn(jm, jchapman.background_ne_fn()),
        jnp.asarray(o), jnp.asarray(d), 150e6, 1000.0, **kw)
    tb, tt = tfermat.trace_rays_callable(
        tturb.analytic_ne_fn(tm, tchapman.background_ne_fn()),
        torch.from_numpy(o), torch.from_numpy(d), 150e6, 1000.0, **kw)
    assert tuple(tb.points.shape) == (40, 2, 3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4)
    np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                               rtol=0, atol=1e-3)
