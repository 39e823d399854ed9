"""``ionotomo_tpu_torch.models.frozen_flow`` against the JAX package: the
spectral advection (rigid and shear), its analytic tangents against JAX's
forward-mode tangents, the member axis, ``estimate_wind`` and
``frozen_flow_sequence``. CPU tensors, numpy-seeded inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.models import frozen_flow as jff
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.models import frozen_flow as tff

torch.set_num_threads(2)

SHIFTS = {
    "rigid": np.array([13.7, -8.2, 21.0], np.float32),
    "shear": np.array([[13.7, -8.2, 21.0], [9.1, 4.4, 0.0]], np.float32),
}


def _world(seed, shape=(16, 12, 10)):
    rng = np.random.default_rng(seed)
    jg = JGrid.from_bounds((-200, -150, 0.0), (200, 150, 400.0), shape)
    field = rng.normal(size=shape).astype(np.float32)
    return jg, convert.grid_from_numpy(jg, device="cpu"), field


@pytest.mark.parametrize("kind", ["rigid", "shear"])
def test_advect_periodic_matches_jax(kind):
    """Tolerance 2e-6·max|field| (f32 FFT pair) on a 16×12×10 field."""
    jg, tg, field = _world(100)
    want = np.asarray(jff.advect_periodic(jnp.asarray(field), jg,
                                          jnp.asarray(SHIFTS[kind])))
    got = tff.advect_periodic(torch.from_numpy(field), tg,
                              SHIFTS[kind]).numpy()
    assert got.dtype == np.float32 and got.shape == field.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(field).max())


@pytest.mark.parametrize("kind", ["rigid", "shear"])
def test_advect_periodic_member_axis_is_per_member(kind):
    """A leading member axis: each member equals the unbatched call to
    1e-6·max (the batched FFT may round differently)."""
    _, tg, _ = _world(101)
    rng = np.random.default_rng(101)
    ens = torch.from_numpy(rng.normal(size=(3,) + tg.shape)
                           .astype(np.float32))
    got = tff.advect_periodic(ens, tg, SHIFTS[kind])
    assert got.shape == ens.shape
    for b in range(3):
        one = tff.advect_periodic(ens[b], tg, SHIFTS[kind])
        assert float((got[b] - one).abs().max()) <= 1e-6 * float(
            ens.abs().max())


@pytest.mark.parametrize("kind", ["rigid", "shear"])
def test_advect_tangents_match_jax_forward_mode(kind):
    """``advect_periodic_tangents`` against ``jax.jvp`` of the reference's
    advection along each shift component. Tolerance 1e-5·max|tangent|."""
    jg, tg, field = _world(102)
    shift = SHIFTS[kind]
    got = tff.advect_periodic_tangents(torch.from_numpy(field), tg,
                                       shift).numpy()
    assert got.shape == (shift.size,) + field.shape
    basis = np.eye(shift.size, dtype=np.float32).reshape(
        (shift.size,) + shift.shape)
    for j, e in enumerate(basis):
        _, want = jax.jvp(
            lambda s: jff.advect_periodic(jnp.asarray(field), jg, s),
            (jnp.asarray(shift),), (jnp.asarray(e),))
        want = np.asarray(want)
        np.testing.assert_allclose(
            got[j], want, rtol=0,
            atol=1e-5 * max(np.abs(want).max(), np.abs(got).max()))
    if kind == "shear":
        assert not got[5].any()          # row 1's v_z does nothing


def test_estimate_wind_recovers_a_known_shift():
    """As ``tests/test_wind_calcrays.py`` expects of the reference: the
    horizontal wind within 0.03 km/s, the loss falling; and the port's
    estimate within 5e-3 km/s of the reference's on the same fields."""
    rng = np.random.default_rng(103)
    jg = JGrid.from_bounds((0, 0, 0), (400, 400, 400), (16, 16, 16))
    tg = convert.grid_from_numpy(jg, device="cpu")
    # a smooth field: low-pass filtered noise
    white = rng.normal(size=jg.shape)
    spec = np.fft.fftn(white)
    k = np.sqrt(sum(np.meshgrid(*[np.fft.fftfreq(n) ** 2 for n in jg.shape],
                                indexing="ij")))
    pert = np.real(np.fft.ifftn(spec * np.exp(-(k / 0.08) ** 2)))
    pert = (0.5 * pert / np.abs(pert).max()).astype(np.float32)
    v_true = np.array([0.25, -0.1, 0.0], np.float32)
    dt = 120.0
    pert_b = np.array(jff.advect_periodic(jnp.asarray(pert), jg,
                                            jnp.asarray(v_true * dt)))
    jv, jhist = jff.estimate_wind(jnp.asarray(pert), jnp.asarray(pert_b), jg,
                                  dt, n_iters=150, lr=0.02)
    tv, thist = tff.estimate_wind(torch.from_numpy(pert),
                                  torch.from_numpy(pert_b), tg, dt,
                                  n_iters=150, lr=0.02)
    np.testing.assert_allclose(tv.numpy()[:2], v_true[:2], atol=0.03)
    assert float(thist[-1]) < float(thist[0]) and thist.shape == (150,)
    assert float(tv[2]) == 0.0
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=5e-3)
    np.testing.assert_allclose(float(thist[0]), float(jhist[0]), rtol=1e-4)


def test_frozen_flow_sequence_matches_jax():
    """Tolerance 2e-6·max|field| per step."""
    jg, tg, field = _world(104)
    wind = np.array([0.3, 0.1, 0.0], np.float32)
    want = np.asarray(jff.frozen_flow_sequence(jnp.asarray(field), jg, wind,
                                               30.0, 4))
    got = tff.frozen_flow_sequence(torch.from_numpy(field), tg, wind, 30.0,
                                   4).numpy()
    assert got.shape == (4,) + field.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(field).max())
