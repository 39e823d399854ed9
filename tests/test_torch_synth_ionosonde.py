"""The port's synthetic worlds and ionosonde probes against the JAX package
on the CPU.

``generate_example_datapack`` at 12³ (6 antennas × 4 directions, 2
epochs, 17 samples) with the reference's turbulence white noise fed in
(``jax.random.normal(key(seed + 2), shape)``, what the reference draws):
its numpy parts (array, directions, times, noise, flags) bit for bit, the
truth fields within f32 noise, and the dTEC within PRECISION.md's row of
the paired path (2e-4 · max|dTEC|; the observation noise is the same
numpy draw in both). Probes: ``probes_from_arrays`` bit for bit with its
refusals (out-of-grid points, non-positive densities, shapes), the npz
format across packages, and ``bottomside_probes`` with the reference's
sounder noise fed in.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.data import ionosonde as jiono, synth as jsynth
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.data import ionosonde as tiono, synth as tsynth
from ionotomo_tpu_torch.models import chapman as tchapman

torch.set_num_threads(2)

SHAPE = (12, 12, 12)
KW = dict(n_antennas=6, n_directions=4, n_times=2, grid_shape=SHAPE,
          n_samples=17, seed=3, mjd0=58000.45)


@functools.lru_cache(maxsize=None)
def worlds(curved):
    """The JAX world and the port's from the same white noise."""
    jdp, jtruth = jsynth.generate_example_datapack(curved_earth=curved, **KW)
    white = np.array(jax.random.normal(jax.random.key(KW["seed"] + 2),
                                         SHAPE, jnp.float32))
    tdp, ttruth = tsynth.generate_example_datapack(
        curved_earth=curved, white=torch.from_numpy(white), device="cpu",
        **KW)
    return jdp, jtruth, tdp, ttruth


@pytest.mark.parametrize("curved", [False, True])
def test_example_datapack_numpy_parts_bitwise(curved):
    jdp, jtruth, tdp, ttruth = worlds(curved)
    for name in ("directions", "times", "noise_std", "flags"):
        np.testing.assert_array_equal(getattr(tdp, name),
                                      getattr(jdp, name))
    np.testing.assert_array_equal(tdp.array.itrs, jdp.array.itrs)
    assert tdp.array.labels == jdp.array.labels
    np.testing.assert_array_equal(tdp.directions_enu(), jdp.directions_enu())
    jg, tg = jtruth["grid"], ttruth["grid"]
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(tg.spacing.numpy(), np.asarray(jg.spacing))
    assert ttruth["wind_kmps"].tolist() == jtruth["wind_kmps"].tolist()


@pytest.mark.parametrize("curved", [False, True])
def test_example_datapack_fields_and_dtec_match(curved):
    """Truth fields within 1e-5 (log units: f32 FFT noise) plus 1e-5 of
    |m| (the curved Earth's altitude sqrt(r² + (R + z)²) − R cancels ~5e-4
    km of f32 rounding in either package, which shows in the deep tail of
    the layer, m ≈ −48), and dTEC within 2e-4 · max|dTEC| (PRECISION.md,
    the paired path)."""
    jdp, jtruth, tdp, ttruth = worlds(curved)
    np.testing.assert_allclose(ttruth["m_background"],
                               np.asarray(jtruth["m_background"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ttruth["m"], jtruth["m"], rtol=1e-5,
                               atol=1e-5)
    scale = np.abs(jdp.dtec).max()
    assert scale > 10.0
    np.testing.assert_allclose(tdp.dtec, jdp.dtec, rtol=0, atol=2e-4 * scale)


def test_directions_and_phase_center_bitwise():
    jdp, _, tdp, _ = worlds(False)
    pc_j = jsynth.zenith_phase_center(jdp.array, 58000.3)
    pc_t = tsynth.zenith_phase_center(tdp.array, 58000.3)
    np.testing.assert_array_equal(pc_t, pc_j)
    np.testing.assert_array_equal(tsynth.choose_directions(pc_t, 9, seed=4),
                                  jsynth.choose_directions(pc_j, 9, seed=4))


def test_white_noise_is_the_same_on_every_call():
    a = tsynth.white_noise(SHAPE, 5)
    np.testing.assert_array_equal(a.numpy(), tsynth.white_noise(SHAPE, 5))
    assert not torch.equal(a, tsynth.white_noise(SHAPE, 6))


def _grids():
    _, jtruth, _, _ = worlds(False)
    jg = jtruth["grid"]
    return jg, convert.grid_from_numpy(jg, device="cpu")


def test_probes_from_arrays_bitwise_and_npz_across_packages(tmp_path):
    jg, tg = _grids()
    rng = np.random.default_rng(8)
    lo = np.asarray(jg.origin, np.float64)
    hi = lo + np.asarray(jg.spacing, np.float64) * (np.asarray(SHAPE) - 1)
    pts = lo + (hi - lo) * rng.uniform(0.05, 0.95, (7, 3))
    ne = rng.uniform(1e10, 1e12, 7)
    noise = rng.uniform(0.02, 0.1, 7)
    jp = jiono.probes_from_arrays(jg, pts, ne, noise)
    tp = tiono.probes_from_arrays(tg, pts, ne, noise)
    for name in ("points", "values", "noise_std"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    tiono.probes_to_npz(tmp_path / "t.npz", tp)
    jiono.probes_to_npz(tmp_path / "j.npz", jp)
    for f in ("t.npz", "j.npz"):
        a = jiono.probes_from_npz(jg, tmp_path / f)
        b = tiono.probes_from_npz(tg, tmp_path / f)
        np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
        np.testing.assert_array_equal(b.points.numpy(), np.asarray(a.points))


@pytest.mark.parametrize("bad, match", [
    (dict(points_enu=[[1e5, 0.0, 300.0]]), "outside the grid"),
    (dict(ne_m3=[-1.0]), "positive"),
    (dict(noise_frac=0.0), "noise_frac"),
    (dict(ne_m3=[1e11, 2e11]), "need"),
])
def test_probes_from_arrays_refuses_what_the_reference_refuses(bad, match):
    jg, tg = _grids()
    kw = dict(points_enu=[[0.0, 0.0, 300.0]], ne_m3=[1e11], noise_frac=0.05)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        jiono.probes_from_arrays(jg, **kw)
    with pytest.raises(ValueError, match=match):
        tiono.probes_from_arrays(tg, **kw)


def test_bottomside_probes_with_fed_noise_match_jax():
    """Soundings of a Chapman truth at two stations: the same altitudes
    (the column scan agrees), values within 1e-5 with the reference's
    sounder noise fed in; an empty column raises in both."""
    jg, tg = _grids()
    m_j = jchapman.log_parametrize(jchapman.chapman_field(jg,
                                                          h_peak_km=330.0))
    m_t = tchapman.log_parametrize(tchapman.chapman_field(tg,
                                                          h_peak_km=330.0))
    stations = [[0.0, 0.0], [20.0, -15.0]]
    jp = jiono.bottomside_probes(m_j, jg, stations, n_per_station=6,
                                 noise_log=0.05, seed=2)
    noise = np.asarray(jax.random.normal(jax.random.key(2), (12,)))
    tp = tiono.bottomside_probes(m_t, tg, stations, n_per_station=6,
                                 noise_log=0.05, seed=2,
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.values.numpy(), np.asarray(jp.values),
                               rtol=0, atol=1e-5)
    assert float(tp.noise_std) == float(jp.noise_std)
    drawn = tiono.bottomside_probes(m_t, tg, stations, n_per_station=6,
                                    seed=2)
    np.testing.assert_array_equal(drawn.points.numpy(), tp.points.numpy())
    with pytest.raises(ValueError, match="sounder"):
        tiono.bottomside_probes(torch.full(SHAPE, -60.0), tg, stations)
