"""Faraday rotation in the port (``models.geomagnetic``, ``forward.rm``)
against the JAX package on the CPU, on ``tests/test_rm.py``'s 24³ Chapman
world (3 antennas x 3 directions, 900 km, 65 samples).

- the dipole: the moment bit for bit (a numpy copy); B in ECEF and the ENU
  closure within rtol 1e-6 of the reference's f32 values (one f32 order,
  summed by different libraries), and ``tests/test_rm.py``'s physics;
- ``_tangents`` within 1e-6 on straight and bent bundles;
- ``rotation_measure`` and ``drm`` within 1e-5·max|RM| on the same
  bundles, straight and bent (a leapfrog path at 64 steps fed to both),
  the reference antenna's dRM row exactly 0;
- the uniform-field identity RM = K_RM·B·TEC (rtol 1e-5, as the
  reference's test);
- RM's n_e gather is on the cubic model under ``predict --interp zp``, as
  the reference's ``rotation_measure`` takes no ``interp``.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.forward import rm as jrm
from ionotomo_tpu.geometry import frames as jframes, rays as jrays
from ionotomo_tpu.models import geomagnetic as jgeo
from tests.test_rm import _world
from ionotomo_tpu_torch import __main__ as tcli, constants, convert
from ionotomo_tpu_torch.data import synth as tsynth
from ionotomo_tpu_torch.forward import rm as trm, tec as ttec
from ionotomo_tpu_torch.geometry import (fermat as tfermat, frames as tframes,
                                         rays as trays)
from ionotomo_tpu_torch.inversion.solution import Solution
from ionotomo_tpu_torch.models import geomagnetic as tgeo

torch.set_num_threads(2)

SITE = (np.deg2rad(52.9), np.deg2rad(6.87))
CPU = "cpu"


def _b_fns():
    site = jframes.geodetic_to_ecef(*SITE)
    return (jgeo.dipole_b_enu_fn(jframes.ENUFrame(site)),
            tgeo.dipole_b_enu_fn(tframes.ENUFrame(site), device=CPU))


@functools.lru_cache(maxsize=None)
def _bundles(kind):
    """The 24³ world and one bundle as (JAX, port) pairs holding the same
    points: straight, or the port's leapfrog tracer's path through the
    world at 64 steps (65 samples, as the straight bundle: one compile of
    the reference's gather)."""
    jg, m, jb = _world()
    tg = convert.grid_from_numpy(jg, device=CPU)
    tm = convert.field_from_numpy(np.asarray(m), CPU)
    pts = torch.from_numpy(np.array(jb.points))
    tb = trays.RayBundle(points=pts, ds=torch.from_numpy(np.array(jb.ds)))
    if kind == "bent":
        d = pts[:, 1] - pts[:, 0]
        tb, _ = tfermat.trace_rays(tm, tg, pts[:, 0],
                                   d / torch.linalg.norm(d, dim=-1,
                                                         keepdim=True),
                                   150e6, 900.0, n_steps=64, keep_path=True,
                                   method="leapfrog")
        jb = jrays.RayBundle(points=jnp.asarray(tb.points.numpy()),
                             ds=jnp.asarray(tb.ds.numpy()))
    return (jg, m, jb), (tg, tm, tb)


def test_dipole_matches_the_reference_and_its_physics():
    m = tgeo.dipole_moment_ecef()
    np.testing.assert_array_equal(m, jgeo.dipole_moment_ecef())
    n_pole = -m / np.linalg.norm(m)
    b_eq_dir = np.cross(n_pole, [0.0, 0.0, 1.0])
    b_eq_dir /= np.linalg.norm(b_eq_dir)
    r_e = 6371.0
    pts = np.stack([r_e * n_pole, r_e * b_eq_dir, 2 * r_e * n_pole])
    got = tgeo.dipole_b_ecef(pts, m, device=CPU).numpy()
    want = np.asarray(jgeo.dipole_b_ecef(pts, m))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    b_pole, b_eq, b_far = got
    assert abs(np.linalg.norm(b_eq) - 3.07e-5) < 0.1e-5
    assert abs(np.linalg.norm(b_pole) - 2 * np.linalg.norm(b_eq)) < 2e-7
    assert np.dot(b_pole, n_pole) < 0
    np.testing.assert_allclose(np.linalg.norm(b_far),
                               np.linalg.norm(b_pole) / 8.0, rtol=1e-5)
    # the ENU closure on a seeded cloud of points up to 1,100 km high
    rng = np.random.default_rng(0)
    enu = np.concatenate([rng.uniform(-400, 400, (200, 2)),
                          rng.uniform(0, 1100, (200, 1))], -1
                         ).astype(np.float32)
    jfn, tfn = _b_fns()
    assert isinstance(tfn, torch.nn.Module)
    assert all(b.dtype == torch.float32 and b.device.type == CPU
               for b in tfn.buffers())
    got = tfn(torch.from_numpy(enu)).numpy()
    want = np.asarray(jfn(jnp.asarray(enu)))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["straight", "bent"])
def test_tangents_match_the_reference(kind):
    (_, _, jb), (_, _, tb) = _bundles(kind)
    got = trm._tangents(tb.points).numpy()
    np.testing.assert_allclose(got, np.asarray(jrm._tangents(jb.points)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    if kind == "straight":
        assert np.abs(got - got[:, :1]).max() < 1e-5


@pytest.mark.parametrize("kind", ["straight", "bent"])
def test_rotation_measure_and_drm_match_the_reference(kind):
    (jg, m, jb), (tg, tm, tb) = _bundles(kind)
    jfn, tfn = _b_fns()

    def reference(points, ds):      # one jit (its eager ops compile singly)
        b = jrays.RayBundle(points=points, ds=ds)
        return (jrm.rotation_measure(m, jg, b, jfn),
                jrm.drm(m, jg, b, jfn, num_directions=3, i0=1))

    want, d_want = map(np.asarray, jax.jit(reference)(jb.points, jb.ds))
    got = trm.rotation_measure(tm, tg, tb, tfn).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert (got > 0).all() and (0.3 < got).all() and (got < 12.0).all()
    d_got = trm.drm(tm, tg, tb, tfn, num_directions=3, i0=1).numpy()
    assert d_got.shape == (3, 3)
    np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(d_got[1], 0.0)


def test_uniform_field_rm_matches_tec_product():
    """With B uniform and along each ray, RM = K_RM·B·TEC_SI (the same
    Simpson quadrature): the unit and constant chain."""
    _, (tg, tm, tb) = _bundles("straight")
    b0 = 4.2e-5
    tangents = trm._tangents(tb.points)

    def b_fn(pts):
        return -b0 * tangents.reshape(-1, 3)

    got = trm.rotation_measure(tm, tg, tb, b_fn).numpy()
    tec_si = ttec.tec(tm, tg, tb).numpy() * constants.TEC_SCALE
    np.testing.assert_allclose(got, trm.K_RM * b0 * tec_si, rtol=1e-5)


def test_rm_gathers_on_cubic_under_a_zp_prediction():
    """``predict(interp="zp", rm=True)``: the dTEC on zp, the dRM gathered
    on cubic over the same bundle (and not on zp), as the reference."""
    dp, truth = tsynth.generate_example_datapack(
        n_antennas=5, n_directions=3, n_times=1, grid_shape=(12, 12, 12),
        n_samples=17, device=CPU)
    sol = Solution(truth["grid"], truth["m"])
    got = tcli.predict(dp, sol, samples=17, interp="zp", rm=True,
                       device=CPU)
    arrays = dp.to_device_arrays()
    m = torch.from_numpy(truth["m"][0])
    rb = tcli.predict_rays(m, truth["grid"],
                           torch.from_numpy(arrays["antennas_enu"]),
                           torch.from_numpy(arrays["directions_enu"][0]),
                           dp.frequency_hz, samples=17)
    b_fn = tgeo.dipole_b_enu_fn(dp.array.enu_frame, device=CPU)

    def drm_on(interp):
        pts = rb.points.reshape(-1, 3)
        ne = constants.K_NE * torch.exp(ttec._interp_fast(
            m, truth["grid"], pts, interp)).reshape(rb.points.shape[:2])
        b_par = -torch.sum(b_fn(pts).reshape(rb.points.shape)
                           * trm._tangents(rb.points), -1)
        w = trays.simpson_weights(rb.points.shape[1])
        rm = trm.K_RM * (torch.einsum("rn,n->r", ne * b_par, w) * rb.ds
                         * constants.KM_TO_M)
        rm = rm.reshape(-1, 3)
        return (rm - rm[0][None]).numpy()

    cubic, zp = drm_on("cubic"), drm_on("zp")
    np.testing.assert_array_equal(got.drm[:, 0], cubic)
    assert np.abs(zp - cubic).max() > 1e-3 * np.abs(cubic).max()
    np.testing.assert_array_equal(
        got.dtec[:, 0], ttec.dtec_paired_q(m, truth["grid"], rb, 3, 0,
                                           "hermite", "zp").numpy())
