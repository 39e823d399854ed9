"""The port's host layer against the JAX package on the CPU: coordinate
frames, ``RadioArray``, ``DataPack`` (with ``select``, ``concat_times``
and the phase views), the HDF5 and h5parm files (each written by one
package and read by the other), ``EngineConfig``'s JSON, ``Solution`` and
``utils.checkpoint`` round trips, and ``chapman.terminator_cos_chi``.

These modules are float64 numpy in both packages (the port's copies), so
everything is held bit for bit: ``assert_array_equal``, no tolerance.
"""
import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu import config as jconfig
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.data import datapack as jdp, h5parm as jh5, \
    radio_array as jra
from ionotomo_tpu.geometry import frames as jfr
from ionotomo_tpu.inversion.solution import Solution as JSolution
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu.utils import checkpoint as jckpt
from ionotomo_tpu_torch import config as tconfig, convert
from ionotomo_tpu_torch.data import datapack as tdp, h5parm as th5, \
    radio_array as tra
from ionotomo_tpu_torch.geometry import frames as tfr
from ionotomo_tpu_torch.inversion.solution import Solution as TSolution
from ionotomo_tpu_torch.models import chapman as tchapman
from ionotomo_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

MJD = 58000.45


def same(a, b):
    """Equal arrays (or tuples of them), bit for bit."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _frame(mod):
    return mod.ENUFrame(mod.geodetic_to_ecef(np.deg2rad(52.9),
                                             np.deg2rad(6.87), 0.01))


def _frames_cases():
    rng = np.random.default_rng(11)
    lat = rng.uniform(-1.4, 1.4, 7)
    lon = rng.uniform(-3.1, 3.1, 7)
    mjd = 51544.5 + rng.uniform(0, 12000, 5)
    ra, dec = rng.uniform(0, 6.2, (3, 1)), rng.uniform(-1.2, 1.4, (3, 1))
    vec = rng.normal(size=(9, 3))
    xy = rng.uniform(-500, 500, (2, 6, 1)), rng.uniform(-500, 500, (2, 1, 5))
    return {
        "geodetic_to_ecef": lambda m: m.geodetic_to_ecef(lat, lon, 0.3),
        "ecef_to_geodetic": lambda m: m.ecef_to_geodetic(
            m.geodetic_to_ecef(lat, lon, 1.5).T),
        "earth_curvature_radii": lambda m: m.earth_curvature_radii(lat),
        "gaussian_earth_radius": lambda m: m.gaussian_earth_radius(lat[2]),
        "enu_rotation": lambda m: m.enu_rotation(lat[0], lon[0]),
        "ENUFrame": lambda m: (_frame(m).from_ecef(vec * 6e3),
                               _frame(m).to_ecef(vec),
                               _frame(m).direction_from_ecef(vec)),
        "precession_matrix": lambda m: m.precession_matrix(mjd[0]),
        "mean_obliquity_rad": lambda m: m.mean_obliquity_rad(mjd),
        "nutation_angles_rad": lambda m: m.nutation_angles_rad(mjd[1]),
        "nutation_matrix": lambda m: m.nutation_matrix(mjd[2]),
        "icrs_to_true_of_date": lambda m: m.icrs_to_true_of_date(
            vec, mjd[3]),
        "equation_of_equinoxes_rad": lambda m: m.equation_of_equinoxes_rad(
            mjd),
        "gmst_rad": lambda m: m.gmst_rad(mjd),
        "icrs_to_enu": lambda m: (
            m.icrs_to_enu(ra, dec, mjd[None, :3], _frame(m)),
            m.icrs_to_enu(ra, dec, mjd[None, :3], _frame(m),
                          apply_precession_nutation=False)),
        "enu_to_uvw": lambda m: m.enu_to_uvw(vec, mjd[0], 1.2, 0.8,
                                             _frame(m)),
        "solar_radec": lambda m: m.solar_radec(mjd),
        "solar_cos_zenith": lambda m: m.solar_cos_zenith(mjd, _frame(m)),
        "solar_cos_zenith_field": lambda m: m.solar_cos_zenith_field(
            mjd[0], _frame(m), xy[0], xy[1]),
        "enu_to_altaz": lambda m: m.enu_to_altaz(vec),
    }


FRAMES = _frames_cases()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_bitwise(name):
    """Every public function of ``geometry.frames`` on the same float64
    inputs gives the reference's arrays bit for bit."""
    fn = FRAMES[name]
    want, got = fn(jfr), fn(tfr)
    same(want if isinstance(want, tuple) else (want,),
         got if isinstance(got, tuple) else (got,))


def test_radio_array_bitwise(tmp_path):
    """The LOFAR-like layout, its ENU frame, a subset and a config file
    written by one package and read by the other."""
    j = jra.generate_lofar_like_array(n_core=7, n_remote=9, seed=3)
    t = tra.generate_lofar_like_array(n_core=7, n_remote=9, seed=3)
    same((j.itrs, j.enu, j.center), (t.itrs, t.enu, t.center))
    assert j.labels == t.labels and j.name == t.name
    sj, st = j.subset([4, 1, 9]), t.subset([4, 1, 9])
    same(sj.enu, st.enu)
    j.save_config(tmp_path / "a.txt")
    back = tra.RadioArray.load_config(str(tmp_path / "a.txt"))
    same(back.itrs, jra.RadioArray.load_config(str(tmp_path / "a.txt")).itrs)


def _packs(nt=3, seed=0, frame_model="iau2006"):
    """The same DataPack in both packages: (jax's, the port's)."""
    rng = np.random.default_rng(seed)
    out = []
    for ra, dp in ((jra, jdp), (tra, tdp)):
        arr = ra.generate_lofar_like_array(n_core=3, n_remote=4, seed=seed)
        rng = np.random.default_rng(seed)
        na, nd = len(arr), 5
        dirs = np.stack([rng.uniform(1.0, 1.2, nd),
                         rng.uniform(0.8, 1.0, nd)], -1)
        times = MJD + np.arange(nt) * 30.0 / 86400.0
        dtec = rng.normal(scale=40.0, size=(na, nt, nd))
        flags = rng.uniform(size=(na, nt, nd)) < 0.1
        noise = rng.uniform(0.5, 2.0, size=(na, nt, nd))
        out.append(dp.DataPack(arr, dirs, times, dtec, flags, noise,
                               ref_antenna=2, frequency_hz=140e6,
                               frame_model=frame_model))
    return out


def _same_pack(j, t):
    same((j.dtec, j.flags, j.noise_std, j.times, j.directions),
         (t.dtec, t.flags, t.noise_std, t.times, t.directions))
    same(j.array.itrs, t.array.itrs)
    assert (j.ref_antenna, j.frequency_hz, j.frame_model, j.array.labels) \
        == (t.ref_antenna, t.frequency_hz, t.frame_model, t.array.labels)


@pytest.mark.parametrize("frame_model", ["iau2006", "gmst"])
def test_datapack_geometry_and_device_arrays_bitwise(frame_model):
    j, t = _packs(frame_model=frame_model)
    same(j.directions_enu(), t.directions_enu())
    same(j.antennas_enu(), t.antennas_enu())
    ja, ta = j.to_device_arrays(), t.to_device_arrays()
    assert sorted(ja) == sorted(ta)
    for k in ja:
        same(ja[k], ta[k])
    same(j.phase(), t.phase())


@pytest.mark.parametrize("sel", [dict(antennas=[0, 3, 5]),
                                 dict(antennas=[2, 4]),
                                 dict(times=[2, 0]),
                                 dict(directions=[4, 1]),
                                 dict(antennas=[6, 1], times=[1],
                                      directions=[0, 2])])
def test_datapack_select_bitwise(sel):
    """``select`` on every axis, with the reference antenna kept (remapped)
    and dropped (re-referenced: dtec, noise and flags)."""
    j, t = _packs()
    _same_pack(j.select(**sel), t.select(**sel))


def test_datapack_concat_and_phase_constructors_bitwise():
    j, t = _packs(nt=4)
    pieces = [(j.select(times=[0, 1]), j.select(times=[2, 3])),
              (t.select(times=[0, 1]), t.select(times=[2, 3]))]
    _same_pack(jdp.DataPack.concat_times(pieces[0]),
               tdp.DataPack.concat_times(pieces[1]))
    rng = np.random.default_rng(5)
    phase = rng.uniform(-3, 3, (3,) + j.shape)
    freqs = np.array([120e6, 140e6, 160e6])
    _same_pack(
        jdp.DataPack.from_multifrequency_phase(
            j.array, j.directions, j.times, phase, freqs,
            phase_noise_rad=0.1),
        tdp.DataPack.from_multifrequency_phase(
            t.array, t.directions, t.times, phase, freqs,
            phase_noise_rad=0.1))
    _same_pack(jdp.DataPack.from_phase(j.array, j.directions, j.times,
                                       phase[0], 150e6),
               tdp.DataPack.from_phase(t.array, t.directions, t.times,
                                       phase[0], 150e6))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_datapack_hdf5_read_by_the_other_package(tmp_path, writer):
    j, t = _packs()
    path = tmp_path / "dp.h5"
    (j if writer == "jax" else t).save(path)
    reader = tdp.DataPack if writer == "jax" else jdp.DataPack
    _same_pack(j, reader.load(path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_h5parm_read_by_the_other_package(tmp_path, writer):
    j, t = _packs()
    path = tmp_path / "sol.h5"
    (jh5 if writer == "jax" else th5).save_h5parm(j if writer == "jax"
                                                  else t, path)
    want = jh5.load_h5parm(path, ref_antenna=2)
    got = th5.load_h5parm(path, ref_antenna=2)
    _same_pack(want, got)
    _same_pack(jdp.DataPack.from_h5parm(path), tdp.DataPack.from_h5parm(path))


def _configs(mod):
    return [mod.EngineConfig(),
            mod.EngineConfig(
                grid=mod.GridConfig(shape=(14, 12, 10), pad_km=40.0),
                rays=mod.RayConfig(n_samples=17, interp="zp",
                                   beam_noise=4),
                prior=mod.PriorConfig(kind="sqexp",
                                      length_scale_km=(90.0, 80.0, 40.0)),
                solver=mod.SolverConfig(solver="enkf", cg_iters=8,
                                        adapt_r=0.3,
                                        diag_spectrum_every=2),
                physics=mod.PhysicsConfig(time_varying_clim=True))]


@pytest.mark.parametrize("which", [0, 1])
def test_engine_config_json_equal(which):
    """One configuration gives the same JSON in both packages, and the
    JSON of either package reads back, in the other, to a configuration
    equal to the one that package reads from it (JSON turns tuples into
    lists in both) with the same JSON."""
    j, t = _configs(jconfig)[which], _configs(tconfig)[which]
    assert j.to_json() == t.to_json()
    tj = tconfig.EngineConfig.from_json(j.to_json())
    jt = jconfig.EngineConfig.from_json(t.to_json())
    assert tj == tconfig.EngineConfig.from_json(t.to_json())
    assert dataclasses.asdict(tj) == dataclasses.asdict(jt)
    assert tj.to_json() == jt.to_json() == t.to_json()
    assert json.loads(t.to_json()) == json.loads(
        json.dumps(dataclasses.asdict(t)))


def test_solution_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    m = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    std = rng.uniform(size=(2, 4, 5, 6)).astype(np.float32)
    origin, spacing = np.array([-10.0, -20.0, 0.0]), np.array([5.0, 4.0, 3.0])
    tgrid = convert.grid_from_numpy(origin, spacing, (4, 5, 6), device="cpu")
    tsol = TSolution(tgrid, torch.from_numpy(m), dict(std=std), "{}")
    tsol.save(tmp_path / "t.h5")
    jsol = JSolution(JGrid.create(origin, spacing, (4, 5, 6)), m,
                     dict(std=std), "{}")
    jsol.save(tmp_path / "j.h5")
    for path in ("t.h5", "j.h5"):
        a = JSolution.load(tmp_path / path)
        b = TSolution.load(tmp_path / path, device="cpu")
        same((a.m, a.diagnostics["std"]), (b.m, b.diagnostics["std"]))
        same(np.asarray(a.grid.origin), b.grid.origin.numpy())
        assert a.grid.shape == b.grid.shape and b.num_times == 2
        assert a.config_json == b.config_json == "{}"
        same(a.ne(1), b.ne(1))


def test_checkpoint_round_trip_across_packages(tmp_path):
    """Atomic npz checkpoints: written by either package, read by both;
    ``resume`` takes the newest readable one."""
    rng = np.random.default_rng(4)
    state = dict(m=rng.normal(size=(3, 4)).astype(np.float32),
                 t=np.int64(7), wind=np.array([0.1, 0.2, 0.0]))
    tckpt.save_checkpoint(tmp_path, 3, state, '{"a": 1}')
    jckpt.save_checkpoint(tmp_path, 5, state, '{"a": 2}')
    assert [p.split("/")[-1] for p in tckpt.checkpoint_paths(tmp_path)] \
        == ["ckpt_00000003.npz", "ckpt_00000005.npz"]
    for mod in (jckpt, tckpt):
        step, got, cfg = mod.resume(tmp_path)
        assert (step, cfg) == (5, '{"a": 2}')
        for k in state:
            same(state[k], got[k])
    (tmp_path / "ckpt_00000009.npz").write_bytes(b"truncated")
    assert tckpt.resume(tmp_path)[0] == 5
    path = tckpt.save_checkpoint(tmp_path, 1, state, name="state.npz")
    assert path.endswith("state.npz")
    assert jckpt.load_checkpoint(path)[0] == 1


@pytest.mark.parametrize("mjd", [MJD, MJD + 0.37])
def test_terminator_cos_chi_bitwise(mjd):
    """The per-column solar-zenith map over the grid's float32 axes."""
    origin, spacing = np.array([-600.0, -500.0, 0.0]), np.array([70., 60., 9.])
    jg = JGrid.create(origin, spacing, (12, 14, 5))
    tg = convert.grid_from_numpy(origin, spacing, (12, 14, 5), device="cpu")
    want = np.asarray(jchapman.terminator_cos_chi(jg, _frame(jfr), mjd))
    got = tchapman.terminator_cos_chi(tg, _frame(tfr), mjd)
    assert got.shape == (12, 14, 1) and got.dtype == torch.float32
    same(want, got.numpy())
    ne_j = jchapman.chapman_field(jg, cos_chi=jnp.asarray(want))
    ne_t = tchapman.chapman_field(tg, cos_chi=got)
    np.testing.assert_allclose(ne_t.numpy(), np.asarray(ne_j), rtol=1e-6)
