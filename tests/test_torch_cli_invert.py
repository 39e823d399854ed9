"""The port's command line against the reference's: ``simulate`` →
``invert`` (with ``--auto-flag``) → ``info`` through each package's
``main(argv)``, the port's with ``--device cpu``, at 6 antennas × 4
directions × 6 timesteps on 12³ (a spike spoils two of a series' steps:
``flag_outliers`` needs most steps clean).

- ``simulate``: the same arguments, the port fed the reference's
  turbulence white noise (the one draw JAX makes). The DataPack's numpy
  parts (geometry, times, flags, noise, reference antenna, frequency) are
  bitwise the reference's; its dTEC, the port's forward of the same truth,
  within 2e-4·max|dTEC| (PRECISION.md, as ``tests/test_torch_synth_
  ionosonde.py``), and the truth within 1e-5 (1 + |m|).
- ``invert``: both read the reference's DataPack file, with three samples
  spiked for ``--auto-flag``, at gn 2 and cg 4 (``tests/test_torch_
  pipeline.py``: the parity depth of this world). The same outlier count,
  the same metrics lines but for the host timings, each residual within
  1e-3 relative, each field within 1e-2 rms of its error against the
  truth, the Solution file's grid and config (but for its paths) equal.
- ``info``: the same lines on both files.
"""
import functools
import json
import re
from unittest import mock

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ionotomo_tpu import __main__ as jcli
from ionotomo_tpu.data.datapack import DataPack as JDataPack
from ionotomo_tpu_torch import __main__ as tcli
from ionotomo_tpu_torch.data import synth as tsynth

torch.set_num_threads(2)

SIM = ["--antennas", "6", "--directions", "4", "--times", "6", "--grid",
       "12", "--seed", "3", "--turbulence", "0.3"]
INVERT = ["--grid", "12", "--samples", "33", "--gn-iters", "2",
          "--cg-iters", "4", "--prior-kind", "sqexp", "--prior-length",
          "90", "--auto-flag", "6"]
TIMINGS = ("seconds", "rays_per_sec", "iters_per_sec")


def run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def jax_white(shape, seed):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed), tuple(shape), jnp.float32)))


@functools.lru_cache(maxsize=None)
def _files(root):
    return {k: str(root / k) for k in ("j.h5", "t.h5", "jtruth.h5",
                                        "ttruth.h5")}


def simulate_both(tmp_path, capsys):
    f = _files(tmp_path)
    jout = run(jcli.main, ["simulate", "--out", f["j.h5"], "--truth-out",
                           f["jtruth.h5"], *SIM], capsys)
    with mock.patch.object(tsynth, "white_noise", jax_white):
        tout = run(tcli.main, ["simulate", "--out", f["t.h5"],
                               "--truth-out", f["ttruth.h5"], *SIM,
                               "--device", "cpu"], capsys)
    return f, jout, tout


def test_simulate_matches_the_reference(tmp_path, capsys):
    f, jout, tout = simulate_both(tmp_path, capsys)
    assert tout.replace(f["t.h5"], "X").replace(f["ttruth.h5"], "Y") \
        == jout.replace(f["j.h5"], "X").replace(f["jtruth.h5"], "Y")
    with h5py.File(f["j.h5"]) as a, h5py.File(f["t.h5"]) as b:
        assert sorted(a) == sorted(b) and dict(a.attrs) == dict(b.attrs)
        for k in ("antennas/itrs_km", "directions/radec", "times/mjd",
                  "flags", "noise_std"):
            np.testing.assert_array_equal(b[k][:], a[k][:])
        d = a["dtec"][:]
        np.testing.assert_allclose(b["dtec"][:], d, rtol=0,
                                   atol=2e-4 * np.abs(d).max())
    with h5py.File(f["jtruth.h5"]) as a, h5py.File(f["ttruth.h5"]) as b:
        for k in ("grid/origin", "grid/spacing", "grid/shape"):
            np.testing.assert_array_equal(b[k][:], a[k][:])
        m = a["m"][:]
        assert np.all(np.abs(b["m"][:] - m) <= 1e-5 * (1 + np.abs(m)))


def spike(path):
    """Three impulsive outliers in the DataPack file, for --auto-flag."""
    dp = JDataPack.load(path)
    scale = np.abs(dp.dtec).max()
    for i, t, k in ((1, 1, 0), (3, 2, 2), (5, 1, 3)):
        dp.dtec[i, t, k] += 5.0 * scale
    dp.save(path)


def metrics_lines(out):
    """The JSON records the invert command prints, host timings left
    out."""
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("   {")]
    return [{k: v for k, v in r.items() if k not in TIMINGS} for r in recs]


def test_invert_and_info_match_the_reference(tmp_path, capsys):
    f, _, _ = simulate_both(tmp_path, capsys)
    spike(f["j.h5"])
    outs, sols = [], []
    one = jax.devices()[:1]
    for main, side, extra in ((jcli.main, "jax", []),
                              (tcli.main, "port", ["--device", "cpu"])):
        sol = str(tmp_path / f"{side}_sol.h5")
        argv = ["invert", f["j.h5"], "--out", sol, *INVERT,
                "--checkpoint-dir", str(tmp_path / side / "ckpt"),
                "--metrics", str(tmp_path / side / "m.jsonl"), *extra]
        # the reference on one device, as the port runs
        with mock.patch.object(jax, "devices", lambda *a: one):
            outs.append(run(main, argv, capsys))
        sols.append(sol)
    jout, tout = outs
    flagged = [re.findall(r"auto-flagged (\d+) outlier", o) for o in outs]
    assert flagged[0] == flagged[1] and int(flagged[0][0]) >= 3
    jrec, trec = metrics_lines(jout), metrics_lines(tout)
    assert len(trec) == 6
    for a, b in zip(jrec, trec):
        assert {k: v for k, v in a.items() if k != "residual"} \
            == {k: v for k, v in b.items() if k != "residual"}
        assert abs(b["residual"] - a["residual"]) <= 1e-3 * a["residual"]
    with h5py.File(sols[0]) as a, h5py.File(sols[1]) as b:
        ca, cb = (json.loads(x.attrs["config"]) for x in (a, b))
        assert ca.pop("runtime")["seed"] == cb.pop("runtime")["seed"]
        assert ca == cb
        for k in ("grid/origin", "grid/spacing", "grid/shape"):
            np.testing.assert_array_equal(b[k][:], a[k][:])
        ma, mb = a["m"][:], b["m"][:]
    with h5py.File(f["jtruth.h5"]) as tr:
        truth = tr["m"][:]
    for t in range(ma.shape[0]):
        err = np.sqrt(np.mean((ma[t] - truth[t]) ** 2))
        assert np.sqrt(np.mean((mb[t] - ma[t]) ** 2)) <= 1e-2 * err
    for path in (f["j.h5"], sols[0], sols[1]):
        assert run(tcli.main, ["info", path], capsys) \
            == run(jcli.main, ["info", path], capsys)
