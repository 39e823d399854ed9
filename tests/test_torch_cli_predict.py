"""The port's ``predict`` against the reference's through each package's
``main(argv)`` (the port's with ``--device cpu``), on the same files: a
DataPack of 6 antennas × 4 directions × 3 timesteps on 12³ and its truth
as the Solution, both written once by the port's ``simulate`` (a
module-scoped fixture: the two packages' files are interchangeable).

- straight (Hermite@17), ``--rm``, ``--bent --n-steps 16 --rm``,
  ``--interp zp --rm`` and ``--h5parm``: the same printed lines (the two
  rms to two decimals), the ``dtec`` and ``drm`` datasets and the h5parm
  soltab within 1e-4·max|·| of the reference's, the rest of the file
  equal, the reference antenna's dRM row 0;
- a one-timestep Solution broadcast over the 3 timesteps;
- both ``SystemExit`` messages equal: a Solution whose timestep count
  matches neither the DataPack's nor 1, and ``--h5parm`` with ``--rm``
  (raised before anything is written).
"""
import h5py
import numpy as np
import pytest
import torch

from ionotomo_tpu import __main__ as jcli
from ionotomo_tpu_torch import __main__ as tcli
from ionotomo_tpu_torch.inversion.solution import Solution

torch.set_num_threads(2)

SIM = ["--antennas", "6", "--directions", "4", "--times", "3", "--grid",
       "12", "--seed", "4"]
FORMS = {"straight": ["--samples", "17"],
         "rm": ["--samples", "17", "--rm"],
         "bent_rm": ["--bent", "--n-steps", "16", "--rm"],
         "zp_rm": ["--samples", "17", "--interp", "zp", "--rm"],
         "h5parm": ["--samples", "17", "--h5parm"]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(obs.h5, sol.h5: the truth's 3 timesteps, sol1.h5: its first,
    sol2.h5: its first 2)."""
    root = tmp_path_factory.mktemp("predict")
    f = {k: str(root / f"{k}.h5") for k in ("obs", "sol", "sol1", "sol2")}
    tcli.main(["simulate", "--out", f["obs"], "--truth-out", f["sol"], *SIM,
               "--device", "cpu"])
    sol = Solution.load(f["sol"], device="cpu")
    for k, n in (("sol1", 1), ("sol2", 2)):
        Solution(sol.grid, sol.m[:n]).save(f[k])
    return root, f


def run_both(capsys, root, argv, name):
    """Each package's ``predict`` with ``argv`` into its own file: (the
    printed lines, each output path)."""
    outs, paths = [], []
    for main, side, extra in ((jcli.main, "jax", []),
                              (tcli.main, "port", ["--device", "cpu"])):
        out = str(root / f"{name}_{side}.h5")
        main(["predict", *argv, "--out", out, *extra])
        outs.append(capsys.readouterr().out.replace(out, "OUT"))
        paths.append(out)
    return outs, paths


def assert_close(a, b, what):
    scale = np.abs(a).max()
    assert scale > 0, what
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                               err_msg=what)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_predict_matches_the_reference(files, capsys, form):
    root, f = files
    (jout, tout), (jp, tp) = run_both(capsys, root,
                                      [f["sol"], f["obs"], *FORMS[form]],
                                      form)
    assert tout == jout
    with h5py.File(jp) as a, h5py.File(tp) as b:
        assert sorted(a) == sorted(b) and dict(a.attrs) == dict(b.attrs)
        if form == "h5parm":
            ja, tb = a["sol000/tec000"], b["sol000/tec000"]
            assert sorted(ja) == sorted(tb)
            assert_close(ja["val"][:], tb["val"][:], "tec000 val")
            for k in ja:
                if k != "val":
                    np.testing.assert_array_equal(tb[k][:], ja[k][:])
            return
        assert_close(a["dtec"][:], b["dtec"][:], "dtec")
        for k in ("flags", "noise_std", "times/mjd", "directions/radec"):
            np.testing.assert_array_equal(b[k][:], a[k][:])
        if "rm" in form:
            d = b["drm"][:]
            assert_close(a["drm"][:], d, "drm")
            np.testing.assert_array_equal(d[int(b.attrs["ref_antenna"])], 0.0)


def test_one_timestep_solution_broadcasts(files, capsys):
    root, f = files
    (jout, tout), (jp, tp) = run_both(
        capsys, root, [f["sol1"], f["obs"], "--samples", "17", "--rm"],
        "broadcast")
    assert tout == jout
    with h5py.File(jp) as a, h5py.File(tp) as b:
        assert b["dtec"].shape == (6, 3, 4)
        assert_close(a["dtec"][:], b["dtec"][:], "dtec")
        assert_close(a["drm"][:], b["drm"][:], "drm")


@pytest.mark.parametrize("case", ["timesteps", "h5parm_rm"])
def test_system_exits_match_the_reference(files, capsys, case):
    root, f = files
    argv = ([f["sol2"], f["obs"], "--samples", "17"] if case == "timesteps"
            else [f["sol"], f["obs"], "--samples", "17", "--h5parm",
                  "--rm"])
    messages = []
    for main, side, extra in ((jcli.main, "jax", []),
                              (tcli.main, "port", ["--device", "cpu"])):
        out = root / f"exit_{case}_{side}.h5"
        with pytest.raises(SystemExit) as e:
            main(["predict", *argv, "--out", str(out), *extra])
        assert not out.exists()
        messages.append(str(e.value))
    capsys.readouterr()
    assert messages[0] == messages[1]
    assert ("timesteps" in messages[0]) == (case == "timesteps")
