"""The port's examples held to the JAX package's ``examples/*.py``: the
solver workflows (``bent_retrace``, ``uncertainty``,
``profile_estimation``, ``ionosonde_probes``), each JAX example run in a
subprocess on one CPU device and its printed numbers compared with the
port's ``run(..., device="cpu")`` on the same inputs
(``tests/test_torch_examples_pipeline.py`` has the harness and the other
four).

The two profile workflows end in an undamped Gauss-Newton over a joint
(θ, δm) system, whose f32 CG at the examples' depth (cg 40) is decided by
rounding in either package (ROADMAP Queue 3, "f32 Krylov depth"): the
port's own θ̂ and joint rms move when its fed-in data noise moves by
1e-6 relative. So each holds three things: θ̂ and every rms at cg 3
(both examples' solve wrapped to that depth, the only change) within
1e-3 relative; the example's claims in both packages at cg 40; and the
gap at cg 40, within a bound that states its measured value.
"""
import re

import jax
import numpy as np
import torch

from tests.test_torch_examples_pipeline import (NUM, jax_example,
                                                jax_normals, near, numbers,
                                                png, printed)

torch.set_num_threads(2)

PROFILE_SOLVE = "ionotomo_tpu.inversion.profile:map_gauss_newton_profile"


# --- bent_retrace --------------------------------------------------------------

def test_bent_retrace_matches_the_jax_example(tmp_path):
    """30 MHz through the blob, ``--outer 2`` (the example's smaller
    argument): the frozen linearisation's and the prior's rmse over the
    covered voxels, each re-trace iteration's rmse and residual (no keyed
    draw: the observation noise is the example's numpy draw); the
    figure."""
    from ionotomo_tpu_torch.examples import bent_retrace

    out = jax_example("bent_retrace", tmp_path, "--outdir=jax", "--outer=2")
    got = bent_retrace.run(str(tmp_path / "port"), outer=2, device="cpu")
    frozen, prior = numbers(rf"frozen linearisation : rmse ({NUM}) "
                            rf"\(prior ({NUM})\)", out)
    near(got["rmse_prior"], prior, 1e-3, "prior rmse")
    # the frozen solve (gn 2, cg 30 in f32): measured 5.6e-3 relative at
    # --outer 2 (0.07836 against 0.0788 printed), 1.9 % at the default 4
    # (0.06672 against 0.0680)
    near(got["rmse_frozen"], frozen, 1e-2, "frozen rmse")
    for it in range(2):
        e, res = numbers(rf"re-trace iteration {it}: rmse ({NUM}) "
                         rf"\(residual ({NUM})\)", out)
        # each a gn-1, cg-30 f32 solve; measured: rmse 0.07932 against
        # 0.0792 and 0.06755 against 0.0675 printed, residual 25.298
        # against 25.3 and 9.772 against 9.7 printed
        near(got["rmse_retraced"][it], e, 3e-3, f"re-trace {it} rmse")
        near(got["residual_retraced"][it], res, 2e-2, f"re-trace {it} res")
    # the claims: every solve below the prior; re-tracing lowers the rmse
    # and, at --outer 2, reaches below the frozen linearisation (at the
    # default 4 the frozen rmse moves by 2 % under 1e-6 of data, too close
    # to call)
    assert got["rmse_frozen"] < got["rmse_prior"]
    assert max(got["rmse_retraced"]) < got["rmse_prior"]
    assert got["rmse_retraced"][1] < got["rmse_retraced"][0]
    assert min(got["rmse_retraced"]) < got["rmse_frozen"]
    assert png(got["figure"])
    assert png(tmp_path / "jax" / "retrace_vs_frozen.png")


# --- uncertainty -----------------------------------------------------------------

def enkf_draws(key, b, shape, nt, n_rows):
    """The reference ``ensemble_kalman_filter``'s draws from ``key``:
    init (B, *shape), process (nt, B, *shape), obs (nt, B, n_rows)."""
    init = np.stack([np.asarray(jax.random.normal(k, shape)) for k in
                     jax.random.split(jax.random.fold_in(key, 0x7FFFFFFF),
                                      b)])
    process, obs = [], []
    for t in range(nt):
        k_adv, k_obs = jax.random.split(jax.random.fold_in(key, t))
        process.append(np.stack([np.asarray(jax.random.normal(k, shape))
                                 for k in jax.random.split(k_adv, b)]))
        obs.append(np.asarray(jax.random.normal(k_obs, (b, n_rows))))
    return init, np.stack(process), np.stack(obs)


def test_uncertainty_matches_the_jax_example(tmp_path):
    """RTO posterior samples and the inflated EnKF at ``--samples 4
    --members 4``, every draw the reference's (key 1 the data noise, key
    2 split into the posterior's data and prior draws, key 3 the
    filter's): the 2σ coverage and the spread per step; the figure."""
    from ionotomo_tpu_torch.examples import uncertainty as ex

    out = jax_example("uncertainty", tmp_path, "--outdir=jax",
                      "--samples=4", "--members=4")
    shape = (20, 20, 20)
    n_rows = ex.NA * ex.ND
    k1, k2 = jax.random.split(jax.random.key(2))
    init, process, obs = enkf_draws(jax.random.key(3), 4, shape, ex.NT,
                                    n_rows)
    got = ex.run(str(tmp_path / "port"), samples=4, members=4, device="cpu",
                 obs_noise=jax_normals(1, (ex.NA, ex.ND)),
                 data_noise=np.asarray(jax.random.normal(k1, (4, n_rows))),
                 prior_noise=np.asarray(jax.random.normal(k2, (4,) + shape)),
                 enkf_init=init, enkf_process=process, enkf_obs=obs)
    (cover,) = numbers(rf"\|mean-truth\| <= 2 std on ({NUM})% of voxels", out)
    near(100 * got["cover_fraction"], cover, 1e-3, "2-sigma coverage")
    m = re.search(r"EnKF: mean spread per step: \[([^\]]*)\]", out)
    spread = [printed(v.strip()) for v in m.group(1).split(",")]
    assert len(spread) == len(got["enkf_spread"]) == ex.NT
    for t, (g, ref) in enumerate(zip(got["enkf_spread"], spread)):
        near(g, ref, 1e-3, f"spread at step {t}")
    # the claims: the posterior covers the truth; inflation 1.1 and
    # process noise grow the spread every step
    assert got["cover_fraction"] > 0.9
    assert all(b > a for a, b in zip(got["enkf_spread"],
                                     got["enkf_spread"][1:]))
    assert png(got["figure"]) and png(tmp_path / "jax" / "uncertainty.png")


# --- profile_estimation and ionosonde_probes ---------------------------------------

PROFILE_DRAWS = dict(data_noise=(1, (8, 5)), anchor_noise=(2, (15,)))


def profile_inputs(shape, **more):
    """The reference's keyed draws of the profile workflows."""
    draws = dict(PROFILE_DRAWS, white=(4, shape), **more)
    return {k: jax_normals(key, s) for k, (key, s) in draws.items()}


def profile_lines(out):
    """θ̂ and the three profile rms of ``profile_estimation``'s output."""
    theta = numbers(rf"estimated:\s+({NUM})\s+({NUM})\s+({NUM})", out)
    rms = [numbers(rf"{label}:\s+({NUM})", out)[0]
           for label in ("prior profile", "fixed-profile anchored solve",
                         "parametric profile solve")]
    return theta, rms


def test_profile_estimation_matches_the_jax_example(tmp_path):
    """The joint (θ, δm) solve from dTEC and 15 slant anchors on 32³,
    white noise key 4, data noise key 1, anchor noise key 2."""
    from ionotomo_tpu_torch.examples import profile_estimation as ex

    inputs = profile_inputs(ex.SHAPE)
    keys = ("n_peak", "h_peak_km", "scale_km")
    rms_keys = ("rms_prior", "rms_fixed", "rms_parametric")
    # 1. at cg 3 every number within 1e-3 (measured: equal to the printed
    # digits: 1.474e12, 351.3, 76.2; 0.545, 0.533, 0.481)
    out3 = jax_example("profile_estimation", tmp_path / "cg3",
                       depth=f"{PROFILE_SOLVE}=3")
    got3 = ex.run(device="cpu", cg_iters=3, **inputs)
    theta, rms = profile_lines(out3)
    for k, ref in zip(keys, theta):
        near(got3[k], ref, 1e-3, f"{k} at cg 3")
    for k, ref in zip(rms_keys, rms):
        near(got3[k], ref, 1e-3, f"{k} at cg 3")

    # 2. the example at its cg 40
    out = jax_example("profile_estimation", tmp_path / "cg40")
    got = ex.run(device="cpu", **inputs)
    theta, rms = profile_lines(out)
    # the prior's and the fixed-profile solve's rms do not go through the
    # joint solve: within 1e-3 (measured equal to the printed digits)
    near(got["rms_prior"], rms[0], 1e-3, "prior rms")
    near(got["rms_fixed"], rms[1], 1e-3, "fixed-profile rms")
    # the claims in both packages: the parametric solve below the fixed
    # one below the prior's; h_peak moved from the guess's 350 km toward
    # the truth's 380
    for r in (got["rms_parametric"], rms[2][0]):
        assert r < got["rms_fixed"] < got["rms_prior"]
    for h in (got["h_peak_km"], theta[1][0]):
        assert 350.0 < h <= 380.0 + 10.0
    # 3. the gap at cg 40, measured: N_peak 1.7101e12 against 1.706e12
    # (0.24 %), h_peak 363.29 against 363.0 km, H 64.88 against 65.0 km,
    # the parametric rms 0.2684 against 0.271 (1.0 %); the port's own
    # θ̂ moves by 0.08 km and its rms by 0.4 % when its data noise moves
    # by 1e-6 relative
    near(got["n_peak"], theta[0], 1e-2, "N_peak at cg 40")
    near(got["h_peak_km"], theta[1], 3e-3, "h_peak at cg 40")
    near(got["scale_km"], theta[2], 1e-2, "H at cg 40")
    near(got["rms_parametric"], rms[2], 3e-2, "parametric rms at cg 40")


def ionosonde_lines(out):
    """The printed numbers of ``ionosonde_probes``."""
    m = re.search(rf"(\d+) probe rows from 2 sounder stations \(bottomside, "
                  rf"z ({NUM})–({NUM}) km\)", out)
    rows, z = int(m.group(1)), [printed(g) for g in m.groups()[1:]]
    rms = [numbers(rf"{label}:\s+({NUM})", out)[0]
           for label in ("climatological prior", "after probe assimilation",
                         "joint-solve log-profile rms")]
    f2 = numbers(rf"estimated:\s+({NUM})\s+({NUM})\s+({NUM})", out)
    return rows, z, rms, f2


def test_ionosonde_probes_matches_the_jax_example(tmp_path):
    """Two sounders' bottomside soundings of the E/F1/F2 world on 28³
    (sounder noise key 5 beside the profile draws): the probe rows and
    their altitudes, the npz written (into the output directory, where
    the reference writes /tmp/probes.npz: the test redirects the
    reference's), the assimilated rms, the joint solve's F2 and rms."""
    from ionotomo_tpu_torch.examples import ionosonde_probes as ex

    inputs = profile_inputs(ex.SHAPE, probe_noise=(5, (24,)))
    # 1. at cg 3 every number within 1e-3 (measured: 1.412e12, 355.4,
    # 75.2 and 0.225 in both)
    out3 = jax_example("ionosonde_probes", tmp_path / "cg3",
                       depth=f"{PROFILE_SOLVE}=3")
    got3 = ex.run(str(tmp_path / "port3"), device="cpu", cg_iters=3,
                  **inputs)
    rows, z, rms, f2 = ionosonde_lines(out3)
    assert got3["probe_rows"] == rows == 24
    for k, ref in zip(("n_peak", "h_peak_km", "scale_km"), f2):
        near(got3[k], ref, 1e-3, f"{k} at cg 3")
    near(got3["rms_joint"], rms[2], 1e-3, "joint rms at cg 3")

    # 2. the example at its cg 40
    out = jax_example("ionosonde_probes", tmp_path / "cg40")
    got = ex.run(str(tmp_path / "port"), device="cpu", **inputs)
    rows, z, rms, f2 = ionosonde_lines(out)
    assert got["probe_rows"] == rows
    near(got["probe_z_min"], z[0], 1e-3, "lowest probe")
    near(got["probe_z_max"], z[1], 1e-3, "highest probe")
    near(got["rms_prior"], rms[0], 1e-3, "prior rms")
    near(got["rms_assimilated"], rms[1], 1e-3, "assimilated rms")
    with np.load(got["npz"]) as mine, \
            np.load(tmp_path / "cg40" / "probes.npz") as theirs:
        assert set(mine.files) == set(theirs.files)
        for k in theirs.files:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5,
                                       atol=1e-4, err_msg=k)
    # the claims in both packages: the probes lower the prior's error;
    # the joint solve below the assimilated one; F2's h_peak moved from
    # the guess's 350 km toward the truth's 385
    for r_joint in (got["rms_joint"], rms[2][0]):
        assert r_joint < got["rms_assimilated"] < got["rms_prior"]
    for h in (got["h_peak_km"], f2[1][0]):
        assert 375.0 < h < 395.0
    # 3. the gap at cg 40, measured: N_peak 1.5428e12 against 1.553e12
    # (0.66 %), h_peak 381.89 against 381.4 km, H 68.61 against 68.1 km,
    # the joint rms 0.0485 against 0.063 (23 %); the port's own joint
    # rms moves by 7 % (to 0.0450) and its N_peak by 0.35 % when its data
    # noise moves by 1e-6 relative
    near(got["n_peak"], f2[0], 2e-2, "F2 N_peak at cg 40")
    near(got["h_peak_km"], f2[1], 3e-3, "F2 h_peak at cg 40")
    near(got["scale_km"], f2[2], 2e-2, "F2 H at cg 40")
    near(got["rms_joint"], rms[2], 0.35, "joint rms at cg 40")
