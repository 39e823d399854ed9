"""The config-5 harness of the port (``configs.config5``,
``configs.config5_enkf``) at 16³, 4 × 6 rays, 4 epochs in 2 chunks of 2
steps, on the CPU: the metrics ``bench/config5.py`` emits are there and
finite, the filter beats the prior, chunked runs equal one call bitwise,
and the world is the reference's (the same seeds give the same rays, grid,
prior spectrum and Fourier modes; the data agree with the JAX tracer
through the JAX modes to 1e-5 relative)."""
import functools

import numpy as np
import jax.numpy as jnp
import torch

from ionotomo_tpu.geometry import fermat as jfermat, rays as jrays
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu.models.turbulence import (FourierModes as JFourierModes,
                                            analytic_ne_fn as janalytic)
from ionotomo_tpu_torch import configs

torch.set_num_threads(2)

KW = dict(shape=(16, 16, 16), n_ants=4, n_dirs=6, nt=4, n_modes=32,
          trace_steps=32, heldout=(3, 4, 99), device="cpu")


@functools.lru_cache(maxsize=None)
def world():
    return configs.config5_world(**KW)


def test_world_data_match_the_jax_tracer_through_the_jax_modes():
    """Epoch 2's noise-free dTEC: the same seeds through the JAX
    package's closed-form world and callable tracer. 1e-5·max|dTEC|."""
    w = configs.config5_world(**{**KW, "noise_frac": 0.0})
    assert w.d_seq.shape == (4, 4, 6) and w.noise == 0.0
    ants, dirs = configs.make_rays(4, 6)
    jg = jchapman.grid_enclosing_rays(ants, dirs, shape=(16, 16, 16),
                                      h_min_km=0.0)
    np.testing.assert_allclose(w.grid.spacing.numpy(),
                               np.asarray(jg.spacing), rtol=1e-6)
    kmax = float(np.pi / np.max(np.asarray(jg.spacing)))
    modes = JFourierModes(32, 0.25, 120.0, kmax, seed=13)
    o, d = jrays.make_ray_batch(ants, dirs)
    dx = jnp.asarray([0.3, 0.1, 0.0]) * (2 * 30.0)
    tau = np.asarray(jfermat.trace_rays_callable(
        janalytic(modes.shifted(dx), jchapman.background_ne_fn()), o, d,
        150e6, 1000.0, n_steps=32, keep_path=False, method="leapfrog")[1])
    want = tau.reshape(-1, 6) - tau.reshape(-1, 6)[0:1]
    np.testing.assert_allclose(w.d_seq[2].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_config5_metrics_are_finite_and_the_filter_beats_the_prior():
    w = world()
    rec = configs.config5(world=w, warmup=False, chunk=2, cg_iters=5)
    for key in ("value", "timesteps_per_sec", "mean_residual_reduction",
                "covered_rmse_prior", "covered_rmse_post",
                "heldout_dtec_rms_prior", "heldout_dtec_rms_post", "noise"):
        assert np.isfinite(rec[key]), key
    assert rec["config"] == "config5" and rec["steps"] == 4
    assert rec["metric"] == "kalman_30steps_seconds"
    assert (rec["n_samples"], rec["inner_samples"]) == (65, 33)
    assert rec["mean_residual_reduction"] > 1.5
    assert rec["heldout_dtec_rms_post"] < rec["heldout_dtec_rms_prior"]
    assert rec["covered_rmse_post"] < rec["covered_rmse_prior"]


def test_config5_chunked_equals_one_call_bitwise():
    w = world()
    cache = {}
    a = configs.config5_filter(w, chunk=2, cg_iters=5, geometry_cache=cache)
    b = configs.config5_filter(w, chunk=None, cg_iters=5,
                               geometry_cache=cache)
    # single-step chunks (a time axis of size 1 has no stride 0 to show)
    c = configs.config5_filter(w, chunk=1, cg_iters=5, geometry_cache=cache)
    assert len(cache) == 2               # one geometry per bundle, reused
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert (a[2] < a[1]).all()           # post-update below pre-update


def test_config5_enkf_runs_and_chunks_bitwise():
    w = world()
    rec = configs.config5_enkf(world=w, n_members=3, n_steps=4,
                               warmup=False, cg_iters=5)
    for key in ("value", "residual_first", "residual_last", "spread_mean",
                "heldout_dtec_rms_prior", "heldout_dtec_rms_mean"):
        assert np.isfinite(rec[key]), key
    assert rec["members"] == 3 and rec["spread_mean"] > 0
    assert rec["residual_last"] < rec["residual_first"]
    noise = configs.enkf_noise(w, 3, 4)
    a = configs.config5_enkf_filter(w, noise, 4, chunk=2, cg_iters=5)
    b = configs.config5_enkf_filter(w, noise, 4, cg_iters=5)
    assert len(a) == 2 and len(b) == 1
    assert torch.equal(a[-1].ensemble, b[-1].ensemble)
    assert torch.equal(torch.cat([r.mean_seq for r in a]), b[0].mean_seq)


def test_config5_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No device named: the world goes to the card, and without CUDA that
    raises instead of falling back to the CPU."""
    import pytest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.config5_world(**{**KW, "device": None})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.config5()
