"""Parity of the port's bent-ray tracer on the tricubic field model (the
default ``interp``; the plain PyTorch version of kernel K1c on the CPU)
with the JAX package's ``trace_rays`` on the same numpy-seeded world and
rays, with the tolerances ``test_torch_fermat.py`` holds the zp tracer
to. The world is that file's 20³ Chapman grid plus a smooth horizontal
perturbation; 96 rays, 32 steps.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu_torch import constants, convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import fermat as tfermat

from tests.test_torch_fermat import perturbed_world, ray_fan

torch.set_num_threads(2)


def _both(freq, method, keep_path, n_rays=96, n_steps=32, **interp):
    """Both tracers on the same inputs; ``interp`` empty: the default."""
    jg, m = perturbed_world()
    o, d = ray_fan(n_rays)
    jb, jt = jfermat.trace_rays(jnp.asarray(m), jg, jnp.asarray(o),
                                jnp.asarray(d), freq, 1000.0,
                                n_steps=n_steps, keep_path=keep_path,
                                method=method, **interp)
    tg = convert.grid_from_numpy(jg, device="cpu")
    tb, tt = tfermat.trace_rays(torch.from_numpy(m), tg, torch.from_numpy(o),
                                torch.from_numpy(d), freq, 1000.0,
                                n_steps=n_steps, keep_path=keep_path,
                                method=method, **interp)
    return (np.asarray(jb.points), np.asarray(jb.ds), np.asarray(jt),
            tb.points.numpy(), tb.ds.numpy(), tt.numpy(), (m, tg, tb))


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_rays_cubic_matches_jax(method, keep_path):
    """150 MHz, no ``interp`` named (cubic). Tolerance: path samples 5e-4
    km and TEC 2e-6 relative, as on zp."""
    jp, jds, jt, tp, tds, tt, _ = _both(150e6, method, keep_path)
    assert tp.shape == jp.shape == (96, 33 if keep_path else 2, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(tds, jds)
    np.testing.assert_allclose(tt, jt, rtol=2e-6)


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
def test_trace_rays_cubic_over_dense_clip_matches_jax(method):
    """8 MHz: rays reflect and the near-vertical ones reach the over-dense
    clip, where ∇n is zeroed. 5e-2 km on the path and 2e-5 relative on the
    TEC, as on zp."""
    jp, _, jt, tp, _, tt, (m, tg, tb) = _both(8e6, method, True,
                                              interp="cubic")
    w = constants.KAPPA / 8e6 ** 2
    ne = ttec.ne_at(torch.from_numpy(m), tg, tb.points).numpy()
    assert np.any(1.0 - w * ne <= 1e-6), "clip must fire in this case"
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-2)
    np.testing.assert_allclose(tt, jt, rtol=2e-5)


def test_cubic_and_zp_traces_differ_but_agree_physically():
    """The two field models are different interpolants of the same
    samples: their traces are not equal, and agree to the models' own
    gap (endpoints 0.5 km, TEC 3e-2 relative on this coarse 20³ world)."""
    _, _, _, cp, _, ct, _ = _both(150e6, "leapfrog", False)
    _, _, _, zp, _, zt, _ = _both(150e6, "leapfrog", False, interp="zp")
    assert not np.array_equal(cp, zp)
    np.testing.assert_allclose(cp, zp, rtol=0, atol=0.5)
    np.testing.assert_allclose(ct, zt, rtol=3e-2)


def test_trace_rays_ref_is_the_cpu_path_on_cubic():
    jg, m = perturbed_world()
    tg = convert.grid_from_numpy(jg, device="cpu")
    o, d = (torch.from_numpy(a) for a in ray_fan(16))
    args = (torch.from_numpy(m), tg, o, d, 150e6, 1000.0)
    kw = dict(n_steps=8, keep_path=True, method="leapfrog")
    b1, t1 = tfermat.trace_rays(*args, **kw)
    b2, t2 = tfermat.trace_rays_ref(*args, **kw)
    assert torch.equal(b1.points, b2.points) and torch.equal(t1, t2)


def test_field_evaluator_cubic_matches_jax():
    """(m, ∇m) of the default evaluator at points in and around the grid:
    1e-5·max|m|, over the smallest spacing for the gradient."""
    jg, m = perturbed_world()
    tg = convert.grid_from_numpy(jg, device="cpu")
    pts = np.random.default_rng(41).uniform(
        (-450, -450, -50), (450, 450, 1150), (500, 3)).astype(np.float32)
    jv, jgr = jfermat.field_evaluator(jnp.asarray(m), jg)(jnp.asarray(pts))
    tv, tgr = tfermat.field_evaluator(torch.from_numpy(m), tg)(
        torch.from_numpy(pts))
    tol = 1e-5 * np.abs(m).max()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / float(tg.spacing.min()))


def test_straight_line_limit_error_matches_jax():
    """Endpoint deviation from the straight path (rk4, cubic): within 5e-4
    km of the reference's at 150 MHz and 1 GHz, and ~(0.15)² as large at
    the higher frequency (bending goes as 1/f²)."""
    jg, m = perturbed_world()
    o, d = ray_fan(24)
    tg = convert.grid_from_numpy(jg, device="cpu")
    got = {}
    for freq in (150e6, 1e9):
        want = np.asarray(jfermat.straight_line_limit_error(
            jnp.asarray(m), jg, jnp.asarray(o), jnp.asarray(d), freq, 1000.0,
            n_steps=16))
        got[freq] = tfermat.straight_line_limit_error(
            torch.from_numpy(m), tg, torch.from_numpy(o),
            torch.from_numpy(d), freq, 1000.0, n_steps=16).numpy()
        assert got[freq].shape == (24,)
        np.testing.assert_allclose(got[freq], want, rtol=0, atol=5e-4)
    assert got[1e9].max() < 0.05 * got[150e6].max()
