"""Parity of the port's bent-ray tracer (ionotomo_tpu_torch.geometry.
fermat, the plain PyTorch version of kernel K1 on the CPU) with the JAX
package's ``trace_rays`` on the same numpy-seeded world and rays.

The world is a 20³ Chapman grid plus a smooth horizontal perturbation, so
the xy weights and gradients matter; 96 rays, 32 steps, zp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import constants, convert
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import fermat as tfermat

torch.set_num_threads(2)


def perturbed_world(n=20, seed=0, amp=0.2):
    """JAX grid + log-density m: Chapman plus three sinusoidal modes."""
    jg = JGrid.from_bounds((-400, -400, 0.0), (400, 400, 1100.0), (n, n, n))
    m = np.array(jchapman.log_parametrize(jchapman.chapman_field(jg)))
    pts = jg.meshgrid()
    rng = np.random.default_rng(seed)
    for _ in range(3):
        k = rng.uniform(-1, 1, 3) * 2 * np.pi / np.array([300., 300., 400.])
        m += amp * np.sin(pts @ k + rng.uniform(0, 2 * np.pi))
    return jg, m.astype(np.float32)


def ray_fan(n, seed=1, spread_km=150.0):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-spread_km, spread_km, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.6, n)
    az = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return o, d


def _both(freq, method, keep_path, n_rays=96, n_steps=32):
    jg, m = perturbed_world()
    o, d = ray_fan(n_rays)
    jb, jt = jfermat.trace_rays(jnp.asarray(m), jg, jnp.asarray(o),
                                jnp.asarray(d), freq, 1000.0,
                                n_steps=n_steps, keep_path=keep_path,
                                method=method, interp="zp")
    tg = convert.grid_from_numpy(jg, device="cpu")
    tb, tt = tfermat.trace_rays(torch.from_numpy(m), tg, torch.from_numpy(o),
                                torch.from_numpy(d), freq, 1000.0,
                                n_steps=n_steps, keep_path=keep_path,
                                method=method, interp="zp")
    return (np.asarray(jb.points), np.asarray(jb.ds), np.asarray(jt),
            tb.points.numpy(), tb.ds.numpy(), tt.numpy(), (m, tg, tb))


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("keep_path", [True, False])
def test_trace_rays_matches_jax(method, keep_path):
    """150 MHz. Tolerance: path samples 5e-4 km (measured 1.2e-4, two f32
    ulps at 1000 km) and TEC 2e-6 relative (measured 3.6e-7): the two
    packages round exp, sqrt and the dots differently, and 32 steps
    carry it on."""
    jp, jds, jt, tp, tds, tt, _ = _both(150e6, method, keep_path)
    assert tp.shape == jp.shape == (96, 33 if keep_path else 2, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(tds, jds)
    np.testing.assert_allclose(tt, jt, rtol=2e-6)


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
def test_trace_rays_over_dense_clip_matches_jax(method):
    """8 MHz: most rays are reflected and the near-vertical ones reach
    the over-dense clip (1 − w·n_e ≤ 1e-6), where ∇n is zeroed. Around
    the turning points last-bit differences are amplified, so the bound is
    wider: 5e-2 km on the path (measured 1.1e-2) and 2e-5 relative on the
    TEC (measured 3.5e-6)."""
    jp, _, jt, tp, _, tt, (m, tg, tb) = _both(8e6, method, True)
    w = constants.KAPPA / 8e6 ** 2
    ne = ttec.ne_at(torch.from_numpy(m), tg, tb.points, "zp").numpy()
    assert np.any(1.0 - w * ne <= 1e-6), "clip must fire in this case"
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-2)
    np.testing.assert_allclose(tt, jt, rtol=2e-5)


def test_trace_rays_ref_is_the_cpu_path():
    jg, m = perturbed_world()
    tg = convert.grid_from_numpy(jg, device="cpu")
    o, d = (torch.from_numpy(a) for a in ray_fan(16))
    args = (torch.from_numpy(m), tg, o, d, 150e6, 1000.0)
    kw = dict(n_steps=8, keep_path=True, method="leapfrog", interp="zp")
    b1, t1 = tfermat.trace_rays(*args, **kw)
    b2, t2 = tfermat.trace_rays_ref(*args, **kw)
    assert torch.equal(b1.points, b2.points) and torch.equal(t1, t2)


@pytest.mark.parametrize("f", [150e6, 60e6, 8e6])
def test_step_constants_round_as_the_plain_path_does(f):
    """K1 receives w, h·h/12 and the TEC unit as host floats; they must be
    the f32 values the plain version computes with tensors. The two values
    of w differ in the last bit at 60 and 8 MHz."""
    length, n = 1000.0, 64
    c = tfermat._step_constants(f, length, n)
    h = torch.tensor(c["h"], dtype=torch.float32)
    inv_f2 = torch.tensor(np.float32(1.0 / (f * f)))
    assert (constants.KAPPA * inv_f2).item() == c["w_rhs"]
    assert (h * h / 12.0).item() == c["hh12"]
    assert c["h"] == float(np.float32(length / n))
    ne = torch.tensor([3.3e11, 9.9e11], dtype=torch.float32)
    w = constants.KAPPA / (f * f)
    np.testing.assert_array_equal((w * ne).numpy(),
                                  (np.float32(c["w_n"]) * ne.numpy()))
    tau = torch.tensor([1.5e12], dtype=torch.float32)
    assert (tau * (constants.KM_TO_M / constants.TEC_SCALE)).item() == \
        float(np.float32(1.5e12) * np.float32(c["tec_unit"]))


def test_refractive_index_matches_jax():
    ne = np.array([0.0, 1e11, 1e12, 3e12, 1e13], np.float32)
    for f in (150e6, 8e6):
        want = np.asarray(jfermat.refractive_index(jnp.asarray(ne), f))
        got = tfermat.refractive_index(torch.from_numpy(ne), f).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("interp", ["quadratic", "zpc", "zpc2", "zpc3"])
def test_unported_field_models_raise(interp):
    """The field models that raised before they were ported (the name is
    kept from then): ``trace_rays`` on the CPU, rk4 and leapfrog, against
    the JAX package's on a 12³ world, 24 rays, 12 steps, 150 MHz, within
    ``test_trace_rays_matches_jax``'s bounds (5e-4 km, 2e-6 relative
    TEC)."""
    jg, m = perturbed_world(n=12)
    tg = convert.grid_from_numpy(jg, device="cpu")
    o, d = ray_fan(24)
    for method in ("rk4", "leapfrog"):
        kw = dict(n_steps=12, keep_path=True, method=method, interp=interp)
        jb, jt = jfermat.trace_rays(jnp.asarray(m), jg, jnp.asarray(o),
                                    jnp.asarray(d), 150e6, 1000.0, **kw)
        tb, tt = tfermat.trace_rays(torch.from_numpy(m), tg,
                                    torch.from_numpy(o), torch.from_numpy(d),
                                    150e6, 1000.0, **kw)
        np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                                   rtol=0, atol=5e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-6)


@pytest.mark.parametrize("interp", ["zp", "cubic", "zpc3", "quadratic"])
def test_cuda_leapfrog_runs_the_models_own_kernel(interp, monkeypatch):
    """On the card, leapfrog runs one kernel, the field model's: K1 on zp,
    K1c on cubic, K1z on zpc, K1q on quadratic (each reads its model's
    table). The entry points are replaced by recorders, so this runs on
    the CPU."""
    from ionotomo_tpu_torch import kernels
    from ionotomo_tpu_torch.core.field_models import field_model

    called = []
    names = ("trace_leapfrog_zp", "trace_leapfrog_cubic",
             "trace_leapfrog_zpc", "trace_leapfrog_quad")
    for name in names:
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: called.append(_n))
    tfermat._leapfrog_kernel(field_model(interp))()
    want = {"zp": "trace_leapfrog_zp", "cubic": "trace_leapfrog_cubic",
            "zpc3": "trace_leapfrog_zpc", "quadratic": "trace_leapfrog_quad"}
    assert called == [want[interp]]
