"""``inversion.online.OnlineKalman`` of the port against the JAX package on
the CPU, on the world of ``tests/test_torch_kalman.py`` (12³, 6 × 4 rays,
3 epochs, cg 5), and the diagnostics the service logs
(``core.linalg.subspace_eigs``, ``kalman.update_operator_eigs``) with the
reference's start block fed in.

Two JAX streams, each built once for the module: the plain filter, and
the filter with every option at once (mixed fidelity from 25 of the 49
samples, two wind-adaptation iterations from a wrong initial wind, and
adaptive R at α = 0.3 with the reference's ``fold_in(0xADA0, t)`` probes
fed in). Tolerances are ``test_torch_kalman.py``'s for shallow CG: the
state within 1e-2 of the update's L2 size, residuals 1e-3 relative; winds
within 2e-3 km/s and the noise scale within 1e-2 relative. The port's
own contracts are held bit for bit: streamed epochs equal the batch
filter's, and a state carried through ``state_dict`` and an npz file
resumes the stream exactly. A state saved by the JAX stream after epoch
2 (``convert.online_state_from_numpy``) continues in the port as it does
in JAX.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import linalg as jlinalg
from ionotomo_tpu.data import ionosonde as jiono
from ionotomo_tpu.geometry.rays import RayBundle as JBundle
from ionotomo_tpu.inversion import kalman as jkalman
from ionotomo_tpu.inversion.online import OnlineKalman as JOnline
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import linalg as tlinalg
from ionotomo_tpu_torch.data import ionosonde as tiono
from ionotomo_tpu_torch.geometry.rays import RayBundle as TBundle
from ionotomo_tpu_torch.inversion import kalman as tkalman
from ionotomo_tpu_torch.inversion import online as tonline
from ionotomo_tpu_torch.inversion.online import OnlineKalman as TOnline

from tests.test_torch_kalman import NT, l2, world

torch.set_num_threads(2)

CG = 5
WRONG_WIND = np.array([0.25, 0.05, 0.0])
OPTIONS = dict(inner_samples=25, wind_adapt_iters=2, adapt_r=0.3)


def jray(t):
    w, _ = world()
    return JBundle(points=w["rays_seq"].points[t], ds=w["rays_seq"].ds[t])


def tray(t):
    _, p = world()
    return TBundle(p["rays_seq"].points[t], p["rays_seq"].ds[t])


def stats_draws(t):
    """The reference's adaptive-R probes of epoch t (``OnlineKalman``
    keys them ``fold_in(key(0xADA0), t)``; the filter folds in step 0)."""
    w, _ = world()
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0xADA0), t), 0)
    return np.array(jax.random.normal(k, (2,) + w["grid"].shape))


def make(mod_online, pkg, options=False, **kw):
    w, p = world()
    src = w if pkg == "jax" else p
    if options:
        kw = dict(OPTIONS, **kw)
    wind = WRONG_WIND if options else np.asarray(w["wind"])
    return mod_online(src["grid"], src["cov"], src["m_bg"], wind,
                      w["dt_s"], num_directions=w["n_dirs"], cg_iters=CG,
                      fade=0.95, **kw)


def port_step(f, t, options=False):
    _, p = world()
    kw = {}
    if options:
        kw["stats_noise"] = torch.from_numpy(stats_draws(t))
    return f.step(tray(t), p["d_seq"][t], p["noise"], **kw)


@functools.lru_cache(maxsize=None)
def jax_stream(options):
    """The JAX stream's per-epoch fields, diagnostics and its state after
    epoch 2 (cached for the module: one compile per variant)."""
    w, _ = world()
    f = make(JOnline, "jax", options)
    ms, diags, state2 = [], [], None
    for t in range(NT):
        m, diag = f.step(jray(t), w["d_seq"][t], w["noise"])
        ms.append(np.asarray(m))
        diags.append(diag)
        if t == 1:
            state2 = {k: np.array(v) for k, v in f.state_dict().items()}
    return ms, diags, state2


def assert_epoch_close(got, want, t):
    w, _ = world()
    bg = np.asarray(w["m_bg"])
    assert np.isfinite(got).all()
    assert l2(got - want) <= 1e-2 * l2(want - bg), (t, l2(got - want))


@pytest.mark.parametrize("options", [False, True])
def test_online_kalman_matches_jax(options):
    want, jdiags, _ = jax_stream(options)
    f = make(TOnline, "port", options)
    for t in range(NT):
        m, diag = port_step(f, t, options)
        assert_epoch_close(m.numpy(), want[t], t)
        jd = jdiags[t]
        assert sorted(diag) == sorted(jd) and diag["t"] == jd["t"] == t
        for k in ("pre_residual", "post_residual"):
            np.testing.assert_allclose(diag[k], jd[k], rtol=1e-3)
        if options:
            np.testing.assert_allclose(diag["wind_kmps"], jd["wind_kmps"],
                                       rtol=0, atol=2e-3)
            np.testing.assert_allclose(diag["r_scale"], jd["r_scale"],
                                       rtol=1e-2)
    assert f.t == NT
    if options:
        assert f.r_scale != 1.0
        assert np.abs(f.wind - WRONG_WIND).max() > 1e-3


def test_online_kalman_adapt_r_needs_its_draws():
    f = make(TOnline, "port", adapt_r=0.3)
    with pytest.raises(ValueError, match="stats_noise"):
        f.step(tray(0), world()[1]["d_seq"][0], world()[1]["noise"])


@pytest.mark.parametrize("mixed_wind", [False, True])
def test_online_kalman_streams_the_batch_filter_bitwise(mixed_wind):
    """Epoch by epoch equals one batch call over the same epochs, bit for
    bit: plain, and with mixed fidelity and wind adaptation (the carried
    wind included). Adaptive R is left out: the stream's noise scale
    moves between epochs, the batch filter's does not."""
    _, p = world()
    kw = dict(inner_samples=25, wind_adapt_iters=2) if mixed_wind else {}
    wind = WRONG_WIND if mixed_wind else p["wind"]
    f = TOnline(p["grid"], p["cov"], p["m_bg"], wind, p["dt_s"],
                num_directions=p["n_dirs"], cg_iters=CG, fade=0.95, **kw)
    streamed = [port_step(f, t)[0] for t in range(NT)]
    bkw = {}
    if mixed_wind:
        from ionotomo_tpu_torch.geometry.rays import inner_bundle
        bkw = dict(rays_inner_seq=inner_bundle(p["rays_seq"], 25),
                   wind_adapt_iters=2)
    batch = tkalman.kalman_filter(
        p["grid"], p["rays_seq"], p["d_seq"], p["noise"], p["m_bg"],
        p["cov"], wind, p["dt_s"], num_directions=p["n_dirs"],
        cg_iters=CG, fade=0.95, **bkw)
    for t in range(NT):
        assert torch.equal(streamed[t], batch.m_seq[t]), t
    if mixed_wind:
        assert torch.equal(torch.as_tensor(f.wind, dtype=torch.float32),
                           batch.wind_seq[-1])


@pytest.mark.parametrize("options", [False, True])
def test_state_dict_round_trip_resumes_bitwise(tmp_path, options):
    """A restart after epoch 1, its state carried through an npz file,
    gives epochs 2.. bit for bit (adapted wind and noise scale ride the
    state)."""
    f1 = make(TOnline, "port", options)
    full = [port_step(f1, t, options)[0] for t in range(NT)]
    f2 = make(TOnline, "port", options)
    for t in range(2):
        port_step(f2, t, options)
    np.savez(tmp_path / "s.npz", **f2.state_dict())
    f3 = make(TOnline, "port", options)
    with np.load(tmp_path / "s.npz") as z:
        f3.load_state({k: z[k] for k in z.files})
    assert (f3.t, f3.r_scale, f3.dt_s) == (f2.t, f2.r_scale, f2.dt_s)
    np.testing.assert_array_equal(f3.wind, f2.wind)
    m2, _ = port_step(f3, 2, options)
    assert torch.equal(m2, full[2])


def test_state_saved_by_jax_continues_in_the_port():
    """The JAX stream's state after epoch 2, carried into the port, gives
    epoch 3 as JAX gives it."""
    want, jdiags, state2 = jax_stream(False)
    f = make(TOnline, "port")
    f.load_state(convert.online_state_from_numpy(state2))
    assert f.t == 2 and f.m.dtype == torch.float32
    np.testing.assert_array_equal(f.m.numpy(), state2["m"])
    m, diag = port_step(f, 2)
    assert_epoch_close(m.numpy(), want[2], 2)
    np.testing.assert_allclose(diag["pre_residual"],
                               jdiags[2]["pre_residual"], rtol=1e-3)


def test_ema_scale_is_the_reference_arithmetic():
    from ionotomo_tpu.inversion.online import _ema_scale as jema
    for args in [(1.0, 4.0, 0.3, (0.1, 30.0)), (2.5, 0.01, 0.5, (0.1, 30.0)),
                 (20.0, 1e4, 0.9, (0.1, 30.0)), (0.2, 1e-2, 1.0, (0.1, 3))]:
        assert tonline._ema_scale(*args) == jema(*args)


def _probes(pkg):
    w, p = world()
    grid = w["grid"] if pkg == "jax" else p["grid"]
    mod = jiono if pkg == "jax" else tiono
    truth = np.asarray(w["m_true"][0], np.float32)
    return mod.probes_from_arrays(
        grid, [[0.0, 0.0, 250.0], [10.0, -20.0, 300.0], [-15.0, 5.0, 330.0],
               [5.0, 5.0, 400.0]],
        1.05e11 * np.exp(truth.mean()) * np.array([1.0, 1.3, 0.8, 1.1]),
        0.05)


def test_assimilate_probes_matches_jax():
    """The between-epoch sounding update of the current field (CG run to
    convergence: 12 iterations for 4 probes) and the increment it
    returns."""
    jf, tf = make(JOnline, "jax"), make(TOnline, "port")
    jd = np.asarray(jf.assimilate_probes(_probes("jax"), cg_iters=12))
    td = tf.assimilate_probes(_probes("port"), cg_iters=12).numpy()
    assert np.abs(jd).max() > 1e-3
    assert l2(td - jd) <= 1e-3 * l2(jd)
    np.testing.assert_allclose(tf.m.numpy(), np.asarray(jf.m), rtol=0,
                               atol=1e-3 * np.abs(jd).max())


def test_subspace_eigs_matches_jax_with_the_start_block_fed():
    """Top 6 eigenpairs of I + B Bᵀ (n = 300): eigenvalues within 1e-4
    relative, eigenvectors up to sign."""
    rng = np.random.default_rng(0)
    b = (rng.normal(size=(300, 10)) * np.geomspace(10, 0.5, 10)).astype(
        np.float32)
    key = jax.random.key(5)
    ju, jlam = jlinalg.subspace_eigs(
        lambda v: v + jnp.asarray(b) @ (jnp.asarray(b).T @ v), 300, 6, key,
        iters=3)
    z = np.array(jax.random.normal(key, (300, 14), jnp.float32))
    tb = torch.from_numpy(b)
    tu, tlam = tlinalg.subspace_eigs(lambda v: v + tb @ (tb.T @ v), 300, 6,
                                     torch.from_numpy(z), iters=3)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-4)
    overlap = np.abs(tu.numpy().T @ np.asarray(ju))
    np.testing.assert_allclose(np.diag(overlap), 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="start block"):
        tlinalg.subspace_eigs(lambda v: v, 300, 6, torch.zeros(300, 13))


def test_update_operator_eigs_matches_jax():
    """The serving diagnostic at the world's first epoch, linearised at
    the prior (rank 6, 2 power iterations): λ within 1e-3 relative, λ₁ the
    largest and every λ ≥ 1 (I + PSD)."""
    w, p = world()
    key = jax.random.key(0)
    _, jlam = jkalman.update_operator_eigs(
        w["grid"], jray(0), w["noise"], w["m_bg"], w["cov"], w["n_dirs"],
        key, rank=6)
    z = np.array(jax.random.normal(key, (w["grid"].num_voxels, 14),
                                   jnp.float32))
    _, tlam = tkalman.update_operator_eigs(
        p["grid"], tray(0), p["noise"], p["m_bg"], p["cov"], p["n_dirs"],
        torch.from_numpy(z), rank=6)
    jl, tl = np.asarray(jlam), tlam.numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[0] == tl.max() and tl.min() >= 0.999
