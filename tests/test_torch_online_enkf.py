"""``inversion.online.OnlineEnsembleKalman`` of the port against the JAX
package on the CPU, on the world of ``tests/test_torch_kalman.py`` (12³,
6 × 4 rays, 3 epochs, 4 members, cg 5, adaptive R at α = 0.3).

One JAX stream, built once for the module. Its draws are fed to the port
as ``tests/test_torch_enkf.py:jax_draws`` derives them from the
reference's key (the initial ensemble from ``fold_in(key, 0x7FFFFFFF)``,
epoch t's observation perturbations from ``fold_in(key, t)``), one epoch
at a time. Tolerances are ``test_torch_enkf.py``'s: the mean and every
member within 1e-2 of their departure from the prior mean (relative L2),
the spread within 1e-2, residuals 1e-3 relative; the noise scale within
1e-2 relative. The port's restart is held bit for bit; the sounding
update (``anchors.probe_sqrt_update``, deterministic) against JAX on the
same ensemble.
"""
import functools

import numpy as np
import jax
import pytest
import torch

from ionotomo_tpu.inversion.online import OnlineEnsembleKalman as JOnline
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.inversion.online import OnlineEnsembleKalman as \
    TOnline

from tests.test_torch_enkf import jax_draws
from tests.test_torch_kalman import NT, l2, world
from tests.test_torch_online import _probes, jray, tray

torch.set_num_threads(2)

B = 4
CG = 5
KEY = 7


def make(mod_online, pkg):
    w, p = world()
    src = w if pkg == "jax" else p
    kw = dict(key=jax.random.key(KEY)) if pkg == "jax" else {}
    return mod_online(src["grid"], src["cov"], src["m_bg"],
                      np.asarray(w["wind"]), w["dt_s"],
                      num_directions=w["n_dirs"], n_members=B, cg_iters=CG,
                      fade=0.95, adapt_r=0.3, **kw)


@functools.lru_cache(maxsize=None)
def draws():
    w, _ = world()
    n_rows = int(np.prod(w["d_seq"].shape[1:]))
    init, _, obs, _ = jax_draws(jax.random.key(KEY), w["grid"].shape, n_rows,
                                nt=NT, b=B)
    return torch.from_numpy(init), torch.from_numpy(obs)


def port_step(f, t):
    _, p = world()
    init, obs = draws()
    return f.step(tray(t), p["d_seq"][t], p["noise"], obs_noise=obs[t],
                  init_noise=init if t == 0 else None)


@functools.lru_cache(maxsize=None)
def jax_stream():
    w, _ = world()
    f = make(JOnline, "jax")
    out = []
    for t in range(NT):
        mean, std, diag = f.step(jray(t), w["d_seq"][t], w["noise"])
        out.append((np.asarray(mean), np.asarray(std), diag))
    return out, np.asarray(f.ens)


def test_online_enkf_matches_jax():
    want, jens = jax_stream()
    w, _ = world()
    bg = np.asarray(w["m_bg"])
    f = make(TOnline, "port")
    for t in range(NT):
        mean, std, diag = port_step(f, t)
        jmean, jstd, jd = want[t]
        assert l2(mean.numpy() - jmean) <= 1e-2 * l2(jmean - bg), t
        assert l2(std.numpy() - jstd) <= 1e-2 * l2(jstd), t
        assert sorted(diag) == sorted(jd) and diag["t"] == t
        np.testing.assert_allclose(diag["pre_residual"], jd["pre_residual"],
                                   rtol=1e-3)
        np.testing.assert_allclose(diag["r_scale"], jd["r_scale"],
                                   rtol=1e-2)
    assert f.ens.shape == jens.shape == (B,) + bg.shape
    for b in range(B):
        assert l2(f.ens[b].numpy() - jens[b]) <= 1e-2 * l2(jens[b] - bg), b


def test_online_enkf_needs_its_initial_draws():
    _, p = world()
    f = make(TOnline, "port")
    with pytest.raises(ValueError, match="init_noise"):
        f.step(tray(0), p["d_seq"][0], p["noise"], obs_noise=draws()[1][0])


def test_online_enkf_state_round_trip_resumes_bitwise(tmp_path):
    f1 = make(TOnline, "port")
    full = [port_step(f1, t) for t in range(NT)]
    f2 = make(TOnline, "port")
    for t in range(2):
        port_step(f2, t)
    np.savez(tmp_path / "s.npz", **f2.state_dict())
    f3 = make(TOnline, "port")
    with np.load(tmp_path / "s.npz") as z:
        f3.load_state(convert.online_state_from_numpy(
            {k: z[k] for k in z.files}))
    assert (f3.t, f3.r_scale) == (2, f2.r_scale)
    mean, std, _ = port_step(f3, 2)
    assert torch.equal(mean, full[2][0]) and torch.equal(std, full[2][1])
    assert torch.equal(f3.ens, f1.ens)


def test_online_enkf_assimilate_probes_matches_jax():
    """The square-root sounding update of one ensemble (the JAX stream's
    final one, carried across), CG run to convergence (12 iterations for 4
    probes): the mean increment and the updated members."""
    _, jens = jax_stream()
    jf, tf = make(JOnline, "jax"), make(TOnline, "port")
    jf.ens = jax.numpy.asarray(jens)
    tf.load_state(convert.online_state_from_numpy(
        dict(ensemble=jens, t=3, wind_kmps=tf.wind)))
    jd = np.asarray(jf.assimilate_probes(_probes("jax"), cg_iters=12))
    td = tf.assimilate_probes(_probes("port"), cg_iters=12).numpy()
    assert np.abs(jd).max() > 1e-3
    assert l2(td - jd) <= 1e-3 * l2(jd)
    je = np.asarray(jf.ens)
    assert l2(tf.ens.numpy() - je) <= 1e-3 * l2(je - jens)
    fresh = make(TOnline, "port")
    with pytest.raises(RuntimeError, match="first epoch"):
        fresh.assimilate_probes(_probes("port"))
