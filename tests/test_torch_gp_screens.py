"""The port's GP toolkit (``utils.gaussian_process``) and sky screens
(``inversion.screens``) against the JAX package on the CPU, from the same
seeded numpy inputs.

- every kernel and the kernel algebra elementwise within rtol 1e-6, and
  ``params``/``with_params``;
- ``cho_solve_stack`` (batched, vector and matrix right-hand sides),
  ``log_marginal_likelihood`` and ``gp_predict`` within rtol 1e-5 (the
  variance within 1e-5 of the prior's), at noise 0.3 on
  ``tests/test_gp.py``'s data: at its noise 0.05 (K's condition number
  ~1e4) the two packages' f32 Cholesky factors part by up to 5.5e-5 in
  the log evidence and 1e-4 of the largest variance;
- ``fit_hyperparameters`` over 50 Adam steps: parameters within rtol 1e-3
  of the reference's, and the returned loss is the one at the start of
  the last step, before its update (the reference's ``losses[-1]``);
- the screens on ``tests/test_screens.py``'s world (10 antennas × 20
  directions, 16³; one DataPack, made by the port, fed to both): the
  default kernel's sigma is the population std (ddof 0), held-out means
  within 1e-4·max|dTEC| and variances within 1e-4·sigma², and the
  reference's bound on the held-out error. The fitted hyperparameters
  after ``tests/test_screens.py``'s 80 steps within 5e-3 relative: the
  world's noise (0.1 working units under signals of ~1e4) leaves K at the
  jitter's condition number, ~1e6, and the reference's own fit moves by
  up to 1.8e-3 when its input dTEC moves by one f32 rounding (measured,
  three draws at 80 and at 150 steps), so 5e-3 is about 3 x that.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.inversion import screens as jscreens
from ionotomo_tpu.utils import gaussian_process as jgp
from ionotomo_tpu_torch.data.synth import generate_example_datapack
from ionotomo_tpu_torch.inversion import screens as tscreens
from ionotomo_tpu_torch.utils import gaussian_process as tgp

torch.set_num_threads(2)


def kernels(gp):
    se = gp.SquaredExponential(0.7, 1.3)
    m15 = gp.Matern(0.5, 2.0, nu=1.5)
    return {"se": se,
            "rq": gp.RationalQuadratic(1.1, 0.8, alpha=2.5),
            "matern05": gp.Matern(1.0, 1.3, nu=0.5),
            "matern15": m15,
            "matern25": gp.Matern(0.9, 0.6, nu=2.5),
            "sum": se + m15,
            "product": se * m15,
            "nested": (se + m15) * gp.RationalQuadratic(1.0, 2.0, 0.5)}


def points(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(10, 2)).astype(np.float32),
            rng.normal(size=(7, 2)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(kernels(jgp)))
def test_kernels_match_the_reference(name):
    jk, tk = kernels(jgp)[name], kernels(tgp)[name]
    x1, x2 = points()
    for a, b in ((x1, x1), (x1, x2), (x1[:, :1], x2[:, :1])):
        want = np.asarray(jk(jnp.asarray(a), jnp.asarray(b)))
        got = tk(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tk.params() == jk.params()
    tx1, tx2 = torch.from_numpy(x1), torch.from_numpy(x2)
    np.testing.assert_array_equal(tk.with_params(tk.params())(tx1, tx2),
                                  tk(tx1, tx2))


def data(n=30, noise=0.05, seed=2):
    """``tests/test_gp.py``'s 1-D regression data."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))[:, None].astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.5 * x[:, 0]
         + rng.normal(scale=noise, size=n)).astype(np.float32)
    return x, y


def test_cho_solve_lml_and_predict_match_the_reference():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 9, 9))
    k = (a @ a.transpose(0, 2, 1) + 9 * np.eye(9)).astype(np.float32)
    for y in (rng.normal(size=(4, 9)), rng.normal(size=(4, 9, 3))):
        y = y.astype(np.float32)
        jx, jc = jax.jit(jgp.cho_solve_stack)(k, y)
        tx, tc = tgp.cho_solve_stack(torch.from_numpy(k), torch.from_numpy(y))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-6)
    x, y = data()
    xs = np.linspace(-2.5, 2.5, 12, dtype=np.float32)[:, None]
    tx, ty, txs = map(torch.from_numpy, (x, y, xs))
    # the nested kernel holds SE, Matérn 1.5, RQ, a sum and a product
    for name in ("matern05", "matern25", "nested"):
        jk, tk = kernels(jgp)[name], kernels(tgp)[name]
        # the reference under one jit a kernel (its eager ops compile one
        # by one)
        want = float(jax.jit(lambda a, b: jgp.log_marginal_likelihood(
            jk, a, b, 0.3))(x, y))
        got = float(tgp.log_marginal_likelihood(tk, tx, ty, 0.3))
        assert abs(got - want) <= 1e-5 * abs(want), name
        jm, jv = jax.jit(lambda a, b, c: jgp.gp_predict(jk, a, b, 0.3, c))(
            x, y, xs)
        tm, tv = tgp.gp_predict(tk, tx, ty, 0.3, txs)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(jm)).max())
        prior = float(torch.diagonal(tk(txs, txs)).max())
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5 * prior)


def test_fit_hyperparameters_matches_and_returns_the_pre_update_loss():
    x, y = data(n=40)
    k0 = dict(sigma=0.3, length_scale=2.5)
    jfit, jloss = jgp.fit_hyperparameters(jgp.SquaredExponential(**k0),
                                          jnp.asarray(x), jnp.asarray(y),
                                          0.05, steps=50)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tfit, tloss = tgp.fit_hyperparameters(tgp.SquaredExponential(**k0), tx,
                                          ty, 0.05, steps=50)
    for key, v in jfit.params().items():
        assert abs(float(tfit.params()[key]) - float(v)) <= 1e-3 * abs(
            float(v)), key
    assert abs(tloss - jloss) <= 1e-3 * abs(jloss)
    # the loss returned after 50 steps is -log evidence at the start of
    # step 50 (the kernel 49 steps give), not at the kernel it returns
    t49, _ = tgp.fit_hyperparameters(tgp.SquaredExponential(**k0), tx, ty,
                                     0.05, steps=49)
    before = -float(tgp.log_marginal_likelihood(t49, tx, ty, 0.05))
    after = -float(tgp.log_marginal_likelihood(tfit, tx, ty, 0.05))
    assert tloss == pytest.approx(before, rel=1e-6)
    assert abs(tloss - after) > 1e-4 * abs(tloss)


@pytest.fixture(scope="module")
def world():
    """``tests/test_screens.py``'s world, made by the port on the CPU."""
    dp, _ = generate_example_datapack(
        n_antennas=10, n_directions=20, n_times=1, mjd0=58000.45,
        grid_shape=(16, 16, 16), noise_tecu=1e-4, turbulence_amp=0.3,
        n_samples=33, device="cpu")
    return dp


def test_screens_match_the_reference(world):
    train = world.select(directions=np.arange(15))
    jscr = jscreens.fit_screen(train, 0)
    tscr = tscreens.fit_screen(train, 0, device="cpu")
    d = train.dtec[:, 0, :].astype(np.float32)
    assert tscr.kernel.sigma == pytest.approx(float(np.std(d)) + 1e-6,
                                              rel=1e-6)
    assert abs(tscr.kernel.sigma - float(np.std(d, ddof=1))) > 1e-3 * \
        tscr.kernel.sigma
    assert tscr.kernel.params() == pytest.approx(jscr.kernel.params(),
                                                 rel=1e-6)
    jm, jv = jscreens.predict_screen(jscr, world.directions[15:])
    tm, tv = tscreens.predict_screen(tscr, world.directions[15:])
    scale = np.abs(world.dtec).max()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-4 * tscr.kernel.sigma ** 2)
    truth = world.dtec[:, 0, 15:]
    err_gp = np.abs(tm.numpy() - truth).mean()
    err_mean = np.abs(truth - d.mean(axis=1, keepdims=True)).mean()
    assert err_gp < 0.8 * err_mean and (tv.numpy() >= 0).all()


def test_screen_hyperparameters_match_the_reference(world):
    jfit = jscreens.fit_screen_hyperparameters(world, 0, steps=80)
    tfit = tscreens.fit_screen_hyperparameters(world, 0, steps=80,
                                               device="cpu")
    for key, v in jfit.params().items():
        assert abs(float(tfit.params()[key]) - float(v)) <= 5e-3 * abs(
            float(v)), key
    jscr = jscreens.fit_screen(world, 0, kernel=jfit)
    tscr = tscreens.fit_screen(world, 0, kernel=tfit, device="cpu")
    jm, _ = jscreens.predict_screen(jscr, world.directions)
    tm, _ = tscreens.predict_screen(tscr, world.directions)
    assert np.isfinite(tm.numpy()).all()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-3 * np.abs(world.dtec).max())
