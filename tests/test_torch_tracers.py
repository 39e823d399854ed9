"""Parity of the port's remaining tracers with the JAX package on the same
numpy-seeded inputs: ``rays.inner_bundle`` and ``calc_rays``, the split-
field tracer's plain version (``trace_rays_split`` on CPU tensors) and the
closed-form Chapman background it takes, the stochastic beam trace and
``beam_noise_for_epoch`` fed JAX's own normal draw; and, with the kernel
entry points replaced by recorders, that a call on the card reaches K1r or
K1s and never the per-stage loop.

The world is a 16³ Chapman grid plus three smooth horizontal modes
(``test_torch_fermat.perturbed_world``), 150 MHz, ≤ 64 rays, ≤ 32 steps.
Each JAX trace is built once per module (module-scoped fixtures).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.geometry import fermat as jfermat, rays as jrays
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import constants, convert, kernels
from ionotomo_tpu_torch.core.field_models import field_model
from ionotomo_tpu_torch.geometry import fermat as tfermat, rays as trays
from ionotomo_tpu_torch.models import chapman as tchapman

from tests.test_torch_fermat import perturbed_world, ray_fan

torch.set_num_threads(2)

FREQ, LENGTH = 150e6, 1000.0

#: the four background settings the kernel's closed form is held to, and
#: the split tracer's two
BACKGROUNDS = {
    "default": {},
    "layers": dict(layers=jchapman.DEFAULT_LAYERS, cos_chi=0.7),
    "curved": dict(curved=True, site_height_km=0.2),
    "plasmasphere": dict(layers=jchapman.DEFAULT_LAYERS,
                         plasmasphere_n0=1e10),
}
SPLIT_BACKGROUNDS = {
    "single": {},
    "layers_curved": dict(layers=jchapman.DEFAULT_LAYERS, curved=True,
                          cos_chi=0.6, plasmasphere_n0=1e10),
}


@pytest.fixture(scope="module")
def world():
    jg, m = perturbed_world(n=16)
    return jg, m, convert.grid_from_numpy(jg, device="cpu")


def _points(seed, n=300):
    return np.random.default_rng(seed).uniform(
        (-300, -300, 40), (300, 300, 1000), (n, 3)).astype(np.float32)


# --- rays -------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
def test_inner_bundle_matches_jax(stacked):
    """Every k-th sample with the endpoints kept and ds × k, bitwise, for
    an (R, N, 3) and a stacked (Nt, R, N, 3) bundle; both errors with the
    reference's messages."""
    rng = np.random.default_rng(3)
    shape = (2, 5, 17, 3) if stacked else (5, 17, 3)
    pts = rng.normal(size=shape).astype(np.float32)
    ds = rng.uniform(1, 2, shape[:-2]).astype(np.float32)
    jb = jrays.inner_bundle(jrays.RayBundle(jnp.asarray(pts),
                                            jnp.asarray(ds)), 5)
    tb = trays.inner_bundle(trays.RayBundle(torch.from_numpy(pts),
                                            torch.from_numpy(ds)), 5)
    assert tuple(tb.points.shape) == shape[:-2] + (5, 3)
    np.testing.assert_array_equal(tb.points.numpy(), np.asarray(jb.points))
    np.testing.assert_array_equal(tb.ds.numpy(), np.asarray(jb.ds))
    for n_inner in (1, 17, 6):
        with pytest.raises(ValueError) as want:
            jrays.inner_bundle(jrays.RayBundle(jnp.asarray(pts),
                                               jnp.asarray(ds)), n_inner)
        with pytest.raises(ValueError) as got:
            trays.inner_bundle(trays.RayBundle(torch.from_numpy(pts),
                                               torch.from_numpy(ds)), n_inner)
        assert str(got.value) == str(want.value)


def test_calc_rays_matches_jax(world):
    """Straight: the (antenna × direction) samples to 1e-4 km (the two
    packages' linspace differ in the last bit). Bent on the default cubic
    model at 16 steps: 5e-4 km (``test_torch_fermat``'s bound). The bent
    call without a field raises as the reference does."""
    jg, m, tg = world
    o, d = ray_fan(12, seed=4)
    ants, dirs = o[:4], d[:3]
    js = jrays.calc_rays(ants, dirs, n_samples=9)
    ts = trays.calc_rays(torch.from_numpy(ants), torch.from_numpy(dirs),
                         n_samples=9)
    np.testing.assert_allclose(ts.points.numpy(), np.asarray(js.points),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ts.ds.numpy(), np.asarray(js.ds))
    jb = jrays.calc_rays(ants, dirs, jnp.asarray(m), jg, FREQ,
                         straight_line_approx=False, n_samples=17)
    tb = trays.calc_rays(torch.from_numpy(ants), torch.from_numpy(dirs),
                         torch.from_numpy(m), tg, FREQ,
                         straight_line_approx=False, n_samples=17)
    assert tuple(tb.points.shape) == (12, 17, 3)
    np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                               rtol=0, atol=5e-4)
    np.testing.assert_array_equal(tb.ds.numpy(), np.asarray(jb.ds))
    with pytest.raises(ValueError, match="bent rays need"):
        trays.calc_rays(ants, dirs, straight_line_approx=False)


# --- the closed-form background ----------------------------------------------

def _closure_background(n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0,
                        cos_chi=None, curved=False, earth_radius_km=None,
                        site_height_km=0.0, layers=None,
                        plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0):
    """``background_ne_fn`` as the port had it before it returned an
    object: a closure, the gradient by autograd."""
    cc = None if cos_chi is None else float(cos_chi)
    factor = 1.0 if cc is None else float(tchapman.solar_zenith_factor(cc))
    r_earth = (constants.EARTH_RADIUS_KM if earth_radius_km is None
               else float(earth_radius_km))

    def ne_of(x):
        if curved:
            zc = r_earth + site_height_km + x[:, 2]
            h = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                           + zc * zc) - r_earth
        else:
            h = x[:, 2]
        if layers is not None:
            return tchapman.multi_chapman_ne(h, layers, cc, plasmasphere_n0,
                                             plasmasphere_scale_km)
        return factor * tchapman.chapman_ne(h, n_peak, h_peak_km, scale_km)

    def fn(points):
        with torch.enable_grad():
            x = points.detach().requires_grad_(True)
            ne = ne_of(x)
            (grad,) = torch.autograd.grad(ne.sum(), x)
        return ne.detach(), grad

    return fn


@pytest.mark.parametrize("case", sorted(BACKGROUNDS))
def test_background_object_is_the_closure_bitwise(case):
    """The object's ``__call__`` (the plain version) gives the former
    closure's numbers to the bit; it carries its parameters."""
    kw = BACKGROUNDS[case]
    pts = torch.from_numpy(_points(61))
    bg = tchapman.background_ne_fn(**kw)
    for a, b in zip(bg(pts), _closure_background(**kw)(pts)):
        assert torch.equal(a, b)
    assert bg == tchapman.background_ne_fn(**kw) and hash(bg) == hash(
        tchapman.background_ne_fn(**kw))
    params = bg.kernel_params("cpu")
    assert params["layers"].shape == (3 if "layers" in kw else 1, 4)
    assert params["curved"] == bool(kw.get("curved"))


@pytest.mark.parametrize("case", sorted(BACKGROUNDS))
def test_background_value_is_the_calls_value_bitwise(world, case):
    """``value``, which the split tracer's perturbation grid takes (no
    backward pass), is ``__call__``'s n_e to the bit, and so is the
    perturbation grid it gives that of a closure over ``__call__``."""
    _, m, tg = world
    kw = BACKGROUNDS[case]
    pts = torch.from_numpy(_points(63))
    bg = tchapman.background_ne_fn(**kw)
    assert torch.equal(bg.value(pts), bg(pts)[0])
    m = torch.from_numpy(m)
    assert torch.equal(tfermat.split_perturbation(m, tg, bg),
                       tfermat.split_perturbation(m, tg, lambda x: bg(x)))


@pytest.mark.parametrize("case", sorted(BACKGROUNDS))
def test_background_closed_form_matches_autodiff(case):
    """The kernel's closed form (``value_and_grad_analytic``, K1s's
    operation order) against autodiff of the profile: ∇n_e within
    1e-6·max|∇n_e| of the reference's ``jax.value_and_grad`` under
    ``vmap`` and of the port's autograd (``__call__``); n_e within 1e-7
    relative of the port's (the same exps) and 5e-6 relative of the
    reference's (``test_torch_turbulence``'s bound: in the deep tails,
    where the exponent reaches ~20, the two libraries' exps differ by a
    few ulps). Measured: ∇n_e 6.1e-7 of max against the reference, n_e
    3.0e-6 against the reference and 6.6e-8 against the port."""
    kw = BACKGROUNDS[case]
    pts = _points(62)
    jn, jgr = (np.asarray(a) for a in
               jchapman.background_ne_fn(**kw)(jnp.asarray(pts)))
    bg = tchapman.background_ne_fn(**kw)
    tn, tgr = bg.value_and_grad_analytic(torch.from_numpy(pts))
    an, agr = bg(torch.from_numpy(pts))
    for want_n, want_g, rtol in ((jn, jgr, 5e-6), (an.numpy(), agr.numpy(),
                                                   1e-7)):
        np.testing.assert_allclose(tn.numpy(), want_n, rtol=rtol)
        np.testing.assert_allclose(tgr.numpy(), want_g, rtol=0,
                                   atol=1e-6 * np.abs(want_g).max())


# --- the split-field tracer --------------------------------------------------

@pytest.fixture(scope="module")
def split_traces(world):
    """The JAX split trace of 48 rays, 32 steps, path kept, for every
    background and method."""
    jg, m, _ = world
    o, d = ray_fan(48, seed=6)
    out = {}
    for case, kw in SPLIT_BACKGROUNDS.items():
        bg = jchapman.background_ne_fn(**kw)
        for method in ("leapfrog", "rk4"):
            b, t = jfermat.trace_rays_split(
                jnp.asarray(m), jg, jnp.asarray(o), jnp.asarray(d), FREQ, bg,
                LENGTH, n_steps=32, keep_path=True, method=method)
            out[case, method] = np.asarray(b.points), np.asarray(t)
    return o, d, out


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("case", sorted(SPLIT_BACKGROUNDS))
def test_trace_rays_split_matches_jax(world, split_traces, case, method):
    """The plain split tracer (``trace_rays_split`` on CPU tensors, which
    is ``trace_rays_split_ref``) against the reference's: path samples
    within 5e-4 km and TEC within 2e-6 relative (``test_torch_fermat``'s
    bounds; measured 1.2e-4 km and 1.1e-6), single-layer and multi-layer
    + curved + plasmasphere."""
    _, m, tg = world
    o, d, want = split_traces
    bg = tchapman.background_ne_fn(**SPLIT_BACKGROUNDS[case])
    args = (torch.from_numpy(m), tg, torch.from_numpy(o),
            torch.from_numpy(d), FREQ, bg, LENGTH)
    kw = dict(n_steps=32, keep_path=True, method=method)
    tb, tt = tfermat.trace_rays_split(*args, **kw)
    rb, rt = tfermat.trace_rays_split_ref(*args, **kw)
    assert torch.equal(tb.points, rb.points) and torch.equal(tt, rt)
    jp, jt = want[case, method]
    assert tb.points.shape == jp.shape == (48, 33, 3)
    np.testing.assert_allclose(tb.points.numpy(), jp, rtol=0, atol=5e-4)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=2e-6)


def test_split_perturbation_matches_jax(world):
    """δ = K_NE·e^m − n_e,bg at the grid points from the f32 axes, to
    1e-6·max|K_NE·e^m| (two exps of different libraries)."""
    jg, m, tg = world
    bg = tchapman.background_ne_fn(**SPLIT_BACKGROUNDS["layers_curved"])
    jbg = jchapman.background_ne_fn(**SPLIT_BACKGROUNDS["layers_curved"])
    ax, ay, az = jg.axes()
    pts = jnp.stack(jnp.meshgrid(ax, ay, az, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    want = (constants.K_NE * np.exp(m.astype(np.float64))
            - np.asarray(jbg(pts)[0]).reshape(jg.shape)).reshape(16 * 16, 16)
    got = tfermat.split_perturbation(torch.from_numpy(m), tg, bg).numpy()
    scale = constants.K_NE * np.exp(m.astype(np.float64)).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


# --- the stochastic beam trace -----------------------------------------------

N_PATHS, N_BEAM_RAYS = 4, 24


@pytest.fixture(scope="module")
def beam_world(world):
    """The reference's stochastic trace and beam noise (cubic, leapfrog@32)
    with the normals its key draws, fed to the port as ``noise``."""
    jg, m, _ = world
    o, d = ray_fan(N_BEAM_RAYS, seed=8)
    key = jax.random.key(4)
    eps = np.asarray(jax.random.normal(key, (N_PATHS - 1, N_BEAM_RAYS, 2),
                                       jnp.float32))
    stoch = jfermat.trace_rays_stochastic(
        jnp.asarray(m), jg, jnp.asarray(o), jnp.asarray(d), FREQ, key,
        n_paths=N_PATHS, jitter_rad=2e-3, max_length_km=LENGTH, n_steps=32)
    ants, dirs = o[:4], d[:6]
    key2 = jax.random.key(9)
    eps2 = np.asarray(jax.random.normal(key2, (N_PATHS - 1, 24, 2),
                                        jnp.float32))
    noise = jfermat.beam_noise_for_epoch(
        jnp.asarray(m), jg, ants, dirs, FREQ, key2, n_paths=N_PATHS,
        i0=1, max_length_km=LENGTH, n_steps=32)
    return (o, d, eps, [np.asarray(a) for a in stoch],
            (ants, dirs, eps2, np.asarray(noise)))


def test_trace_rays_stochastic_matches_jax(world, beam_world):
    """JAX's own draw fed in as ``noise``: the beam mean within 2e-6
    relative (the deterministic tracer's bound), its spread and the
    endpoint rms within 1e-3 of their largest value (each a difference of
    nearly equal traces, in which the last-bit differences of the two
    packages do not cancel). Measured: 1.3e-7, 5.6e-5 and 8.1e-6."""
    _, m, tg = world
    o, d, eps, (jmu, jsd, jend), _ = beam_world
    mu, sd, end = tfermat.trace_rays_stochastic(
        torch.from_numpy(m), tg, torch.from_numpy(o), torch.from_numpy(d),
        FREQ, torch.from_numpy(eps), n_paths=N_PATHS, jitter_rad=2e-3,
        max_length_km=LENGTH, n_steps=32)
    np.testing.assert_allclose(mu.numpy(), jmu, rtol=2e-6)
    np.testing.assert_allclose(sd.numpy(), jsd, rtol=0,
                               atol=1e-3 * jsd.max())
    np.testing.assert_allclose(end.numpy(), jend, rtol=0,
                               atol=1e-3 * jend.max())
    assert jsd.max() > 0 and jend.max() > 0


def test_beam_noise_for_epoch_matches_jax(world, beam_world):
    """(Na, Nd) dTEC noise at the default Fresnel jitter, JAX's draw fed
    in: within 1e-3·max (the spread's bound above); the reference
    antenna's row exactly 0."""
    _, m, tg = world
    *_, (ants, dirs, eps2, want) = beam_world
    got = tfermat.beam_noise_for_epoch(
        torch.from_numpy(m), tg, torch.from_numpy(ants),
        torch.from_numpy(dirs), FREQ, torch.from_numpy(eps2),
        n_paths=N_PATHS, i0=1, max_length_km=LENGTH, n_steps=32)
    assert tuple(got.shape) == want.shape == (4, 6)
    assert bool((got[1] == 0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * want.max())


def test_trace_rays_stochastic_is_one_trace_of_all_paths(world,
                                                         monkeypatch):
    """All n_paths × R rays go through one ``trace_rays`` call, paths
    outermost, path 0 the rays themselves; a generator's draw is the same
    as the tensor it draws; a noise of another shape raises."""
    _, m, tg = world
    o, d = (torch.from_numpy(a) for a in ray_fan(10, seed=2))
    calls = []
    real = tfermat.trace_rays

    def recorder(field_m, grid, origins, directions, *a, **k):
        calls.append((origins.clone(), directions.clone()))
        return real(field_m, grid, origins, directions, *a, **k)

    monkeypatch.setattr(tfermat, "trace_rays", recorder)
    args = (torch.from_numpy(m), tg, o, d, FREQ)
    kw = dict(n_paths=3, n_steps=8, interp="zp")
    eps = torch.randn((2, 10, 2), generator=torch.Generator().manual_seed(5))
    got = tfermat.trace_rays_stochastic(*args, eps, **kw)
    assert len(calls) == 1
    origins, directions = calls[0]
    assert torch.equal(origins, o.repeat(3, 1))
    assert torch.equal(directions[:10], d / torch.linalg.norm(
        d, dim=-1, keepdim=True))
    drawn = tfermat.trace_rays_stochastic(
        *args, torch.Generator().manual_seed(5), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, drawn))
    with pytest.raises(ValueError, match="noise must have shape"):
        tfermat.trace_rays_stochastic(*args, eps[:1], **kw)


# --- the kernels a call on the card reaches ----------------------------------

class _FlaggedCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a call takes
    the kernel route with the entry points replaced by recorders."""

    @property
    def is_cuda(self):
        return True


def _flagged(a):
    return torch.from_numpy(a).as_subclass(_FlaggedCuda)


def _recorders(monkeypatch, names, n_steps):
    called = []

    def recorder(table, grid, origins, directions, n, keep_path, _n=None,
                 **k):
        called.append((_n, n, keep_path, k.get("rk4")))
        r = origins.shape[0]
        path = torch.zeros((r, n + 1, 3)) if keep_path else None
        return torch.zeros((r, 3)), torch.zeros((r,)), path

    for name in names:
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: recorder(*a, _n=_n, **k))

    def no_loop(*a, **k):
        raise AssertionError("a call on the card reached the per-stage loop")

    monkeypatch.setattr(tfermat, "_trace_impl", no_loop)
    return called


RK4_KERNELS = {"zp": "trace_rk4_zp", "cubic": "trace_rk4_cubic",
               "zpc3": "trace_rk4_zpc", "quadratic": "trace_rk4_quad"}


@pytest.mark.parametrize("interp", sorted(RK4_KERNELS))
def test_cuda_rk4_runs_the_models_own_kernel(world, interp, monkeypatch):
    """On the card, rk4 is one launch of K1r over the model's table
    (``_tracer_kernel``), the stage loop never: the entry points are
    replaced by recorders and ``_trace_impl`` by a trap, so this runs on
    the CPU with tensors flagged as on the card."""
    _, m, tg = world
    o, d = ray_fan(6)
    called = _recorders(monkeypatch, RK4_KERNELS.values(), 8)
    assert tfermat._tracer_kernel(field_model(interp), "rk4") is getattr(
        kernels, RK4_KERNELS[interp])
    b, t = tfermat.trace_rays(torch.from_numpy(m), tg, _flagged(o),
                              _flagged(d), FREQ, LENGTH, n_steps=8,
                              keep_path=False, method="rk4", interp=interp)
    assert [c[:3] for c in called] == [(RK4_KERNELS[interp], 8, False)]
    assert tuple(b.points.shape) == (6, 2, 3) and tuple(t.shape) == (6,)


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
def test_cuda_split_runs_k1s(world, method, monkeypatch):
    """On the card, ``trace_rays_split`` is one launch of K1s (leapfrog or
    rk4) with the background's parameters, the stage loop never; a
    background K1s cannot evaluate raises there."""
    _, m, tg = world
    o, d = ray_fan(6)
    called = _recorders(monkeypatch, ["trace_split"], 8)
    bg = tchapman.background_ne_fn(**SPLIT_BACKGROUNDS["layers_curved"])
    args = (torch.from_numpy(m), tg, _flagged(o), _flagged(d), FREQ)
    b, t = tfermat.trace_rays_split(*args, bg, LENGTH, n_steps=8,
                                    keep_path=True, method=method)
    assert called == [("trace_split", 8, True, method == "rk4")]
    assert tuple(b.points.shape) == (6, 9, 3)
    with pytest.raises(TypeError, match="ChapmanBackground"):
        tfermat.trace_rays_split(*args, lambda x: bg(x), LENGTH, n_steps=8,
                                 method=method)
