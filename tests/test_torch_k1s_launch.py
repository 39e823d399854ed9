"""K1s's launch checked on the CPU: which form of the background the
split tracer's wrapper passes the card, the call's own threshold and
block, and the plain background twin on a single layer.

The card's K1s comes in two forms (``csrc/trace_split.cu``): one Chapman
layer of sensitivity 1 over the flat Earth without a plasmasphere, its
parameters passed as numbers (``ionotomo_trace_split_layer``), and the
general one, which reads its layers from the card
(``ionotomo_trace_split``). ``kernels.split_form`` picks the form from
the host's copy of the background's parameters; here the entries are
replaced by recorders. The one-layer form runs the general form's
operations on that case in its order; its plain twin is
``ChapmanBackground.value_and_grad_analytic``, which on one layer is
bitwise the same layer given as a one-row stack, and the plain split
tracer over it stays within ``test_torch_tracers.py``'s bounds of the JAX
package's trace over that stack (5e-4 km, 2e-6 relative TEC).
"""
import contextlib
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.geometry import fermat as jfermat
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import convert, kernels
from ionotomo_tpu_torch.geometry import fermat
from ionotomo_tpu_torch.models import chapman

torch.set_num_threads(2)

#: backgrounds by the form K1s takes for them
FORMS = {
    "default": ({}, "layer"),
    "cos_chi": (dict(cos_chi=0.6), "layer"),
    "one_row_stack": (dict(layers=(("F2", 1.0e12, 350.0, 80.0, 1.0),)),
                      "layer"),
    # a single layer carries no plasmasphere (its n0 is ignored)
    "single_plasmasphere_ignored": (dict(plasmasphere_n0=1e10), "layer"),
    "layers": (dict(layers=chapman.DEFAULT_LAYERS), "general"),
    "one_row_half_sensitivity": (
        dict(layers=(("F2", 1.0e12, 350.0, 80.0, 0.5),), cos_chi=0.6),
        "general"),
    "curved": (dict(curved=True), "general"),
    "plasmasphere": (dict(layers=chapman.DEFAULT_LAYERS,
                          plasmasphere_n0=1e10), "general"),
}


@pytest.fixture(scope="module")
def world():
    """JAX grid, port grid, a perturbed Chapman log-density (numpy) and 48
    rays from a numpy seed."""
    jg = JGrid.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                           (16, 16, 16))
    m = np.array(jchapman.log_parametrize(jchapman.chapman_field(jg)))
    rng = np.random.default_rng(29)
    pts = jg.meshgrid()
    for _ in range(3):
        k = rng.uniform(-1, 1, 3) * 2 * np.pi / np.array([300., 300., 400.])
        m += 0.2 * np.sin(pts @ k + rng.uniform(0, 2 * np.pi))
    n = 48
    o = np.concatenate([rng.uniform(-150, 150, (n, 2)), np.zeros((n, 1))],
                       -1).astype(np.float32)
    zen, az = rng.uniform(0.05, 0.6, n), rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return jg, convert.grid_from_numpy(jg, device="cpu"), \
        m.astype(np.float32), o, d


def _record_launches(monkeypatch):
    """kernels' launch replaced by a recorder of (entry, arguments), the
    device checks by the CPU, so that ``trace_split_with`` runs its wiring
    on CPU tensors."""
    seen = []
    monkeypatch.setattr(kernels, "_check", lambda name, specs: torch.device(
        "cpu"))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, entry, *args: seen.append((entry, args)))
    return seen


@pytest.mark.parametrize("case", sorted(FORMS))
def test_the_wrapper_passes_the_backgrounds_own_form(world, case,
                                                     monkeypatch):
    """``split_form`` and the entry ``trace_split_with`` launches: the
    one-layer entry with the layer's n_peak, h_peak and scale and the solar
    factor, as the general entry would read them from ``layers``; the
    general entry with ``layers`` and the background's scalars."""
    _, tg, m, o, d = world
    kw, want = FORMS[case]
    bg = chapman.background_ne_fn(**kw)
    params = bg.kernel_params("cpu")
    assert kernels.split_form(params) == want
    seen = _record_launches(monkeypatch)
    pert = torch.zeros((16 * 16, 16))
    c = fermat._step_constants(150e6, 1000.0, 8)
    for rk4 in (False, True):
        kernels.trace_split_with(
            pert, tg, torch.from_numpy(o), torch.from_numpy(d), 8, False,
            packed=None, order=None, threads=64, rk4=rk4, background=params,
            **c)
    assert [e for e, _ in seen] == ["ionotomo_trace_split"
                                    + ("_layer" if want == "layer" else "")
                                    ] * 2
    args = seen[0][1]
    assert args[12] == 0 and seen[1][1][12] == 1          # rk4
    layers = params["layers"].tolist()
    if want == "layer":
        n_peak, h_peak, scale, factor = args[18:22]
        assert np.float32(layers[0][0]) == np.float32(n_peak)
        assert np.float32(layers[0][1]) == np.float32(h_peak)
        assert np.float32(layers[0][2]) == np.float32(scale)
        assert layers[0][3] == 1.0 and factor == bg.factor
        assert len(args) == 26
    else:
        assert args[19] == len(layers) and args[20] == bg.factor
        assert args[21] == int(bg.curved)
        assert len(args) == 31


def test_the_general_form_is_taken_on_request_and_layer_refused(
        world, monkeypatch):
    """``form="general"`` takes any background; ``form="layer"`` only one
    that ``split_form`` calls so, refused before any launch."""
    _, tg, m, o, d = world
    seen = _record_launches(monkeypatch)
    pert = torch.zeros((16 * 16, 16))
    c = fermat._step_constants(150e6, 1000.0, 8)
    args = (pert, tg, torch.from_numpy(o), torch.from_numpy(d), 8, False)
    single = chapman.background_ne_fn().kernel_params("cpu")
    kernels.trace_split_with(*args, packed=None, order=None, threads=64,
                             rk4=False, background=single, form="general",
                             **c)
    assert seen[-1][0] == "ionotomo_trace_split"
    multi = chapman.background_ne_fn(
        layers=chapman.DEFAULT_LAYERS).kernel_params("cpu")
    for form in ("layer", "curved"):
        with pytest.raises(ValueError, match="no form"):
            kernels.trace_split_with(*args, packed=None, order=None,
                                     threads=64, rk4=False,
                                     background=multi, form=form, **c)
    assert len(seen) == 1


@pytest.mark.parametrize("packed, rk4, most", [
    (True, False, 256), (False, True, 256), (False, False, 1024)])
def test_a_block_past_the_budget_is_refused_first(world, packed, rk4, most,
                                                  monkeypatch):
    """K1s's leapfrog over the packed table and its rk4 launch at a
    register budget, so a block past 256 is refused before any launch; the
    leapfrog over the table as it is takes up to 1024."""
    _, tg, _, o, d = world
    seen = _record_launches(monkeypatch)
    pert = torch.zeros((16 * 16, 16))
    pk = torch.zeros((15, 16 * 16, 4)) if packed else None
    c = fermat._step_constants(150e6, 1000.0, 8)
    params = chapman.background_ne_fn().kernel_params("cpu")
    args = (pert, tg, torch.from_numpy(o), torch.from_numpy(d), 8, False)
    with pytest.raises(ValueError, match=f"from 32 to {most}"):
        kernels.trace_split_with(*args, packed=pk, order=None,
                                 threads=most + 32, rk4=rk4,
                                 background=params, **c)
    kernels.trace_split_with(*args, packed=pk, order=None, threads=most,
                             rk4=rk4, background=params, **c)
    assert [e for e, _ in seen] == ["ionotomo_trace_split_layer"]


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
@pytest.mark.parametrize("side", ["as_is", "at_pack", "below_sort",
                                  "at_sort", "sorted"])
def test_the_call_takes_its_own_layout_on_the_card(world, side, method,
                                                   monkeypatch):
    """K1s's call on a card of 4 SMs, the pack, the ray order and the
    ``_with`` entry replaced by recorders. Leapfrog at its own thresholds:
    the table as it is at ``SPLIT_AS_IS_THREADS`` a block below
    ``SPLIT_PACKED_RAYS_PER_SM`` rays an SM, packed in ray order at the
    small block from it, sorted and packed at the call's block from its
    ``SORT_AND_PACK`` threshold. rk4 at K1c's call: always packed, sorted
    from ``TRACE_CUBIC_RAYS_PER_SM`` at 256 a block, 64 below."""
    _, tg, _, _, _ = world
    sort_sm, threads, small = kernels.SORT_AND_PACK["trace_split"]
    pack_sm = kernels.SPLIT_PACKED_RAYS_PER_SM
    assert 0 < pack_sm < sort_sm and 32 <= small <= threads <= 256
    assert kernels.SPLIT_AS_IS_THREADS == 32
    n = {"as_is": pack_sm * 4 - 1, "at_pack": pack_sm * 4,
         "below_sort": sort_sm * 4 - 1, "at_sort": sort_sm * 4,
         "sorted": sort_sm * 4 + 300}[side]
    o, d = torch.zeros((n, 3)), torch.zeros((n, 3))
    pert = torch.zeros((16 * 16, 16))
    seen = {}
    monkeypatch.setattr(kernels, "_check", lambda *a: "card")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=4))
    monkeypatch.setattr(kernels, "pack_z_taps", lambda t, g: "pack")
    monkeypatch.setattr(kernels, "ray_order", lambda a, b, g: "order")
    monkeypatch.setattr(kernels, "trace_split_with",
                        lambda *a, **k: seen.update(k) or "traced")
    assert kernels.trace_split(pert, tg, o, d, 8, False,
                               rk4=method == "rk4", background="bg",
                               h=1.0) == "traced"
    if method == "rk4":
        fills = n >= kernels.TRACE_CUBIC_RAYS_PER_SM * 4
        want = ("pack", "order" if fills else None, 256 if fills else 64)
    else:
        want = {"as_is": (None, None, 32),
                "at_pack": ("pack", None, small),
                "below_sort": ("pack", None, small),
                "at_sort": ("pack", "order", threads),
                "sorted": ("pack", "order", threads)}[side]
    assert (seen["packed"], seen["order"], seen["threads"]) == want
    assert seen["background"] == "bg" and seen["h"] == 1.0
    assert seen["rk4"] == (method == "rk4")


@pytest.mark.parametrize("cos_chi", [None, 0.6])
def test_the_plain_twin_on_one_layer_is_the_one_row_stack(world, cos_chi):
    """The closed form K1s's one-layer form twins
    (``value_and_grad_analytic`` of ``background_ne_fn()``) bitwise the
    general path over the same layer given as a one-row stack, value and
    gradient, at the 16³ world's grid points and random points."""
    jg, _, _, _, _ = world
    pts = torch.from_numpy(np.concatenate([
        jg.meshgrid().reshape(-1, 3),
        np.random.default_rng(30).uniform((-400, -400, 0), (400, 400, 1100),
                                          (500, 3))]).astype(np.float32))
    single = chapman.background_ne_fn(cos_chi=cos_chi)
    stack = chapman.background_ne_fn(
        layers=(("F2", single.n_peak, single.h_peak_km, single.scale_km,
                 1.0),), cos_chi=cos_chi)
    for a, b in zip(single.value_and_grad_analytic(pts),
                    stack.value_and_grad_analytic(pts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["leapfrog", "rk4"])
def test_the_one_layer_split_trace_matches_jax(world, method):
    """The plain split tracer over the single layer (the one-layer form's
    case) against the JAX package's over the same layer as a one-row stack
    (its general path): path within 5e-4 km, TEC within 2e-6 relative."""
    jg, tg, m, o, d = world
    kw = dict(n_steps=32, keep_path=True, method=method)
    jbg = jchapman.background_ne_fn(
        layers=(("F2", 1.0e12, 350.0, 80.0, 1.0),), cos_chi=0.6)
    jb, jt = jfermat.trace_rays_split(jnp.asarray(m), jg, jnp.asarray(o),
                                      jnp.asarray(d), 150e6, jbg, 1000.0,
                                      **kw)
    bg = chapman.background_ne_fn(cos_chi=0.6)
    tb, tt = fermat.trace_rays_split(torch.from_numpy(m), tg,
                                     torch.from_numpy(o), torch.from_numpy(d),
                                     150e6, bg, 1000.0, **kw)
    np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-6)
