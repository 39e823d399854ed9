"""K1z's and K1q's launch checked on the CPU: the plain zpc and
triquadratic tracers under a ray order, and how each call picks its layout
and block (``kernels.sort_and_pack``).

A ray order changes which rays share a warp and nothing else: the plain
tracer over permuted rays gives the permuted outputs bit for bit, path on
and off, on a 16³ world (``test_torch_k1_packed.py`` holds the same on zp).
The ordered plain tracer stays within ``test_torch_fermat.py``'s bounds of
the JAX package's ``trace_rays`` (5e-4 km, 2e-6 relative TEC). On the card
each call sorts and packs from its own threshold of rays an SM, at its own
block; below it reads the table as it is in ray order. That wiring is
checked with the kernel entries replaced by recorders.
"""
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

torch.set_num_threads(2)

MODELS = {"zpc": ("trace_leapfrog_zpc", "pack_z_taps"),
          "quadratic": ("trace_leapfrog_quad", "pack_zp_taps")}


@pytest.fixture(scope="module")
def world():
    """JAX grid, port grid, a perturbed Chapman log-density (numpy) and 80
    rays from a numpy seed."""
    jg = JGrid.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                           (16, 16, 16))
    m = np.array(jchapman.log_parametrize(jchapman.chapman_field(jg)))
    rng = np.random.default_rng(23)
    pts = jg.meshgrid()
    for _ in range(3):
        k = rng.uniform(-1, 1, 3) * 2 * np.pi / np.array([300., 300., 400.])
        m += 0.2 * np.sin(pts @ k + rng.uniform(0, 2 * np.pi))
    n = 80
    o = np.concatenate([rng.uniform(-150, 150, (n, 2)), np.zeros((n, 1))],
                       -1).astype(np.float32)
    zen, az = rng.uniform(0.05, 0.6, n), rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return jg, convert.grid_from_numpy(jg, device="cpu"), \
        m.astype(np.float32), o, d


@pytest.mark.parametrize("keep_path", [False, True])
@pytest.mark.parametrize("interp", sorted(MODELS))
def test_a_ray_order_leaves_the_plain_tracer_bitwise(world, interp,
                                                     keep_path):
    """Leapfrog over zpc or quadratic, the plain tracer, rays in their own
    order and in ``ray_order``: the same endpoints (or paths) and TEC per
    ray, bit for bit."""
    _, tg, m, o, d = world
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    perm = kernels.ray_order(o, d, tg).long()
    assert sorted(perm.tolist()) == list(range(o.shape[0]))
    assert not torch.equal(perm, torch.arange(o.shape[0]))
    kw = dict(n_steps=24, keep_path=keep_path, method="leapfrog",
              interp=interp)
    m = torch.from_numpy(m)
    b, t = fermat.trace_rays_ref(m, tg, o, d, 150e6, 1000.0, **kw)
    bp, tp = fermat.trace_rays_ref(m, tg, o[perm], d[perm], 150e6, 1000.0,
                                   **kw)
    assert torch.equal(bp.points, b.points[perm])
    assert torch.equal(tp, t[perm])


@pytest.mark.parametrize("interp", sorted(MODELS))
def test_the_ordered_plain_tracer_matches_jax(world, interp):
    """The plain tracer over the rays in ``ray_order``, scattered back,
    against the JAX package's ``trace_rays`` on the rays as they are."""
    jg, tg, m, o, d = world
    kw = dict(n_steps=12, keep_path=False, method="leapfrog", interp=interp)
    perm = kernels.ray_order(torch.from_numpy(o), torch.from_numpy(d),
                             tg).long().numpy()
    tb, tt = fermat.trace_rays_ref(torch.from_numpy(m), tg,
                                   torch.from_numpy(o[perm]),
                                   torch.from_numpy(d[perm]), 150e6, 1000.0,
                                   **kw)
    jb, jt = jfermat.trace_rays(jnp.asarray(m), jg, jnp.asarray(o),
                                jnp.asarray(d), 150e6, 1000.0, **kw)
    x, tau = np.empty_like(tb.points.numpy()), np.empty_like(tt.numpy())
    x[perm], tau[perm] = tb.points.numpy(), tt.numpy()
    np.testing.assert_allclose(x, np.asarray(jb.points), rtol=0, atol=5e-4)
    np.testing.assert_allclose(tau, np.asarray(jt), rtol=2e-6)


@pytest.mark.parametrize("name", sorted(kernels.SORT_AND_PACK))
def test_each_call_sorts_and_packs_from_its_own_threshold(name):
    """``sort_and_pack``: the table as it is, at the small block, one ray
    below the threshold of rays an SM; sorted and packed at the call's
    block from it. K1 and K1r on zp, zpc and quadratic keep K1's launch
    (K1z, K1q and K1s's leapfrog have their own)."""
    per_sm, threads, small = kernels.SORT_AND_PACK[name]
    assert 32 <= small <= threads <= 256 and per_sm >= 1
    for sms in (1, 132):
        assert kernels.sort_and_pack(name, per_sm * sms - 1, sms) == \
            (False, small)
        assert kernels.sort_and_pack(name, per_sm * sms, sms) == \
            (True, threads)
        assert kernels.sort_and_pack(name, 0, sms) == (False, small)
    if not name.startswith(("trace_leapfrog_zpc", "trace_leapfrog_quad",
                            "trace_split")):
        threads_k1 = 64 if name == "trace_leapfrog_zp" else \
            kernels.TRACE_RK4_THREADS
        assert (per_sm, threads, small) == (kernels.TRACE_ZP_RAYS_PER_SM,
                                            threads_k1, 32)


@pytest.mark.parametrize("side", ["below", "at"])
@pytest.mark.parametrize("interp", sorted(MODELS))
def test_the_call_takes_its_own_layout_on_the_card(world, interp, side,
                                                   monkeypatch):
    """K1z's and K1q's call on a card of 4 SMs, the entries replaced by
    recorders: one ray below the model's threshold, the table as it is in
    ray order at the small block; at it, the model's pack and the ray
    order at the call's block."""
    _, tg, _, _, _ = world
    name, pack = MODELS[interp]
    per_sm, threads, small = kernels.SORT_AND_PACK[name]
    n = per_sm * 4 - (side == "below")
    o, d = torch.zeros((n, 3)), torch.zeros((n, 3))
    table = torch.zeros((16 * 16, 16))
    seen = {}
    monkeypatch.setattr(kernels, "_check", lambda *a: "card")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=4))
    monkeypatch.setattr(kernels, pack, lambda t, g: "pack")
    monkeypatch.setattr(kernels, "ray_order", lambda a, b, g: "order")
    monkeypatch.setattr(kernels, name + "_with", lambda *a, **k: seen.update(
        k) or "traced")
    assert getattr(kernels, name)(table, tg, o, d, 8, False, h=1.0) == \
        "traced"
    want = (("pack", "order", threads) if side == "at"
            else (None, None, small))
    assert (seen["packed"], seen["order"], seen["threads"]) == want
    assert seen["h"] == 1.0



@pytest.mark.parametrize("name, packed, threads, refused", [
    ("trace_leapfrog_zpc", True, 512, True),
    ("trace_leapfrog_quad", True, 512, True),
    ("trace_leapfrog_zpc", True, 48, True),
    ("trace_rk4_zpc", False, 512, True),
    ("trace_leapfrog_zpc", True, 256, False),
    ("trace_leapfrog_quad", False, 512, False),
    ("trace_leapfrog_zp", True, 1024, False),
    ("trace_leapfrog_zp", True, 2048, True),
])
def test_a_block_past_the_launch_is_refused_first(world, name, packed,
                                                  threads, refused):
    """A ``_with`` entry refuses a block its launch cannot take before it
    looks at the tensors: past ``BUDGET_MAX_THREADS`` where it launches at a
    register budget (K1r; K1z and K1q over the packed table), past 1024
    elsewhere, or not a multiple of 32. Blocks it takes go on to the
    tensors' checks (here: CPU tensors, which the entries refuse)."""
    _, tg, _, _, _ = world
    o = d = torch.zeros((4, 3))
    table = torch.zeros((16 * 16, 16))
    pk = torch.zeros((14, 16 * 16, 4)) if packed else None
    before = dict(kernels.launches)
    with pytest.raises(ValueError) as err:
        getattr(kernels, name + "_with")(table, tg, o, d, 8, False,
                                         packed=pk, order=None,
                                         threads=threads, h=1.0)
    assert ("threads must be a multiple of 32" in str(err.value)) == refused
    if refused:
        most = kernels.BUDGET_MAX_THREADS if threads != 2048 else 1024
        assert f"from 32 to {most}" in str(err.value)
    else:
        assert "CUDA device" in str(err.value)
    assert kernels.launches == before
