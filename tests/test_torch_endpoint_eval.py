"""The zp endpoint terms E over an ensemble's member axis, on the CPU
against the JAX package: the batched value + gradient (the plain version
the batched K1e is held to on the card) against ``jax.vmap`` of the
reference's ``interp_rows_with_grad`` over the tables, the linearised
dTEC operator with a member axis against one operator per member, and
the member pack that K2b's gather and the batched K1e share, refused
with any other table.

Tolerances: the batched value and gradient as in
``test_torch_boxspline.py::test_interp_rows_with_grad_matches_jax``:
5e-7·max|coef| for the value, that over the smallest spacing for the
gradient (f32 sums in another order); everything against the port's own
one-member versions bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import boxspline as jbox
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox, tricubic as ttri
from ionotomo_tpu_torch.forward import tec as ttec

from tests.test_torch_adjoint import NA, ND, _operator_world

torch.set_num_threads(2)

SHAPE = (16, 16, 16)
ORIGIN = (-1.0, 0.5, 2.0)
SPACING = (0.5, 0.25, 0.125)
MEMBERS = pytest.mark.parametrize("n_members", [3, 9])


def _tables(n_members, seed):
    """B prefiltered coefficient tables (B, nx*ny, nz) of random fields,
    from the JAX package's prefilter, and ~400 points: random in and
    around the grid, on lattice and half-lattice points, on u±v = 0."""
    rng = np.random.default_rng(seed)
    fields = rng.normal(size=(n_members,) + SHAPE).astype(np.float32)
    coef = np.stack([np.array(jbox.prefilter(jnp.asarray(f)))
                     for f in fields])
    n = np.asarray(SHAPE, np.float64)
    t = np.concatenate([
        rng.uniform(-3.0, n + 2.0, (300, 3)),
        rng.integers(0, n, (40, 3)).astype(np.float64),
        rng.integers(0, n - 1, (40, 3)) + 0.5,
        rng.integers(1, n - 1, (40, 3)) + np.array([0.25, 0.25, 0.5]),
        rng.integers(1, n - 1, (40, 3)) + np.array([0.25, -0.25, 0.5])])
    pts = (np.asarray(ORIGIN) + t * np.asarray(SPACING)).astype(np.float32)
    return coef.reshape(n_members, -1, SHAPE[2]), pts, np.abs(coef).max()


@MEMBERS
def test_batched_value_grad_matches_jax_vmap(n_members):
    """The batched E's plain version (what the CPU dispatch runs) against
    ``jax.vmap`` of the reference's ``interp_rows_with_grad`` over the
    tables, and member b bitwise the one-table plain version on table b."""
    table, pts, cmax = _tables(n_members, 40 + n_members)
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    tg = convert.grid_from_numpy(jg, device="cpu")
    jv, jgr = jax.vmap(jbox.interp_rows_with_grad, in_axes=(0, None, None))(
        jnp.asarray(table), jg, jnp.asarray(pts))
    tt = torch.from_numpy(table)
    tv, tgr = tbox.interp_rows_with_grad_batched(tt, tg,
                                                 torch.from_numpy(pts))
    assert tv.shape == (n_members, pts.shape[0])
    assert tgr.shape == (n_members, pts.shape[0], 3)
    tol = 5e-7 * cmax
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0,
                               atol=tol / min(SPACING))
    for b in range(n_members):
        v1, g1 = tbox.interp_rows_with_grad(tt[b], tg, torch.from_numpy(pts))
        assert torch.equal(tv[b], v1) and torch.equal(tgr[b], g1)


@MEMBERS
def test_member_axis_operator_is_one_operator_per_member(n_members):
    """``PairedDtecLinear`` on zp linearised about B fields at once (E on
    the (B, R, nz) table in one call) is, member by member, bitwise the
    operator linearised about that member's field over the same geometry:
    g0, J δm and Jᵀ y."""
    jg, tg, jb, tb, m0, rng = _operator_world(seed=5)
    m0s = np.stack([m0 + 0.1 * rng.normal(size=jg.shape).astype(np.float32)
                    for _ in range(n_members)])
    xs = rng.normal(size=(n_members,) + jg.shape).astype(np.float32)
    ys = rng.normal(size=(n_members, NA * ND)).astype(np.float32)
    geo = ttec.DtecGeometry(tg, tb, ND, 0, "hermite", "zp")
    op = ttec.dtec_paired_linear(torch.from_numpy(m0s), tg, tb, ND, 0,
                                 "hermite", "zp", geometry=geo)
    jx = op.apply(torch.from_numpy(xs))
    jty = op.apply_t(torch.from_numpy(ys))
    assert jx.shape == (n_members, NA * ND) and jty.shape == xs.shape
    for b in range(n_members):
        one = ttec.dtec_paired_linear(torch.from_numpy(m0s[b]), tg, tb, ND,
                                      0, "hermite", "zp", geometry=geo)
        assert torch.equal(op.g0[b], one.g0)
        assert torch.equal(jx[b], one.apply(torch.from_numpy(xs[b])))
        assert torch.equal(jty[b], one.apply_t(torch.from_numpy(ys[b])))


def test_member_pack_is_taken_only_with_its_own_table():
    """A ``MemberPack`` (here built from the pack's plain version, as the
    card's pack kernel is not on the CPU) is refused by K2b's gather and
    by the batched E with any tensor but the one it was packed from, an
    equal copy included."""
    table, pts, _ = _tables(3, 7)
    tt = torch.from_numpy(table)
    pack = ttri.MemberPack(tt, ttri.pack_members_ref(tt.reshape(3, -1)))
    tg = convert.grid_from_numpy(JGrid.create(ORIGIN, SPACING, SHAPE),
                                 device="cpu")
    p = torch.from_numpy(pts)
    ri, wxy, zi, wz = tbox.row_setup(tg, p)
    want = ttri.rows_value(tt, ri, wxy, zi, wz, True)
    assert torch.equal(ttri.rows_value(tt, ri, wxy, zi, wz, True, pack=pack),
                       want)
    v, g = tbox.interp_rows_with_grad_batched(tt, tg, p, pack)
    assert torch.equal(v, tbox.interp_rows_with_grad_batched(tt, tg, p)[0])
    copy = tt.clone()
    with pytest.raises(ValueError, match="MemberPack of another tensor"):
        ttri.rows_value(copy, ri, wxy, zi, wz, True, pack=pack)
    with pytest.raises(ValueError, match="MemberPack of another tensor"):
        tbox.interp_rows_with_grad_batched(copy, tg, p, pack)
