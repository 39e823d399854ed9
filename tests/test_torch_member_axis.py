"""The ensemble's member axis below the filters, on the CPU against the
JAX package: ``rows_value`` with a (B, R, nz) table against ``jax.vmap``
of the reference's ``rows_value`` and its ``jax.vjp`` (the hand-written
batched transpose), the batching rule's other cases, a numpy emulation of
kernel K3b's member loop over one shared plan, the prefilter and the
field model's table on a leading axis, batched ``cg`` against per-member
``cg`` (reading nothing on the host), and the linearised dTEC operator
with a member axis against the JAX JVP per member.

Tolerances: gathers and transposes 1e-5·max|out| (f32 sums in another
order); operators 1e-4·max|out| and the adjoint identity 1e-4 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu_torch.core import boxspline as tbox, linalg as tlinalg
from ionotomo_tpu_torch.core import tricubic as ttri
from ionotomo_tpu_torch.core.field_models import field_model
from ionotomo_tpu_torch.forward import tec as ttec

from tests.test_torch_adjoint import NA, ND, _operator_world, _rel_err
from tests.test_torch_row_plan import (C, _k3_contributions,
                                       _reduce_by_segments, _rows_inputs)

torch.set_num_threads(2)

B = 3
SHAPES = pytest.mark.parametrize("k,l,xy_first",
                                 [(8, 3, True), (16, 4, False)],
                                 ids=["zp", "cubic"])


def _member_inputs(k, l, seed):
    """``_rows_inputs`` with B tables and B cotangents."""
    table, ri, wxy, zi, wz, ct = _rows_inputs(k, l, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tables = rng.normal(size=(B,) + table.shape).astype(np.float32)
    cts = rng.normal(size=(B,) + ct.shape).astype(np.float32)
    return tables, ri, wxy, zi, wz, cts


@SHAPES
def test_rows_value_member_axis_matches_jax_vmap(k, l, xy_first):
    """Forward against ``jax.vmap`` over the table; member b equals the
    unbatched call bitwise (the plain version loops the members)."""
    tables, ri, wxy, zi, wz, _ = _member_inputs(k, l, 200)
    # the reference's impl clamps no index: keep every index in range
    ri = np.clip(ri, 0, tables.shape[1] - 1)
    zi = np.clip(zi, 0, tables.shape[2] - 1)
    want = np.asarray(jax.vmap(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first))(jnp.asarray(tables)))
    args = tuple(map(torch.from_numpy, (ri, wxy, zi, wz)))
    got = ttri.rows_value(torch.from_numpy(tables), *args, xy_first)
    assert got.shape == want.shape == (B, ri.shape[0])
    assert _rel_err(got, want) <= 1e-5
    for b in range(B):
        one = ttri.rows_value(torch.from_numpy(tables[b]), *args, xy_first)
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())


@SHAPES
def test_rows_value_member_axis_backward_matches_jax_vjp(k, l, xy_first):
    """The batched transpose (autograd backward and the direct call)
    against ``jax.vjp`` of the vmapped reference; member b within
    1e-6·max of the unbatched plain transpose (``index_add_`` along
    another axis)."""
    tables, ri, wxy, zi, wz, cts = _member_inputs(k, l, 201)
    ri = np.clip(ri, 0, tables.shape[1] - 1)
    zi = np.clip(zi, 0, tables.shape[2] - 1)
    _, vjp = jax.vjp(jax.vmap(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first)), jnp.asarray(tables))
    want = np.asarray(vjp(jnp.asarray(cts))[0])
    args = tuple(map(torch.from_numpy, (ri, wxy, zi, wz)))
    leaf = torch.from_numpy(tables).requires_grad_(True)
    out = ttri.rows_value(leaf, *args, xy_first)
    (got,) = torch.autograd.grad(out, leaf, torch.from_numpy(cts))
    assert got.shape == tables.shape
    assert _rel_err(got, want) <= 1e-5
    direct = ttri.rows_value_transpose(torch.from_numpy(cts), *args,
                                       tables.shape[1:])
    np.testing.assert_array_equal(got.numpy(), direct.numpy())
    for b in range(B):
        one = ttri.rows_value_transpose(torch.from_numpy(cts[b]), *args,
                                        tables.shape[1:])
        assert float((got[b] - one).abs().max()) <= 1e-6 * float(
            one.abs().max())


def test_rows_value_batching_rule_other_cases():
    """Batched indices and weights loop the unbatched call (with the
    table batched or shared); a member axis on the weights alone raises."""
    tables, ri, wxy, zi, wz, _ = _member_inputs(8, 3, 202)
    ri = np.clip(ri, 0, tables.shape[1] - 1)
    zi = np.clip(zi, 0, tables.shape[2] - 1)
    rng = np.random.default_rng(202)
    perm = [rng.permutation(ri.shape[0]) for _ in range(B)]
    rib, wxyb, zib, wzb = (torch.from_numpy(np.stack([a[p] for p in perm]))
                           for a in (ri, wxy, zi, wz))
    got = ttri.rows_value(torch.from_numpy(tables), rib, wxyb, zib, wzb, True)
    shared = ttri.rows_value(torch.from_numpy(tables[0]), rib, wxyb, zib,
                             wzb, True)
    for b in range(B):
        args = (rib[b], wxyb[b], zib[b], wzb[b])
        np.testing.assert_array_equal(
            got[b].numpy(),
            ttri.rows_value(torch.from_numpy(tables[b]), *args, True).numpy())
        np.testing.assert_array_equal(
            shared[b].numpy(),
            ttri.rows_value(torch.from_numpy(tables[0]), *args, True).numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttri.rows_value(torch.from_numpy(tables[0]), torch.from_numpy(ri),
                        wxyb, torch.from_numpy(zi), torch.from_numpy(wz),
                        True)


@SHAPES
def test_k3b_member_loop_over_one_plan_matches_plain_and_jax(k, l, xy_first):
    """A numpy emulation of kernel K3b: every segment of the one shared
    plan reduced once per member in K3's order (pairs in plan order, then
    the segments of a row in order). Each member's emulated table is what
    the emulation of K3 makes of that member alone (so K3b's bits are
    K3's), within 1e-5·max of the plain version and of ``jax.vjp``."""
    tables, ri, wxy, zi, wz, cts = _member_inputs(k, l, 203)
    n_rows, nz = tables.shape[1:]
    # in range, as every caller's are: the reference's batched transpose
    # scatters at flat indices and does not drop a tap outside the table
    ri, zi = np.clip(ri, 0, n_rows - 1), np.clip(zi, 0, nz - 1)
    plan = ttri.build_row_plan(torch.from_numpy(ri), n_rows,
                               torch.from_numpy(zi[:, 0]), chunk=C)
    assert int((plan.row_seg[1:] - plan.row_seg[:-1]).max()) > 1
    # the member loop inside the segment loop, as the kernel runs it
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    row_seg = plan.row_seg.numpy()
    got = np.zeros((B, n_rows, nz), np.float32)
    for r in range(n_rows):
        for j in range(row_seg[r + 1] - row_seg[r]):
            beg = offsets[r] + j * C
            part = np.zeros((B, nz), np.float32)
            for p in order[beg:min(beg + C, offsets[r + 1])]:
                n, kk = divmod(int(p), k)
                for b in range(B):               # only ct differs by member
                    a = cts[b, n] * wxy[n, kk]
                    for t in range(l):
                        if 0 <= zi[n, t] < nz:
                            part[b, zi[n, t]] += np.float32(a * wz[n, t])
            got[:, r] += part
    plain = ttri.rows_value_transpose_ref(
        *map(torch.from_numpy, (cts, ri, wxy, zi, wz)), (n_rows, nz)).numpy()
    _, vjp = jax.vjp(jax.vmap(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first)), jnp.asarray(tables))
    want = np.asarray(vjp(jnp.asarray(cts))[0])
    for b in range(B):
        alone = _reduce_by_segments(
            plan, _k3_contributions(cts[b], wxy, zi, wz, k), nz)
        np.testing.assert_array_equal(got[b], alone)
    for ref in (plain, want):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("order", [2, 3])
def test_prefilter_and_its_transpose_carry_a_member_axis(order):
    """Leading axes ride along: member b within 1e-6·max of the unbatched
    call (the z matmul may round differently in a batch)."""
    rng = np.random.default_rng(204)
    ens = torch.from_numpy(rng.normal(size=(B, 9, 7, 11)).astype(np.float32))
    for fn in (tbox.prefilter, tbox.prefilter_transpose):
        got = fn(ens, order)
        assert got.shape == ens.shape
        for b in range(B):
            one = fn(ens[b], order)
            assert float((got[b] - one).abs().max()) <= 1e-6 * float(
                one.abs().max())


@pytest.mark.parametrize("interp", ["zp", "cubic"])
def test_field_model_table_carries_a_member_axis(interp):
    from ionotomo_tpu_torch.core.grids import Grid3D
    grid = Grid3D.create((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (6, 5, 7),
                         device="cpu")
    rng = np.random.default_rng(205)
    ens = torch.from_numpy(rng.normal(size=(B, 6, 5, 7)).astype(np.float32))
    model = field_model(interp)
    table = model.table(ens, grid)
    assert table.shape == (B, 30, 7)
    back = model.table_t(table, grid)
    assert back.shape == ens.shape
    for b in range(B):
        one = model.table(ens[b], grid)
        assert float((table[b] - one).abs().max()) <= 1e-6 * float(
            one.abs().max())


def _spd_system(seed, n=40, b=B):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)).astype(np.float32)
    a = a @ a.T / n + np.eye(n, dtype=np.float32)
    rhs = rng.normal(size=(b, 4, 10)).astype(np.float32)
    # an eigenvector converges in one step: members stop at different steps
    rhs[1] = np.linalg.eigh(a.astype(np.float64))[1][:, 0].reshape(4, 10)
    return torch.from_numpy(a), torch.from_numpy(rhs)


def test_batched_cg_equals_per_member_cg():
    """``cg(batch_dims=1)`` on (B, 4, 10) right-hand sides: each member's
    solution, iteration count, residual and convergence flag are those of
    its own unbatched solve (within 1e-6·max on the solution: the batched
    dot products reduce in another order), with members stopping at
    different iterations."""
    a, rhs = _spd_system(206)

    def matvec(x):
        return (x.reshape(x.shape[:-2] + (-1,)) @ a).reshape(x.shape)

    x, info = tlinalg.cg(matvec, rhs, max_iters=25, tol=1e-4, batch_dims=1)
    assert x.shape == rhs.shape and info.iterations.shape == (B,)
    its = []
    for b in range(B):
        xb, ib = tlinalg.cg(matvec, rhs[b], max_iters=25, tol=1e-4)
        assert float((x[b] - xb).abs().max()) <= 1e-6 * float(xb.abs().max())
        assert int(info.iterations[b]) == int(ib.iterations)
        assert bool(info.converged[b]) == bool(ib.converged)
        np.testing.assert_allclose(float(info.residual_norm[b]),
                                   float(ib.residual_norm), rtol=1e-3,
                                   atol=1e-6)   # a converged member's
                                                # residual is rounding
        its.append(int(ib.iterations))
    assert all(info.converged) and len(set(its)) > 1


def test_batched_cg_reads_nothing_on_the_host(monkeypatch):
    """The masked loop never asks the host whether to stop, batched or
    not: ``item``, ``__bool__``, ``__float__``, ``tolist`` and ``cpu`` are
    all forbidden while it runs."""
    a, rhs = _spd_system(207)

    def matvec(x):
        return (x.reshape(x.shape[:-2] + (-1,)) @ a).reshape(x.shape)

    def forbidden(*_a, **_k):
        raise AssertionError("cg read a tensor on the host")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    x, info = tlinalg.cg(matvec, rhs, max_iters=6, tol=1e-4, batch_dims=1)
    x1, _ = tlinalg.cg(matvec, rhs[0], max_iters=6, tol=1e-4, scale_x0=True,
                       x0=rhs[0])
    monkeypatch.undo()
    assert torch.isfinite(x).all() and torch.isfinite(x1).all()


@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
@pytest.mark.parametrize("interp", ["zp", "cubic"])
def test_member_axis_operator_matches_jax_per_member(quadrature, interp):
    """``PairedDtecLinear`` linearised about B fields at once over one
    shared geometry: g0, J δm and Jᵀ y per member against the JAX JVP and
    its transpose at that member's field (1e-4·max), the adjoint identity
    per member (1e-4 relative), and one operator applied to a batch of
    tangents (the square-root anchor update's use)."""
    jg, tg, jb, tb, m0, rng = _operator_world(seed=3)
    m0s = np.stack([m0 + 0.1 * rng.normal(size=jg.shape).astype(np.float32)
                    for _ in range(B)])
    xs = rng.normal(size=(B,) + jg.shape).astype(np.float32)
    ys = rng.normal(size=(B, NA * ND)).astype(np.float32)

    @jax.jit
    def reference(m, x, y):
        fwd = lambda f: jtec.dtec_paired_q(f, jg, jb, ND, 0, quadrature,
                                           interp).ravel()
        g0, jvp = jax.linearize(fwd, m)
        return g0, jvp(x), jax.linear_transpose(jvp, m)(y)[0]

    geo = ttec.DtecGeometry(tg, tb, ND, 0, quadrature, interp)
    op = ttec.dtec_paired_linear(torch.from_numpy(m0s), tg, tb, ND, 0,
                                 quadrature, interp, geometry=geo)
    jx = op.apply(torch.from_numpy(xs))
    jty = op.apply_t(torch.from_numpy(ys))
    assert op.g0.shape == jx.shape == (B, NA * ND)
    assert jty.shape == xs.shape
    for b in range(B):
        g0, want_jx, want_jty = reference(*map(jnp.asarray,
                                               (m0s[b], xs[b], ys[b])))
        assert _rel_err(op.g0[b], g0) <= 1e-4
        assert _rel_err(jx[b], want_jx) <= 1e-4
        assert _rel_err(jty[b], want_jty) <= 1e-4
        lhs = float(np.dot(jx[b].numpy().astype(np.float64), ys[b]))
        rhs = float(np.sum(xs[b].astype(np.float64) * jty[b].numpy()))
        assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))
    # one field, a batch of tangents and cotangents, the same geometry
    one = ttec.dtec_paired_linear(torch.from_numpy(m0s[0]), tg, tb, ND, 0,
                                  quadrature, interp, geometry=geo)
    jx1 = one.apply(torch.from_numpy(xs))
    jty1 = one.apply_t(torch.from_numpy(ys))
    for b in range(B):
        assert _rel_err(jx1[b], one.apply(torch.from_numpy(xs[b]))) <= 1e-6
        assert _rel_err(jty1[b],
                        one.apply_t(torch.from_numpy(ys[b]))) <= 1e-6
    assert _rel_err(jx1[0], jx[0]) <= 1e-6


@pytest.mark.parametrize("quadrature", ["hermite", "simpson"])
def test_absolute_tec_operator_matches_jax(quadrature):
    """``tec_linear_op`` (the paired operator without the pairing) against
    ``jax.linearize`` of ``tec_q``: g0, J and Jᵀ within 1e-4·max, also on
    the plain versions and with a member axis."""
    jg, tg, jb, tb, m0, rng = _operator_world(seed=4)
    x = rng.normal(size=jg.shape).astype(np.float32)
    y = rng.normal(size=(NA * ND,)).astype(np.float32)
    fwd = lambda f: jtec.tec_q(f, jg, jb, quadrature, "zp")
    g0, jvp = jax.linearize(fwd, jnp.asarray(m0))
    want_jty = jax.linear_transpose(jvp, jnp.asarray(m0))(jnp.asarray(y))[0]
    for ref in (False, True):
        op = ttec.tec_linear_op(torch.from_numpy(m0), tg, tb, quadrature,
                                "zp", ref=ref)
        assert op.g0.shape == (NA * ND,)
        assert _rel_err(op.g0, g0) <= 1e-4
        assert _rel_err(op.apply(torch.from_numpy(x)),
                        jvp(jnp.asarray(x))) <= 1e-4
        assert _rel_err(op.apply_t(torch.from_numpy(y)), want_jty) <= 1e-4
    both = op.apply(torch.from_numpy(np.stack([x, -x])))
    assert both.shape == (2, NA * ND)
    assert _rel_err(both[1], -np.asarray(jvp(jnp.asarray(x)))) <= 1e-4


def test_log_ne_linear_is_log_ne_at_and_its_transpose():
    """``LogNeLinear``: apply is ``log_ne_at`` (bitwise), apply_t its
    transpose (dot-product identity 1e-5 relative), both with a member
    axis."""
    jg, tg, jb, tb, m0, rng = _operator_world(seed=5)
    pts = torch.from_numpy(np.array(jb.points)[:, ::8])      # (R, 5, 3)
    op = ttec.LogNeLinear(torch.from_numpy(m0), tg, pts, "cubic")
    want = ttec.log_ne_at(torch.from_numpy(m0), tg, pts, "cubic")
    np.testing.assert_array_equal(op.g0.numpy(), want.numpy())
    x = torch.from_numpy(rng.normal(size=(2,) + jg.shape).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2,) + tuple(pts.shape[:2]))
                         .astype(np.float32))
    jx, jty = op.apply(x), op.apply_t(y)
    assert jx.shape == y.shape and jty.shape == x.shape
    for b in range(2):
        lhs = float((jx[b].double() * y[b].double()).sum())
        rhs = float((x[b].double() * jty[b].double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))
