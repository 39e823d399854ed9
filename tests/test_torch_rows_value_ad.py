"""``rows_value``'s forward mode and the batching rule's rare cases against
the JAX package on the CPU: ``torch.func.jvp`` with table, weight and
mixed tangents against ``jax.jvp`` of the reference's ``rows_value``
(whose jvp rule binds the primitive again for a table tangent and falls
back to derived AD through its plain implementation for weight tangents),
and a member axis on any subset of the table, ``ri``, ``wxy``, ``zi``,
``wz`` against ``jax.vmap`` with the same ``in_axes`` (the reference
rebinds its primitive or vmaps its plain implementation there).

Tolerance 1e-5·max|out| (f32 sums in another order), as
``tests/test_torch_adjoint.py``'s transposes. The reference's
implementation clamps no index, so every index is kept in range.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu_torch.core import tricubic as ttri

from tests.test_torch_adjoint import _rel_err, _rows_inputs

torch.set_num_threads(2)

B = 3
SHAPES = pytest.mark.parametrize("k,l,xy_first",
                                 [(8, 3, True), (16, 4, False)],
                                 ids=["zp", "cubic"])


def _inputs(k, l, seed):
    """(table, ri, wxy, zi, wz) in range, and a tangent of each float
    argument, as numpy."""
    table, ri, wxy, zi, wz, _ = _rows_inputs(k, l, n=300, seed=seed)
    ri = np.clip(ri, 0, table.shape[0] - 1)
    zi = np.clip(zi, 0, table.shape[1] - 1)
    rng = np.random.default_rng(seed + 1)
    tangents = {name: rng.normal(size=a.shape).astype(np.float32)
                for name, a in (("table", table), ("wxy", wxy), ("wz", wz))}
    return (table, ri, wxy, zi, wz), tangents


@SHAPES
@pytest.mark.parametrize("carried", [("table",), ("wxy",), ("wz",),
                                     ("wxy", "wz"), ("table", "wxy", "wz")],
                         ids=["table", "wxy", "wz", "weights", "mixed"])
def test_rows_value_jvp_matches_jax_jvp(k, l, xy_first, carried):
    """The primal and the tangent of ``torch.func.jvp`` in the carried
    arguments (the others held fixed) against ``jax.jvp``. A table tangent
    alone goes through the custom function's jvp rule (``rows_value`` of
    the tangent table, bitwise); a weight tangent through the plain twin."""
    args, tangents = _inputs(k, l, 11)
    slot = {"table": 0, "wxy": 2, "wz": 4}

    def call(rv, conv):
        def fn(*carried_args):
            full = [conv(a) for a in args]
            for name, a in zip(carried, carried_args):
                full[slot[name]] = a
            return rv(*full, xy_first)
        return fn

    primals = tuple(args[slot[n]] for n in carried)
    tans = tuple(tangents[n] for n in carried)
    want_out, want_tan = jax.jvp(
        call(lambda *a: jtri.rows_value(*a[:5], xy_first=a[5]), jnp.asarray),
        tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tans)))
    got_out, got_tan = torch.func.jvp(
        call(ttri.rows_value, torch.from_numpy),
        tuple(map(torch.from_numpy, primals)),
        tuple(map(torch.from_numpy, tans)))
    assert _rel_err(got_out, want_out) <= 1e-5
    assert _rel_err(got_tan, want_tan) <= 1e-5
    if carried == ("table",):
        direct = ttri.rows_value(torch.from_numpy(tangents["table"]),
                                 *map(torch.from_numpy, args[1:]), xy_first)
        np.testing.assert_array_equal(got_tan.numpy(), direct.numpy())


def test_rows_value_table_jvp_through_forward_ad_and_a_member_axis():
    """The same rule under ``torch.autograd.forward_ad`` (dual tensors)
    and with a (B, R, nz) table: the tangent is ``rows_value`` of the
    tangent tables bitwise, within 1e-5 of ``jax.jvp`` of the vmapped
    reference."""
    import torch.autograd.forward_ad as fwad

    (table, ri, wxy, zi, wz), _ = _inputs(8, 3, 12)
    rng = np.random.default_rng(13)
    tables = rng.normal(size=(B,) + table.shape).astype(np.float32)
    dts = rng.normal(size=tables.shape).astype(np.float32)
    rest = tuple(map(torch.from_numpy, (ri, wxy, zi, wz)))
    with fwad.dual_level():
        out = ttri.rows_value(fwad.make_dual(torch.from_numpy(tables),
                                             torch.from_numpy(dts)),
                              *rest, True)
        tan = fwad.unpack_dual(out).tangent
    np.testing.assert_array_equal(
        tan.numpy(),
        ttri.rows_value(torch.from_numpy(dts), *rest, True).numpy())
    _, want = jax.jvp(jax.vmap(lambda t: jtri.rows_value(
        t, *map(jnp.asarray, (ri, wxy, zi, wz)), xy_first=True)),
        (jnp.asarray(tables),), (jnp.asarray(dts),))
    assert _rel_err(tan, want) <= 1e-5


#: in_axes of (table, ri, wxy, zi, wz): every rare case of the reference's
#: batching rule (the production case, a batched table over shared
#: indices and weights, is ``tests/test_torch_member_axis.py``'s)
RARE_AXES = [
    (None, None, 0, None, None), (None, None, None, None, 0),
    (None, None, 0, None, 0), (0, None, 0, None, None),
    (0, None, None, None, 0), (0, None, 0, None, 0),
    (None, 0, None, None, None), (None, None, None, 0, None),
    (0, 0, None, 0, None), (None, 0, 0, None, None),
    (None, 0, 0, 0, 0), (0, 0, 0, 0, 0),
]


@pytest.mark.parametrize("in_axes,k,l,xy_first", [
    (a, *((8, 3, True) if i % 2 == 0 else (16, 4, False)))
    for i, a in enumerate(RARE_AXES)],
    ids=lambda a: ("".join("b" if x == 0 else "." for x in a)
                   if isinstance(a, tuple) else None))
def test_rows_value_partial_batching_matches_jax_vmap(in_axes, k, l,
                                                      xy_first):
    """A leading member axis of B = 3 on the arguments ``in_axes`` marks
    (each member's indices drawn anew, in range) against ``jax.vmap`` of
    the reference with the same ``in_axes``, the zp and cubic shapes in
    turn; member b is the unbatched call on member b's arguments
    bitwise."""
    args, _ = _inputs(k, l, 21)
    rng = np.random.default_rng(22)
    batched = []
    for a, ax in zip(args, in_axes):
        if ax is None:
            batched.append(a)
        elif a.dtype == np.int32:       # an index of each member's own
            perm = [rng.permutation(a.shape[0]) for _ in range(B)]
            batched.append(np.stack([a[p] for p in perm]))
        else:
            batched.append(rng.normal(size=(B,) + a.shape).astype(a.dtype))
    want = np.asarray(jax.vmap(
        lambda *a: jtri.rows_value(*a, xy_first=xy_first),
        in_axes=in_axes)(*map(jnp.asarray, batched)))
    targs = tuple(map(torch.from_numpy, batched))
    got = ttri.rows_value(*targs, xy_first)
    assert got.shape == want.shape == (B, args[1].shape[0])
    assert _rel_err(got, want) <= 1e-5
    for b in range(B):
        one = ttri.rows_value(*(a[b] if ax == 0 else a
                                for a, ax in zip(targs, in_axes)), xy_first)
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())
