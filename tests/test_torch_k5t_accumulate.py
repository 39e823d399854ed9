"""K5ᵀ's redesign checked on the CPU: the plan of occupied rows it walks,
and a numpy walk of that plan in the kernel's order, adding into a given
table, against the port's plain version and ``jax.vjp`` of the JAX
package's ``interp_rows_with_grad``.

The walk sums each segment's pairs in plan order over its row's z span
(the kernel's 32-lane scan inside a batch is not emulated), folds a row's
segments in order, and adds the sum into the table once per touched
cell. Tolerances: against table + the plain version and table + the vjp,
1e-5·max|Eᵀ| (f32 sums in another order, the bound of
``test_torch_tricubic.py``'s transpose test); cells the stencils do not
touch stay bitwise the table's. One module-scoped world on its own
``np.random.default_rng``; a 16 × 18 × 20 grid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import tricubic as ttri
from ionotomo_tpu_torch.forward import tec
from ionotomo_tpu_torch.geometry import rays
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

SHAPE = (16, 18, 20)
ORIGIN = (-400.0, -400.0, 0.0)
SPACING = (50.0, 45.0, 57.0)
CHUNKS = [ttri.SEGMENT_PAIRS, 7, 1]


@pytest.fixture(scope="module")
def world():
    """JAX grid, port grid, a table (numpy), and points with their
    cotangents: edge-case points, a crowd clamped onto one corner (rows
    of many segments) and a bundle's endpoints (few touched z a row)."""
    rng = np.random.default_rng(62)
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    tg = convert.grid_from_numpy(jg, device="cpu")
    table = rng.normal(size=(SHAPE[0] * SHAPE[1], SHAPE[2])
                       ).astype(np.float32)
    corner = np.tile(np.asarray(ORIGIN, np.float32) - 30.0, (300, 1))
    corner[:, 2] = rng.uniform(0, 1000, 300)
    ants = np.concatenate([rng.uniform(-150, 150, (6, 2)), np.zeros((6, 1))],
                          -1).astype(np.float32)
    zen, az = rng.uniform(0.05, 0.6, 8), rng.uniform(0, 2 * np.pi, 8)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    o, d = rays.make_ray_batch(torch.from_numpy(ants), torch.from_numpy(dirs))
    ends, _ = tec._endpoint_tangents(
        rays.sample_straight_rays(o, d, 900.0, 9).points)
    pts = np.concatenate([edge_case_points(SHAPE, ORIGIN, SPACING, 80, rng),
                          corner, ends.numpy()]).astype(np.float32)
    n = len(pts)
    cv = rng.normal(size=(n,)).astype(np.float32)
    cg = rng.normal(size=(n, 3)).astype(np.float32)
    return jg, tg, table, pts, cv, cg


def _plan(world, chunk):
    _, tg, _, pts, _, _ = world
    idx, _, ri = ttri._row_neighborhood(tg, torch.from_numpy(pts))
    plan = ttri.build_row_plan(ri, SHAPE[0] * SHAPE[1], idx[:, 2, 1],
                               chunk=chunk, occupied_rows=True)
    return plan, ri.numpy(), idx[:, 2, 1].numpy()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_occupied_plan_has_no_empty_row_segment_and_each_pair_once(world,
                                                                   chunk):
    plan, ri, base = _plan(world, chunk)
    n_rows = SHAPE[0] * SHAPE[1]
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    row_seg, seg_row = plan.row_seg.numpy(), plan.seg_row.numpy()
    assert plan.live == plan.stride == 16 and plan.stream is None
    assert sorted(order.tolist()) == list(range(ri.size))
    counts = np.diff(offsets)
    np.testing.assert_array_equal(counts, np.bincount(ri.reshape(-1),
                                                      minlength=n_rows))
    n_seg = np.diff(row_seg)
    np.testing.assert_array_equal(n_seg, -(-counts // chunk))
    assert (n_seg[counts == 0] == 0).all() and (counts == 0).any()
    used = row_seg[-1]
    assert used <= plan.n_seg_max == -(-ri.size // chunk) + min(n_rows,
                                                                ri.size)
    np.testing.assert_array_equal(seg_row[:used],
                                  np.repeat(np.arange(n_rows), n_seg))
    np.testing.assert_array_equal(seg_row[used:], n_rows)
    # each row's z0 range: the least and greatest cell base of its pairs
    z0 = plan.z0_range.numpy()
    rows_sorted = ri.reshape(-1)[order]
    base_sorted = base[order // 16]
    for r in np.flatnonzero(counts):
        b = base_sorted[rows_sorted == r]
        assert (np.diff(b) >= 0).all()
        assert tuple(z0[r]) == (b.min(), b.max())
    np.testing.assert_array_equal(z0[counts == 0], [[0, -1]] * int(
        (counts == 0).sum()))
    assert not plan.counters.any()


def _walk_plan_adding(plan, flat, contrib, table):
    """table + Eᵀ as the accumulating K5ᵀ computes it from ``plan``:
    each used segment sums its pairs' contributions (4 a pair, flat
    (P·4,) table indices) in plan order into a zeroed span of its row,
    the touched z base−1 .. base+2 of the row's least and greatest base;
    a row of several segments sums their spans in segment order; the sum
    is added into the row once."""
    n_rows, nz = table.shape
    out = table.copy()
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    row_seg, seg_row = plan.row_seg.numpy(), plan.seg_row.numpy()
    z0 = plan.z0_range.numpy()
    partial = {}
    for s in range(row_seg[-1]):
        r = seg_row[s]
        lo, hi = max(z0[r, 0] - 1, 0), min(z0[r, 1] + 2, nz - 1)
        beg = offsets[r] + (s - row_seg[r]) * plan.chunk
        part = np.zeros(nz, np.float32)
        for p in order[beg:min(beg + plan.chunk, offsets[r + 1])]:
            for q in range(4 * p, 4 * p + 4):
                row, z = divmod(int(flat[q]), nz)
                assert row == r and lo <= z <= hi
                part[z] += contrib[q]
        partial[s] = part
    for r in np.flatnonzero(np.diff(row_seg)):
        lo, hi = max(z0[r, 0] - 1, 0), min(z0[r, 1] + 2, nz - 1)
        acc = np.zeros(nz, np.float32)
        for s in range(row_seg[r], row_seg[r + 1]):
            acc += partial[s]
        out[r, lo:hi + 1] += acc[lo:hi + 1]
    return out


@pytest.mark.parametrize("chunk", CHUNKS)
def test_plan_walk_adds_into_a_table_as_the_plain_version_and_jax(world,
                                                                  chunk):
    jg, tg, table, pts, cv, cg = world
    plan, _, _ = _plan(world, chunk)
    tp, tcv, tcg = (torch.from_numpy(a) for a in (pts, cv, cg))
    flat, contrib = ttri.value_grad_transpose_terms(tg, tp, tcv, tcg)
    got = _walk_plan_adding(plan, flat.numpy(), contrib.numpy(), table)
    e_plain = ttri.interp_rows_with_grad_transpose_ref(tg, tp, tcv, tcg)
    _, vjp = jax.vjp(lambda t: jtri.interp_rows_with_grad(
        t, jg, jnp.asarray(pts)), jnp.asarray(table))
    e_jax = np.asarray(vjp((jnp.asarray(cv), jnp.asarray(cg)))[0])
    for e in (e_plain.numpy(), e_jax):
        np.testing.assert_allclose(got, table + e, rtol=0,
                                   atol=1e-5 * np.abs(e).max())
    touched = np.zeros(table.size, bool)
    touched[ttri.interp_weights(tg, tp)[0].reshape(-1).numpy()] = True
    touched = touched.reshape(table.shape)
    np.testing.assert_array_equal(got[~touched], table[~touched])


def test_accumulating_entry_on_the_cpu_is_table_plus_the_plain_version(world):
    """``interp_rows_with_grad_transpose_add_`` on CPU tensors adds the
    plain version in place and returns the same tensor;
    ``interp_rows_with_grad_transpose`` is that into zeros."""
    _, tg, table, pts, cv, cg = world
    tp, tcv, tcg = (torch.from_numpy(a) for a in (pts, cv, cg))
    t = torch.from_numpy(table.copy())
    e = ttri.interp_rows_with_grad_transpose_ref(tg, tp, tcv, tcg)
    got = ttri.interp_rows_with_grad_transpose_add_(t, tg, tp, tcv, tcg)
    assert got is t
    assert torch.equal(got, torch.from_numpy(table) + e)
    assert torch.equal(ttri.interp_rows_with_grad_transpose(tg, tp, tcv, tcg),
                       e)
