"""The member-innermost layout of kernels K2b and K3b and K3b's order of
summation, on the CPU against the JAX package: the pack's plain version
and its inverse, K2b's gather over the pack against the per-member plain
version, and a numpy emulation of K3b (the packed cotangent, one z-run
structure a batch for all members, the scan steps no run reaches skipped,
the rows of several segments folded per member in a second pass) that
must give each member bitwise what the emulation of K3 (``add_batch``'s
five-step scan, one member) gives it, and agree with ``jax.vjp`` of the
reference's vmapped ``rows_value``.

Tolerances: gathers 1e-5·Σ|w||T| per point (einsum sums in another
order); the emulated transposes 1e-5·max|out| of JAX (f32 sums in
another order, as in ``test_torch_member_axis.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu_torch.core import tricubic as ttri

torch.set_num_threads(2)

MEMBERS = pytest.mark.parametrize("n_members", [1, 3, 8, 11])
SHAPES = pytest.mark.parametrize("k,l,xy_first",
                                 [(8, 3, True), (16, 4, False)],
                                 ids=["zp", "cubic"])
LANES = 32
NO_PAIR = np.iinfo(np.int32).max


@MEMBERS
def test_pack_members_round_trip_is_bitwise(n_members):
    rng = np.random.default_rng(300 + n_members)
    x = torch.from_numpy(rng.normal(size=(n_members, 37)).astype(np.float32))
    packed = ttri.pack_members_ref(x)
    groups = -(-n_members // 8)
    assert packed.shape == (groups, 37, 8) and packed.is_contiguous()
    for b in range(n_members):
        assert torch.equal(packed[b // 8, :, b % 8], x[b])
    assert not packed[-1, :, n_members - 8 * (groups - 1):].any()
    assert torch.equal(ttri.unpack_members_ref(packed, n_members), x)


def _gather_inputs(n_members, k, l, seed, n=200, rows=30, nz=9):
    rng = np.random.default_rng(seed)
    tables = rng.normal(size=(n_members, rows, nz)).astype(np.float32)
    ri = rng.integers(0, rows, (n, k)).astype(np.int32)
    zi = (rng.integers(0, nz - l + 1, (n, 1)) + np.arange(l)).astype(np.int32)
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    return tables, ri, wxy, zi, wz


@MEMBERS
@SHAPES
def test_gather_over_the_pack_matches_the_per_member_plain_version(
        n_members, k, l, xy_first):
    """``rows_value_packed_ref`` of the packed tables against
    ``rows_value_ref`` on each member's table and ``jax.vmap`` of the
    reference's ``rows_value``."""
    tables, ri, wxy, zi, wz = _gather_inputs(n_members, k, l, 310 + k)
    args = tuple(map(torch.from_numpy, (ri, wxy, zi, wz)))
    t = torch.from_numpy(tables)
    packed = ttri.pack_members_ref(t.reshape(n_members, -1))
    got = ttri.rows_value_packed_ref(packed, n_members, tables.shape[1:],
                                     *args, xy_first)
    assert got.shape == (n_members, ri.shape[0])
    scale = (np.abs(wxy)[None, :, :, None] * np.abs(wz)[None, :, None, :]
             * np.abs(tables[:, ri[:, :, None], zi[:, None, :]])).sum((2, 3))
    want = np.asarray(jax.vmap(lambda tb: jtri.rows_value(
        tb, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first))(jnp.asarray(tables)))
    for b in range(n_members):
        one = ttri.rows_value_ref(t[b], *args, xy_first).numpy()
        assert np.all(np.abs(got[b].numpy() - one) <= 1e-5 * scale[b])
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * scale)


# --- a numpy emulation of K3 and of K3b --------------------------------------


def _shift(v, d):
    """The value lane i reads by __shfl_up_sync(v, d): lane i - d's, or
    its own below lane d."""
    return np.concatenate([v[:d], v[:-d]])


def _batch(order, j0, end, ct_of, wxy, zi, wz, stride):
    """Lane i's pair of the batch at j0 (none past end): its z taps
    (NO_PAIR without a pair) and contributions (ct·wxy)·wz in f32; ct_of(n)
    gives the point's cotangents, (members,)."""
    ids = order[j0:min(j0 + LANES, end)]
    n, kk = np.divmod(ids.astype(np.int64), stride)
    z = np.full((LANES, zi.shape[1]), NO_PAIR, np.int64)
    z[:ids.size] = zi[n]
    a = np.zeros((LANES, ct_of(0).size), np.float32)
    a[:ids.size] = ct_of(n) * wxy[n, kk][:, None]
    w = np.zeros((LANES, zi.shape[1]), np.float32)
    w[:ids.size] = wz[n]
    return z, a[:, :, None] * w[:, None, :]          # (32, members, L)


def _add_batch(z, c, nz, srow):
    """row_reduce.cuh:add_batch for one member: c (32, L)."""
    lanes = np.arange(LANES)
    if np.all(np.diff(z, axis=0) >= 0):
        for l in range(z.shape[1]):
            v = c[:, l].copy()
            for d in (1, 2, 4, 8, 16):
                same = (lanes >= d) & (_shift(z[:, l], d) == z[:, l])
                v = np.where(same, v + _shift(v, d), v)
            tail = np.append(z[1:, l] != z[:-1, l], True)
            for i in np.flatnonzero(tail & (z[:, l] >= 0) & (z[:, l] < nz)):
                srow[z[i, l]] += v[i]
    else:
        for i in range(LANES):
            for l in range(z.shape[1]):
                if 0 <= z[i, l] < nz:
                    srow[z[i, l]] += c[i, l]


def _add_batch_members(z, c, nz, srows):
    """row_reduce.cuh:add_batch_members: c (32, members, L), the z runs
    found once, the steps past the longest run skipped (step 1 always)."""
    lanes = np.arange(LANES)
    if not np.all(np.diff(z, axis=0) >= 0):
        for i in range(LANES):
            for m in range(c.shape[1]):
                for l in range(z.shape[1]):
                    if 0 <= z[i, l] < nz:
                        srows[m, z[i, l]] += c[i, m, l]
        return
    for l in range(z.shape[1]):
        head = np.append(True, z[1:, l] != z[:-1, l])
        start = np.maximum.accumulate(np.where(head, lanes, 0))
        pos = lanes - start
        tail = np.append(head[1:], True)
        keep = np.flatnonzero(tail & (z[:, l] >= 0) & (z[:, l] < nz))
        steps = [d for d in (1, 2, 4, 8, 16) if d == 1 or d <= pos.max()]
        for m in range(c.shape[1]):
            v = c[:, m, l].copy()
            for d in steps:
                v = np.where(pos >= d, v + _shift(v, d), v)
            for i in keep:
                srows[m, z[i, l]] += v[i]


def _segments(plan):
    """(row, segment index s, the row's segment count, beg, end) of every
    segment of the plan."""
    offsets, row_seg = plan.offsets.numpy(), plan.row_seg.numpy()
    for r in range(plan.n_rows):
        first, nseg = row_seg[r], row_seg[r + 1] - row_seg[r]
        for j in range(nseg):
            beg = offsets[r] + j * plan.chunk
            yield r, first + j, nseg, beg, min(beg + plan.chunk,
                                               offsets[r + 1])


def _fold(parts):
    """fold_partials / fold_member_rows: segment order from 0.0f."""
    acc = np.zeros(parts.shape[1:], np.float32)
    for p in parts:
        acc = acc + p
    return acc


def _emulate_k3(plan, ct, wxy, zi, wz, nz):
    order, stride = plan.order.numpy(), plan.stride
    out = np.zeros((plan.n_rows, nz), np.float32)
    parts = {}
    for r, s, nseg, beg, end in _segments(plan):
        srow = np.zeros(nz, np.float32)
        for j0 in range(beg, end, LANES):
            z, c = _batch(order, j0, end, lambda n: ct[n][..., None], wxy,
                          zi, wz, stride)
            _add_batch(z, c[:, 0], nz, srow)
        parts.setdefault(r, []).append(srow)
    for r, p in parts.items():
        out[r] = p[0] if len(p) == 1 else _fold(np.stack(p))
    return out


def _emulate_k3b(plan, ct, wxy, zi, wz, nz):
    """K3b as rows_value_bwd_batched.cu runs it: the cotangent read from
    its pack, groups of 8 members a pass, rows of one segment written by
    the reduce, the others written by the fold from the partials."""
    order, stride = plan.order.numpy(), plan.stride
    b = ct.shape[0]
    ctp = ttri.pack_members_ref(torch.from_numpy(ct)).numpy()
    out = np.full((b, plan.n_rows, nz), np.nan, np.float32)
    partials = np.full((b, plan.n_seg_max, nz), np.nan, np.float32)
    for r, s, nseg, beg, end in _segments(plan):
        for b0 in range(0, b, 8):
            tb = min(8, b - b0)
            srows = np.zeros((tb, nz), np.float32)
            for j0 in range(beg, end, LANES):
                z, c = _batch(order, j0, end,
                              lambda n: ctp[b0 // 8, n][..., :tb], wxy, zi,
                              wz, stride)
                _add_batch_members(z, c, nz, srows)
            (out[b0:b0 + tb, r] if nseg == 1
             else partials[b0:b0 + tb, s])[:] = srows
    row_seg = plan.row_seg.numpy()
    for r in range(plan.n_rows):                      # the fold launch
        first, nseg = row_seg[r], row_seg[r + 1] - row_seg[r]
        if nseg > 1:
            out[:, r] = _fold(np.moveaxis(partials[:, first:first + nseg],
                                          1, 0))
    return out


def _transpose_case(case, k, l, n_members, seed=320, n=160, n_rows=24,
                    nz=10):
    """Inputs whose plan (chunk 64: two batches a segment) has rows of one
    and of several segments (rows drawn denser towards row 0), and:
    "skewed", half the points on row 0 with z0 from three values (runs of
    up to 32 lanes); "scattered_z", z taps that are not consecutive
    (batches that are not sorted)."""
    rng = np.random.default_rng(seed)
    ri = (rng.random((n, k)) ** 2 * n_rows).astype(np.int32)
    zi = (rng.integers(0, nz - l + 1, (n, 1)) + np.arange(l)).astype(np.int32)
    if case == "skewed":
        ri[: n // 2] = 0
        zi[: n // 2] = rng.integers(0, 3, (n // 2, 1)) + np.arange(l)
    elif case == "scattered_z":
        zi = rng.integers(0, nz, (n, l)).astype(np.int32)
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    ct = rng.normal(size=(n_members, n)).astype(np.float32)
    return ct, ri, wxy, zi, wz, (n_rows, nz)


@pytest.mark.parametrize("case", ["skewed", "scattered_z"])
@pytest.mark.parametrize("n_members", [3, 11])
@SHAPES
def test_k3b_emulation_is_k3_per_member_and_matches_jax(case, n_members, k,
                                                        l, xy_first):
    ct, ri, wxy, zi, wz, shape = _transpose_case(case, k, l, n_members)
    plan = ttri.build_row_plan(torch.from_numpy(ri), shape[0],
                               torch.from_numpy(zi[:, 0]), chunk=64)
    nseg = (plan.row_seg[1:] - plan.row_seg[:-1]).numpy()
    assert nseg.max() > 2 and (nseg == 1).any()
    got = _emulate_k3b(plan, ct, wxy, zi, wz, shape[1])
    for b in range(n_members):
        np.testing.assert_array_equal(
            got[b], _emulate_k3(plan, ct[b], wxy, zi, wz, shape[1]))
    _, vjp = jax.vjp(jax.vmap(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first)),
        jnp.zeros((n_members,) + shape, jnp.float32))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_members", [3, 11])
def test_fold_of_rows_of_several_segments_is_the_emulated_fold(n_members):
    """``fold_member_rows_ref`` (the plain version of K3b's second pass)
    sums each member's partial rows of a row of several segments in
    segment order from 0.0, bitwise the emulation, and leaves the rows of
    one segment alone."""
    _, ri, _, zi, _, (n_rows, nz) = _transpose_case("skewed", 8, 3,
                                                    n_members)
    plan = ttri.build_row_plan(torch.from_numpy(ri), n_rows,
                               torch.from_numpy(zi[:, 0]), chunk=64)
    rng = np.random.default_rng(330)
    partials = rng.normal(size=(n_members, plan.n_seg_max, nz)).astype(
        np.float32)
    before = rng.normal(size=(n_members, n_rows, nz)).astype(np.float32)
    got = ttri.fold_member_rows_ref(torch.from_numpy(partials), plan,
                                    torch.from_numpy(before.copy())).numpy()
    row_seg = plan.row_seg.numpy()
    for r in range(n_rows):
        first, nseg = row_seg[r], row_seg[r + 1] - row_seg[r]
        want = (before[:, r] if nseg == 1 else _fold(np.moveaxis(
            partials[:, first:first + nseg], 1, 0)))
        np.testing.assert_array_equal(got[:, r], want)
