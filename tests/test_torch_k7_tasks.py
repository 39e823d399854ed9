"""K7ᵀ's task list and K7's owned order (``ionotomo_tpu_torch.parallel.
grid_sharding``: ``sharded_plan``'s tasks, ``shard_order``) on the CPU.

The task list is checked for what the kernel relies on (every entry in
exactly one task; a cell of at most 32 entries in one task; a larger cell
cut at its rank multiples of 32), and a numpy walk of the kernel over it
(each warp's shuffle levels 0-4, then the levels above them over a large
cell's subtree sums, 32 a round) is bitwise the plain K7ᵀ
(``sharded_transpose_ref``), value and value + gradient, at the point
sets where its design matters: a pile-up of 100 rays sharing a point at
z = 0, the clamped corner (one cell of ≥ 10⁴ entries), a shard that owns
nothing, and cells of exactly 1, 32, 33, 64 and 65 entries. K7's order
is a stable permutation of the owned points by base cell, and the plain
evaluation through it is ``sharded_value_grad_ref``'s. The JAX
counterparts of these functions are held in
``tests/test_torch_grid_sharding.py``.
"""
import numpy as np
import pytest
import torch

from ionotomo_tpu_torch.core import tricubic
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.parallel import grid_sharding as gs

torch.set_num_threads(2)

LANES = np.arange(32)


def warp_levels(v, rank, size):
    """Levels 0-4 of the pairwise tree over a warp's 32 lanes as the
    kernel's ``__shfl_down_sync`` forms them (a lane past 31 − 2^k reads
    its own value, and never takes it)."""
    v = v.astype(np.float32)
    for k in range(5):
        step = 1 << k
        other = np.concatenate([v[step:], v[32 - step:]])
        take = ((rank & (2 * step - 1)) == 0) & (rank + step < size)
        v = np.where(take, (v + other).astype(np.float32), v)
    return v


def large_cell_sum(sums):
    """The levels above 4 of a large cell's tree over its subtree sums:
    aligned groups of 32 by ``warp_levels``, round after round."""
    sums = np.asarray(sums, np.float32)
    while True:
        groups = []
        for g in range(0, len(sums), 32):
            part = np.zeros(32, np.float32)
            part[:len(sums[g:g + 32])] = sums[g:g + 32]
            groups.append(warp_levels(part, LANES, len(sums) - g)[0])
        if len(sums) <= 32:
            return groups[0]
        sums = np.asarray(groups, np.float32)


def kernel_walk(plan, terms, slab):
    """K7ᵀ over the plan's tasks in numpy: slab (float32) plus the entries'
    contributions ``terms`` (M,) in plan order, as the kernel sums them."""
    out = slab.copy()
    cells, big_sub = plan.cells.numpy(), plan.big_sub.numpy()
    partial = {}
    for beg, end, z, w in plan.tasks.numpy().tolist():
        n = end - beg
        v = np.zeros(32, np.float32)
        v[:n] = terms[beg:end]
        if z >= 0:
            heads = w & 0xFFFFFFFF
            is_head = ((heads >> LANES) & 1).astype(bool) & (LANES < n)
            h = np.maximum.accumulate(np.where(is_head, LANES, 0))
            nxt = np.array([next((m for m in range(i + 1, n) if is_head[m]),
                                 n) for i in range(32)])
            v = warp_levels(v, LANES - h, nxt - h)
            for i in np.flatnonzero(is_head):
                c = cells[z + int(is_head[:i].sum())]
                out[c] = np.float32(out[c] + v[i])
        else:
            partial[(-1 - z, w)] = warp_levels(v, LANES, n)[0]
    for l, c in enumerate(plan.big_cell.numpy()):
        sums = [partial[(l, j)] for j in range(big_sub[l + 1] - big_sub[l])]
        out[c] = np.float32(out[c] + large_cell_sum(sums))
    return out


def check_tasks(plan):
    """Every entry in exactly one task; a cell of ≤ 32 entries never split
    and its first entries marked; a larger cell cut at rank multiples of
    32, each subtree once."""
    starts = plan.starts.numpy().astype(np.int64)
    counts = np.diff(starts)
    seen = np.zeros(plan.order.shape[0], np.int64)
    big_sub = plan.big_sub.numpy()
    big = {int(c): l for l, c in enumerate(plan.big_cell.numpy())}
    subtrees = set()
    cell_of = np.repeat(np.arange(len(counts)), counts)
    for beg, end, z, w in plan.tasks.numpy().tolist():
        assert 0 < end - beg <= gs.WARP_TASK
        seen[beg:end] += 1
        if z >= 0:
            first, last = cell_of[beg], cell_of[end - 1]
            assert starts[first] == beg and starts[last + 1] == end
            assert counts[first:last + 1].max() <= gs.WARP_TASK
            assert z == first
            bits = [int(b) for b in starts[first:last + 1] - beg]
            assert (w & 0xFFFFFFFF) == sum(1 << b for b in bits)
        else:
            l, j = -1 - z, w
            u = cell_of[beg]
            assert counts[u] > gs.WARP_TASK
            assert big[int(plan.cells[u])] == l
            assert beg == starts[u] + 32 * j
            assert end == min(beg + 32, starts[u + 1])
            assert 0 <= j < big_sub[l + 1] - big_sub[l]
            subtrees.add((l, j))
    assert (seen == 1).all()
    assert len(subtrees) == plan.n_sub == big_sub[-1]
    e = plan.order.numpy().astype(np.int64)
    assert np.array_equal(plan.entry.numpy(),
                          plan.own.numpy()[e >> 6] * 64 + (e & 63))
    assert torch.equal(plan.u[:, :3],
                       tricubic._neighborhood(GRID, plan.points)[1])
    assert not plan.u[:, 3].any()
    assert len(big) == int((counts > gs.WARP_TASK).sum())


GRID = Grid3D.from_bounds((-200.0, -200.0, 0.0), (200.0, 200.0, 800.0),
                          (16, 16, 16), device="cpu")


def _cell_centre(ix, iy, iz):
    o, s = GRID.origin.numpy(), GRID.spacing.numpy()
    return o + s * (np.array([ix, iy, iz]) + 0.5)


def point_set(case):
    """(points, x0, loc): the case's points and the shard they are
    planned over."""
    rng = np.random.default_rng(20)
    o, s = GRID.origin.numpy(), GRID.spacing.numpy()
    spread = rng.uniform(o, o + 15 * s, (300, 3))
    if case == "pileup":
        shared = np.repeat([[o[0] + 5.3 * s[0], o[1] + 7.6 * s[1], o[2]]],
                           100, 0)
        return np.concatenate([spread, shared]), 4, 4
    if case == "corner":
        corner = rng.uniform(o - 300.0, o - 50.0, (1500, 3))
        return np.concatenate([spread, corner]), 0, 4
    if case == "empty":
        return rng.uniform(o, o + np.array([3.5, 15, 15]) * s, (200, 3)), 8, 4
    sizes = (1, 32, 33, 64, 65)
    at = ((2, 1), (2, 5), (2, 9), (2, 13), (6, 1))   # stencils apart
    pts = [np.repeat([_cell_centre(ix, iy, 7)], k, 0)
           for (ix, iy), k in zip(at, sizes)]
    return np.concatenate(pts), 0, 16


CASES = ("pileup", "corner", "empty", "sizes")


@pytest.mark.parametrize("case", CASES)
def test_task_list_covers_every_entry_once(case):
    pts, x0, loc = point_set(case)
    plan = gs.sharded_plan(GRID, torch.from_numpy(pts.astype(np.float32)),
                           x0, loc)
    check_tasks(plan)
    counts = np.diff(plan.starts.numpy())
    if case == "pileup":        # z taps −1 and 0 clamp onto one plane
        assert counts.max() >= 200 and plan.n_sub > 0
    elif case == "corner":
        assert counts.max() >= 10_000
    elif case == "empty":
        assert plan.order.shape[0] == 0 and plan.n_tasks == 0
    else:
        assert sorted(set(counts.tolist())) == [1, 32, 33, 64, 65]
        assert (counts == 1).sum() == 64 and (counts == 65).sum() == 64


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_is_the_plain_transpose(case, grad):
    pts, x0, loc = point_set(case)
    pts = torch.from_numpy(pts.astype(np.float32))
    rng = np.random.default_rng(21)
    n = pts.shape[0]
    cv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    cg = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
          if grad else None)
    plan = gs.sharded_plan(GRID, pts, x0, loc)
    base = torch.from_numpy(rng.normal(size=plan.slab_cells)
                            .astype(np.float32))
    want = gs.sharded_transpose_ref(base.clone(), plan, GRID, cv, cg)
    terms = (gs._entry_terms(plan, GRID, cv, cg).numpy()
             if plan.order.shape[0] else np.zeros(0, np.float32))
    got = kernel_walk(plan, terms, base.numpy())
    assert np.array_equal(got, want.numpy())
    assert case != "empty" or torch.equal(want, base)


@pytest.mark.parametrize("x0", [0, 4, 12])
def test_shard_order_is_a_stable_sort_by_base_cell(x0):
    rng = np.random.default_rng(22)
    o, s = GRID.origin.numpy(), GRID.spacing.numpy()
    pts = np.concatenate([rng.uniform(o - 60, o + 15 * s + 60, (800, 3)),
                          np.repeat(rng.uniform(o, o + 15 * s, (5, 3)), 7,
                                    0)])
    pts = torch.from_numpy(pts.astype(np.float32))
    order = gs.shard_order(GRID, pts, x0, 4)
    base = tricubic._neighborhood(GRID, pts)[0][:, :, 1].long().numpy()
    owned = np.flatnonzero((base[:, 0] >= x0) & (base[:, 0] < x0 + 4))
    key = ((base[:, 0] - x0) * 16 + base[:, 1]) * 16 + base[:, 2]
    index = order.index.numpy()
    assert sorted(index.tolist()) == owned.tolist()
    k = key[index]
    assert ((k[1:] > k[:-1]) | ((k[1:] == k[:-1])
                                & (index[1:] > index[:-1]))).all()
    assert torch.equal(order.points, pts[order.index.long()])
    bits = np.unpackbits(order.mask.numpy().view(np.uint8),
                         bitorder="little")[:pts.shape[0]]
    assert np.flatnonzero(bits).tolist() == owned.tolist()
    field = torch.from_numpy(rng.normal(size=(16, 16, 16))
                             .astype(np.float32))
    sf = gs.shard_field(gs.grid_mesh([torch.device("cpu")] * 4), field)
    slab = sf.slab2d(x0 // 4)
    v, g = gs.sharded_value_grad_ordered_ref(slab, GRID, x0, 4, order)
    wv, wg = gs.sharded_value_grad_ref(slab, GRID, x0, 4, pts)
    assert torch.equal(v, wv) and torch.equal(g, wg)
    assert torch.equal(gs._shard_eval(slab, GRID, x0, 4, pts, False, order),
                       wv)


def test_lanes_and_tasks_a_warp_follow_their_rules(monkeypatch):
    """K7's lanes a point for the value and K7ᵀ's tasks a warp
    (``kernels.k7_lanes``, ``kernels.k7t_tasks``): four lanes at up to
    ``K7_QUAD_POINTS_PER_SM`` owned points an SM, one above; two tasks
    from ``K7T_PAIR_TASKS_PER_SM`` tasks an SM, one below; the thresholds
    move the rule (the card tests reach both paths so); on the CPU an
    order and a plan keep one, and the plan its scratch."""
    from ionotomo_tpu_torch import kernels

    sms = 132
    few = kernels.K7_QUAD_POINTS_PER_SM * sms
    assert [kernels.k7_lanes(n, sms) for n in (0, few, few + 1)] == [4, 4, 1]
    many = kernels.K7T_PAIR_TASKS_PER_SM * sms
    assert [kernels.k7t_tasks(n, sms) for n in (many - 1, many)] == [1, 2]
    monkeypatch.setattr(kernels, "K7_QUAD_POINTS_PER_SM", -1)
    monkeypatch.setattr(kernels, "K7T_PAIR_TASKS_PER_SM", 0)
    assert kernels.k7_lanes(0, sms) == 1 and kernels.k7t_tasks(1, sms) == 2
    pts, x0, loc = point_set("corner")
    pts = torch.from_numpy(pts.astype(np.float32))
    plan = gs.sharded_plan(GRID, pts, x0, loc)
    assert plan.tasks_per_warp == 1 and plan.stream is None
    assert tuple(plan.partial.shape) == (max(plan.n_sub, 1),)
    assert gs.shard_order(GRID, pts, x0, loc).lanes == 1
